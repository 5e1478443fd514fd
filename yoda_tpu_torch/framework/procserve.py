"""Multi-process shard serve: scheduling lanes as OS processes over the
durable claim journal.

Thread lanes (``build_sharded_stacks``) run N serve loops in one
interpreter, so aggregate throughput saturates against the interpreter
lock once binds stop being I/O. This module splits the lanes across OS
processes while keeping the crash-consistency story of the durable
claim journal intact:

- The PARENT control-plane process keeps the global lane, the
  journal-owning ChipAccountant (the single CommitLog writer), the
  reconciler/rebalancer/nodehealth loops, and the metrics server.
- Each SHARD WORKER process runs its own informer/queue/BindExecutor
  serve loop over its rendezvous partition (a pure function of
  ``shard_count`` — workers compute routing independently, zero
  coordination) and reaches the commit point through the thin commit
  RPC below: stage-at-Reserve, first-staged-wins ``commit``,
  rollback/release. Every decision is journaled by the parent before it
  applies, so a ``kill -9``'d worker's staged residue is recovered by
  journal replay plus the reconciler's warm path, and a replacement
  worker warm-starts exactly like a promoted standby.

Wire protocol: one request, one response, one persistent connection
per worker (the serve loop's stage/commit calls serialize on it, which
is the ordering the optimistic protocol wants anyway), behind the
commit transport seam — newline-delimited JSON over a local Unix domain
socket (``kind="unix"``), or length-prefixed JSON over TCP
(``kind="tcp"``, the multi-host path: ``commit_listen`` /
``commit_endpoint`` knobs) with connect/read deadlines so a flapping
link degrades to refused commits, never a hung serve loop. The parent
handles each connection on its own daemon thread; handler work is a
dict probe plus one accountant call, so the transport — not the
interpreter lock — is the only serialization point workers share.

Epoch term: every response is stamped with the parent's integer term
(bumped by standby promotion, journal/tail.py). The check is
bidirectional — a worker refuses any parent whose stamped term
REGRESSES below the highest it has seen, and a deposed parent refuses
any state-mutating request carrying a NEWER term than its own (the
classic fencing token: a stale parent's lingering socket can keep
answering, but it can never journal a commit again).

Fencing: a worker binds only while :class:`WorkerFence` says so —
leadership/resync verdict shipped back on every heartbeat AND parent
liveness (heartbeat freshness, term monotonicity, and — local
transport only — a ``getppid`` re-parent check), so orphaned workers
stop binding even when the parent dies without a word. Fail-closed: a
worker that cannot hear the parent is fenced. Remote (TCP) workers
skip the ``getppid`` check: across machines it fences on the WRONG
parent — their fence is heartbeat verdict + term + staleness only.

The yodalint ``journal-discipline`` pass recognizes exactly one
non-accountant module on the commit path: :class:`CommitRPCServer`'s
handlers in this file. Everything else — the client, the worker
entries — must go through the accountant's public surface.

Counterpart of ``yoda_tpu/framework/procserve.py``, whole. The bytes on
the wire are the reference's, byte for byte, so a worker of either
package talks to a parent of the other. The worker entry
(``python -m yoda_tpu_torch.framework.procserve``) takes ``--device``
where the reference takes ``--jax-platform``, and its default is the
card: every worker builds a stack whose fleet evaluation launches the
hand CUDA kernels in a CUDA context of its own, and raises when no card
is present; ``--device cpu`` is how a caller asks for the host.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import socket
import struct
import sys
import threading
import time

from yoda_tpu_torch.cluster.retry import BackoffPolicy


class CommitRPCError(RuntimeError):
    """A commit RPC failed (socket death, parent refusal, a handler
    error, or a term fence). Callers treat it as a refused decision —
    never as state."""


def _encode(msg: dict) -> bytes:
    return json.dumps(msg, separators=(",", ":")).encode() + b"\n"


# --- the commit transport seam ---

# TCP frame header: 4-byte LE payload length. Bounded so a corrupt
# header cannot allocate unbounded memory — the largest legitimate
# frame is a 100k-claim snapshot ship (~10 MB); 64 MiB is headroom.
_TCP_HDR = struct.Struct("<I")
_TCP_MAX_FRAME = 64 * 1024 * 1024


class UnixTransport:
    """The local wire format: newline-delimited JSON over an AF_UNIX
    stream socket."""

    kind = "unix"

    def __init__(self, path: str) -> None:
        self.path = path

    def listen(self) -> socket.socket:
        try:
            os.unlink(self.path)
        except OSError:
            pass
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.bind(self.path)
        s.listen(64)
        return s

    def connect(self, timeout_s: float) -> socket.socket:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout_s)
        s.connect(self.path)
        return s

    def cleanup(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def endpoint(self) -> str:
        return self.path

    def send(self, sock: socket.socket, msg: dict) -> None:
        sock.sendall(_encode(msg))

    def recv(self, rfile) -> "bytes | None":
        """One framed payload from the buffered reader; None on EOF."""
        line = rfile.readline()
        return line if line else None


class TcpTransport:
    """Length-prefixed JSON over TCP — the multi-host commit path.

    ``[4-byte LE length][payload]`` framing (newline framing would
    forbid newlines inside snapshot ships and pay a scan per frame).
    Connect and read deadlines are mandatory: a half-open link must
    surface as a timed-out read (= a refused commit) on the worker,
    never a hung serve loop. ``TCP_NODELAY`` is set on both sides — the
    protocol is strict request/response, so Nagle only adds latency."""

    kind = "tcp"

    def __init__(
        self, host: str, port: int, *, connect_timeout_s: float = 5.0
    ) -> None:
        self.host = host
        self.port = int(port)
        self.connect_timeout_s = connect_timeout_s

    def listen(self) -> socket.socket:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(64)
        # port 0 = kernel-assigned (tests): record what we actually got
        # so ``endpoint()`` hands workers a reachable address.
        self.port = s.getsockname()[1]
        return s

    def connect(self, timeout_s: float) -> socket.socket:
        s = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout_s
        )
        s.settimeout(timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def cleanup(self) -> None:
        pass  # nothing on disk

    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def send(self, sock: socket.socket, msg: dict) -> None:
        payload = json.dumps(msg, separators=(",", ":")).encode()
        sock.sendall(_TCP_HDR.pack(len(payload)) + payload)

    def recv(self, rfile) -> "bytes | None":
        hdr = rfile.read(_TCP_HDR.size)
        if not hdr:
            return None  # clean EOF
        if len(hdr) < _TCP_HDR.size:
            return None  # torn header mid-close
        (length,) = _TCP_HDR.unpack(hdr)
        if length == 0 or length > _TCP_MAX_FRAME:
            raise OSError(f"commit transport: bad frame length {length}")
        payload = rfile.read(length)
        if len(payload) < length:
            return None  # connection died mid-frame
        return payload


def make_transport(endpoint: str):
    """``"host:port"`` (optionally ``tcp://``-prefixed) builds the TCP
    transport; anything else is an AF_UNIX socket path. The one parse
    the server, the client, and cli.py all share — the knobs
    (``commit_listen`` / ``commit_endpoint``) are plain strings."""
    ep = endpoint[6:] if endpoint.startswith("tcp://") else endpoint
    if not ep.startswith("/"):
        host, sep, port = ep.rpartition(":")
        if sep and host and port.isdigit():
            return TcpTransport(host, int(port))
    return UnixTransport(endpoint)


class CommitRPCServer:
    """Parent-side commit RPC endpoint wrapping the journal-owning
    accountant. One daemon accept thread + one daemon handler thread
    per worker connection; every handler is a dict probe plus one
    accountant call (which journals write-ahead under its own lock).

    Also the parent's worker registry: heartbeats carry each worker's
    pid/queue-depth/cycle/bind snapshot, and ``debug()`` serves the
    ``/debug/shards`` process view (pid, lane, last-heartbeat, staged
    count). ``fence_fn`` is the parent's serve fence — leadership AND
    warm-start resync — refusing commits while fenced and echoed to
    workers on every heartbeat, so workers fence on it too.

    ``socket_path`` is really an endpoint string: an AF_UNIX path
    (default, single-host) or ``"host:port"`` for the TCP transport —
    ``make_transport`` decides. ``term`` is the parent's epoch term,
    stamped on every response; ``set_term`` installs a promoted term.

    Connection fence: every accepted connection gets a generation (its
    accept order). A lane's ``residue_sync`` reconciles the parent's
    claims against the worker's log as of that connection, so once a
    lane has synced on generation g, a mutating op of that lane arriving
    on an older connection is refused (``stale_conn_refusals``): it can
    only be a request the worker abandoned at its deadline and the
    network delivered late, and applying it would stage a claim no
    worker holds and nothing releases. A worker talks on one connection
    at a time, so its live connection is never older than its last sync.
    The check and the op run under the lane's own lock, which its sync
    holds too (other lanes are not held up); a commit first waits out the
    resize barrier outside that lock. No field is added to the wire.
    """

    def __init__(
        self,
        accountant,
        socket_path: str,
        *,
        metrics=None,
        fence_fn=None,
        expected_workers: int = 0,
        clock=time.monotonic,
        term: int = 1,
    ) -> None:
        self.accountant = accountant
        self.socket_path = socket_path
        self.transport = make_transport(socket_path)
        self.term = int(term)
        self.metrics = metrics
        self.fence_fn = fence_fn
        self.expected_workers = int(expected_workers)
        self.clock = clock
        self.workers: dict[str, dict] = {}   # lane -> registry row
        self.reports: dict[str, dict] = {}   # lane -> shipped result
        self._lock = threading.Lock()
        self._listener: "socket.socket | None" = None
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._conn_gen = 0                   # generations handed out
        self._synced_gen: dict[str, int] = {}  # lane -> its sync's conn
        self._lane_locks: dict[str, threading.Lock] = {}  # the fence's, per lane
        self.stale_conn_refusals = 0
        self._stopping = False
        # Start-line barrier (bench/test synchronization): workers park
        # here until every expected worker arrives, so process startup
        # skew never pollutes a timed drain.
        self._barrier_cond = threading.Condition()
        self._barrier_counts: dict[str, int] = {}

    # --- lifecycle ---

    def start(self) -> None:
        self._listener = self.transport.listen()
        if self.metrics is not None:
            self.metrics.commit_term.set(float(self.term))
        t = threading.Thread(
            target=self._accept_loop, name="commit-rpc-accept", daemon=True
        )
        self._threads.append(t)
        t.start()

    @property
    def endpoint(self) -> str:
        """The reachable endpoint string (TCP reports the kernel-assigned
        port after a ``:0`` bind) — what the parent hands its workers."""
        return self.transport.endpoint()

    def set_term(self, term: int) -> None:
        """Install a new epoch term (the promotion path): every response
        from here on is stamped with it, and any request still carrying
        an older worker-side term is simply behind — only requests
        carrying a NEWER term than ours mark US as the stale parent."""
        self.term = int(term)
        if self.metrics is not None:
            self.metrics.commit_term.set(float(self.term))

    def stop(self) -> None:
        self._stopping = True
        with self._barrier_cond:
            self._barrier_cond.notify_all()
        if self._listener is not None:
            # shutdown BEFORE close: a thread blocked in accept() holds
            # the kernel file description open past close(), leaving the
            # port in LISTEN forever — the promoted standby could then
            # never bind the same address. shutdown wakes the accept.
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        self.transport.cleanup()

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed: shutdown
            with self._lock:
                self._conns.append(conn)
                self._conn_gen += 1
                gen = self._conn_gen
            t = threading.Thread(
                target=self._serve_conn,
                args=(conn, gen),
                name="commit-rpc-conn",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket, gen: int = 0) -> None:
        rfile = conn.makefile("rb")
        transport = self.transport
        try:
            while True:
                try:
                    raw = transport.recv(rfile)
                except OSError:
                    return  # torn frame / dead socket: drop the conn
                if raw is None or self._stopping:
                    return
                t0 = time.perf_counter()
                try:
                    req = json.loads(raw)
                    resp = self._dispatch(req, gen)
                except Exception as e:  # noqa: BLE001 — a bad request must not kill the conn
                    req = {}
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                resp.setdefault("term", self.term)
                op = str(req.get("op", "?"))
                lane = str(req.get("shard", ""))
                if self.metrics is not None:
                    self.metrics.commit_rpc_calls.inc(
                        op=op, shard=lane, transport=transport.kind
                    )
                    self.metrics.commit_rpc_latency.observe(
                        (time.perf_counter() - t0) * 1e3,
                        op=op, transport=transport.kind,
                    )
                try:
                    transport.send(conn, resp)
                except OSError:
                    return  # worker died mid-reply: its residue is journaled
        finally:
            try:
                rfile.close()
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    # --- dispatch ---

    # Ops that mutate claim state: all of them carry the term fence —
    # a request stamped with a NEWER term than ours proves a promoted
    # parent exists somewhere, so WE are the stale side of a partition
    # and must refuse before touching the accountant or the journal.
    _MUTATING_OPS = frozenset(
        {"stage", "commit", "release", "residue", "residue_sync"}
    )

    def _dispatch(self, req: dict, gen: int = 0) -> dict:
        """Serve one request that arrived on connection generation
        ``gen`` (0: not from a connection, never fenced)."""
        op = req.get("op")
        if op not in self._MUTATING_OPS:
            return self._serve_op(op, req)
        lane = str(req.get("shard", ""))
        worker_term = int(req.get("term", 0) or 0)
        if worker_term > self.term:
            return self._refusal(
                op,
                f"stale parent: term {self.term} deposed by term {worker_term}",
            )
        if op == "commit":
            self.accountant.await_commit_gate()  # never under the lane's lock
        with self._lock:
            lane_lock = self._lane_locks.setdefault(lane, threading.Lock())
        with lane_lock:
            synced = self._synced_gen.get(lane, 0)
            if gen and gen < synced:
                with self._lock:
                    self.stale_conn_refusals += 1
                return self._refusal(
                    op,
                    f"stale connection: lane {lane!r} resynced on a newer "
                    "connection",
                )
            return self._serve_mutating(op, req, gen)

    @staticmethod
    def _refusal(op, why: str) -> dict:
        if op == "commit":
            # Shaped like a fence refusal, not an error: the worker rolls
            # back + requeues, same as any refused commit. Nothing is
            # journaled here.
            return {"ok": True, "committed": False, "why": why}
        return {"ok": False, "error": why}

    def _serve_mutating(self, op, req: dict, gen: int) -> dict:
        """One of ``_MUTATING_OPS``, under its lane's fence lock: nothing
        here may block (the commit waited out the resize barrier before
        the lock was taken)."""
        lane = str(req.get("shard", ""))
        if op == "stage":
            seq = self.accountant.stage(
                req["uid"],
                req["node"],
                int(req["chips"]),
                lane or req.get("lane", ""),
                req.get("gang", ""),
            )
            return {"ok": True, "seq": seq}
        if op == "commit":
            # The parent's own leader fence gates the commit point: a
            # fenced ex-leader's accountant must not validate placements
            # the new leader no longer backs (the worker additionally
            # fences itself on the heartbeat verdict, but that check is
            # advisory-latency — THIS one is authoritative).
            if self.fence_fn is not None and not bool(self.fence_fn()):
                return {
                    "ok": True,
                    "committed": False,
                    "why": "parent fenced (not leading or not resynced)",
                }
            committed, why = self.accountant.commit_staged_now(
                list(req.get("uids", ()))
            )
            if not committed and self.metrics is not None:
                self.metrics.commit_rpc_conflicts.inc(shard=lane)
            return {"ok": True, "committed": committed, "why": why}
        if op == "release":
            # The parent decides rollback-vs-release from its OWN
            # (authoritative, journal-backed) claim state.
            self.accountant.release(req["uid"])
            return {"ok": True}
        if op == "residue":
            return {
                "ok": True,
                "found": self.accountant.commit_residue(req["uid"]),
            }
        if gen:
            self._synced_gen[lane] = max(self._synced_gen.get(lane, 0), gen)
        return self._op_residue_sync(lane, req)

    def _serve_op(self, op, req: dict) -> dict:
        lane = str(req.get("shard", ""))
        if op == "hello":
            self._note_worker(lane, req, hello=True)
            return {"ok": True}
        if op == "heartbeat":
            self._note_worker(lane, req)
            serve = True if self.fence_fn is None else bool(self.fence_fn())
            return {"ok": True, "serve": serve}
        if op == "report":
            with self._lock:
                self.reports[lane] = dict(req.get("result") or {})
            return {"ok": True}
        if op == "barrier":
            return self._op_barrier(req)
        if op == "tail":
            return self._op_tail(req)
        if op == "debug":
            return {"ok": True, "workers": self.debug()["workers"]}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _op_tail(self, req: dict) -> dict:
        """Journal shipping (the hot standby's feed, journal/tail.py):
        frames appended after ``since`` served straight from the
        journal's in-memory ship ring, or a full mirror snapshot when
        the ring no longer reaches back (a fresh follower, or one that
        fell too far behind)."""
        journal = getattr(self.accountant, "journal", None)
        if journal is None or not hasattr(journal, "frames_since"):
            return {
                "ok": False,
                "error": "journal shipping needs a journal-backed parent",
            }
        got = journal.frames_since(int(req.get("since", 0)))
        if got is None:
            snap = journal.ship_state()
            return {"ok": True, "snapshot": snap, "tail_seq": snap["tail_seq"]}
        frames, tail_seq = got
        return {"ok": True, "frames": frames, "tail_seq": tail_seq}

    def _op_residue_sync(self, lane: str, req: dict) -> dict:
        """Reconcile a reconnecting worker's staged-intent log against
        this (possibly just-promoted) parent's claim state — partition
        residue repaired NOW instead of waiting for the reconciler's
        warm path. Set semantics over the shipped uids:

        - a parent-side STAGED claim for this lane absent from the
          shipped set was abandoned by the worker: released here;
        - a shipped uid the parent holds STAGED stays staged;
        - a shipped uid the parent holds COMMITTED tells the worker to
          finalize its mirror (verdict ``committed``);
        - a shipped uid the parent never heard of (staged under the old
          term, lost in the partition) is adopted through the normal
          validated stage path — fresh seq, so first-staged-wins
          ordering stays sound.
        """
        shipped = {str(row["uid"]): row for row in req.get("staged", ())}
        staged_now = self.accountant.staged_uids()
        for uid, owner in staged_now.items():
            if owner == lane and uid not in shipped:
                self.accountant.release(uid)
        verdicts: dict[str, str] = {}
        for uid, row in shipped.items():
            if uid in staged_now:
                verdicts[uid] = "staged"
            elif self.accountant.has_claim(uid):
                verdicts[uid] = "committed"
            else:
                self.accountant.stage(
                    uid, str(row["node"]), int(row["chips"]), lane,
                    str(row.get("gang", "")),
                )
                verdicts[uid] = "staged"
        return {"ok": True, "verdicts": verdicts}

    def _note_worker(self, lane: str, req: dict, *, hello: bool = False) -> None:
        now = self.clock()
        with self._lock:
            row = self.workers.setdefault(lane, {"lane": lane})
            row["pid"] = int(req.get("pid", row.get("pid", 0)))
            row["last_heartbeat"] = now
            if hello:
                row["connected_at"] = now
            for k in ("queue_depth", "cycles", "binds", "staged"):
                if k in req:
                    row[k] = int(req[k])

    def _op_barrier(self, req: dict) -> dict:
        name = str(req.get("name", "default"))
        deadline = time.monotonic() + float(req.get("timeout_s", 120.0))
        need = max(int(req.get("expected", self.expected_workers)), 1)
        with self._barrier_cond:
            self._barrier_counts[name] = (
                self._barrier_counts.get(name, 0) + 1
            )
            self._barrier_cond.notify_all()
            while self._barrier_counts[name] < need and not self._stopping:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {
                        "ok": False,
                        "error": (
                            f"barrier {name!r}: "
                            f"{self._barrier_counts[name]}/{need} arrived"
                        ),
                    }
                self._barrier_cond.wait(remaining)
        return {"ok": True}

    # --- introspection (GET /debug/shards) ---

    def debug(self) -> dict:
        """The process view: one row per worker lane — pid, lane,
        seconds since the last heartbeat, the worker's last serve-loop
        snapshot, and the parent accountant's live staged count for the
        lane (counted HERE, not trusted from the heartbeat: the staged
        residue of a dead worker must stay visible)."""
        staged_by_lane: dict[str, int] = {}
        for _uid, lane in self.accountant.staged_uids().items():
            staged_by_lane[lane] = staged_by_lane.get(lane, 0) + 1
        now = self.clock()
        with self._lock:
            rows = []
            for lane, row in sorted(self.workers.items()):
                hb = row.get("last_heartbeat")
                rows.append(
                    {
                        "lane": lane,
                        "pid": row.get("pid", 0),
                        "heartbeat_age_s": (
                            round(now - hb, 3) if hb is not None else None
                        ),
                        "queue_depth": row.get("queue_depth", 0),
                        "cycles": row.get("cycles", 0),
                        "binds": row.get("binds", 0),
                        "staged": staged_by_lane.get(lane, 0),
                    }
                )
        return {"enabled": True, "mode": "process", "workers": rows}


class CommitRPCClient:
    """Worker-side commit RPC client: one persistent connection, one
    request in flight (the serve loop's decisions serialize on the
    lane anyway). Reconnects lazily after a socket death — the parent
    respawning is indistinguishable from a blip — through full-jitter
    backoff (cluster/retry.py policy) so a dead parent is never
    hammered by a tight reconnect loop; the ``stop_event`` interrupts a
    pending backoff at once (SIGTERM must not wait it out). Raises
    :class:`CommitRPCError` when the parent cannot be reached, which
    every caller treats as a refused decision.

    Term tracking: every request carries the highest parent term this
    client has seen; every response's stamped term must be monotonic.
    A response whose term REGRESSES (a deposed parent's lingering
    socket still answering) raises — the call reads as refused and the
    connection drops, so the next call re-resolves the endpoint."""

    def __init__(
        self,
        socket_path: str,
        *,
        shard: str = "",
        timeout_s: float = 10.0,
        stop_event: "threading.Event | None" = None,
        reconnect_policy: "BackoffPolicy | None" = None,
        rng: "random.Random | None" = None,
    ) -> None:
        self.socket_path = socket_path
        self.transport = make_transport(socket_path)
        self.shard = shard
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._sock: "socket.socket | None" = None
        self._rfile = None
        self._stop = stop_event
        self._policy = reconnect_policy or BackoffPolicy(
            attempts=0, base_s=0.05, cap_s=2.0
        )
        self._rng = rng or random.Random()
        self._failures = 0      # consecutive transport failures
        self._term_seen = 0     # highest parent term observed

    @property
    def term_seen(self) -> int:
        return self._term_seen

    def _connect_locked(self) -> None:
        if self._failures:
            # Full-jitter reconnect backoff: attempt k (k = consecutive
            # failures - 1) sleeps uniform(0, min(base * 2**k, cap)).
            # The stop event firing mid-sleep aborts immediately as a
            # refused call — shutdown never waits a backoff out.
            delay = self._policy.delay_s(
                min(self._failures - 1, 16), self._rng
            )
            if self._stop is not None:
                if self._stop.wait(delay):
                    raise CommitRPCError(
                        "commit rpc: stopping during reconnect backoff"
                    )
            elif delay > 0:
                time.sleep(delay)
        s = self.transport.connect(self.timeout_s)
        self._sock = s
        self._rfile = s.makefile("rb")

    def _drop_locked(self) -> None:
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass
            self._rfile = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def call(self, op: str, **fields) -> dict:
        req = {"op": op, "shard": self.shard}
        req.update(fields)
        with self._lock:
            req.setdefault("term", self._term_seen)
            try:
                if self._sock is None:
                    # yodalint: ok lock-discipline the reconnect backoff sleeps under the client lock ON PURPOSE: the lock serializes exactly one reconnect attempt per client, the wait is stop-interruptible and capped (2 s), and every other would-be caller is headed for the same dead endpoint anyway
                    self._connect_locked()
                self.transport.send(self._sock, req)
                raw = self.transport.recv(self._rfile)
            except OSError as e:
                self._drop_locked()
                self._failures += 1
                raise CommitRPCError(f"commit rpc {op}: {e}") from e
            if raw is None:
                self._drop_locked()
                self._failures += 1
                raise CommitRPCError(
                    f"commit rpc {op}: connection closed by parent"
                )
            self._failures = 0
            try:
                resp = json.loads(raw)
            except ValueError as e:
                raise CommitRPCError(f"commit rpc {op}: bad reply") from e
            term = resp.get("term")
            if term is not None:
                term = int(term)
                if term < self._term_seen:
                    # Not a transport failure (no backoff bump): the
                    # endpoint answered — it is just no longer the
                    # parent. Drop the conn so the next call re-resolves.
                    self._drop_locked()
                    raise CommitRPCError(
                        f"commit rpc {op}: stale parent term {term} < "
                        f"{self._term_seen} (fenced)"
                    )
                self._term_seen = term
        if not resp.get("ok"):
            raise CommitRPCError(
                f"commit rpc {op}: {resp.get('error', 'refused')}"
            )
        return resp

    def close(self) -> None:
        with self._lock:
            self._drop_locked()

    # --- the RemoteAccountant collaborator surface ---

    def stage(self, uid, node, chips, shard, gang="") -> int:
        return int(
            self.call(
                "stage", uid=uid, node=node, chips=int(chips),
                shard=shard, gang=gang,
            )["seq"]
        )

    def commit(self, uids) -> "tuple[bool, str]":
        resp = self.call("commit", uids=list(uids))
        return bool(resp["committed"]), str(resp.get("why", ""))

    def release(self, uid) -> None:
        self.call("release", uid=uid)

    def residue(self, uid) -> bool:
        return bool(self.call("residue", uid=uid)["found"])

    def residue_sync(self, staged) -> "dict[str, str]":
        """Ship the worker's staged-intent log to a (newly promoted)
        parent; returns per-uid verdicts (``staged`` / ``committed``)."""
        resp = self.call("residue_sync", staged=list(staged))
        return dict(resp.get("verdicts") or {})

    def tail(self, since: int) -> dict:
        """One journal-shipping poll (the standby tailer's feed)."""
        return self.call("tail", since=int(since))

    # --- worker lifecycle surface ---

    def hello(self, pid: "int | None" = None) -> None:
        self.call("hello", pid=pid if pid is not None else os.getpid())

    def heartbeat(self, info: "dict | None" = None) -> bool:
        return bool(
            self.call("heartbeat", pid=os.getpid(), **(info or {}))["serve"]
        )

    def barrier(self, name: str = "default", *, timeout_s: float = 120.0,
                expected: "int | None" = None) -> None:
        fields = {"name": name, "timeout_s": timeout_s}
        if expected is not None:
            fields["expected"] = expected
        self.call("barrier", **fields)

    def report(self, result: dict) -> None:
        self.call("report", result=result)


class WorkerFence:
    """Per-worker serve fence: leadership AND parent liveness.

    ``serving()`` — wired as the worker scheduler's ``fence_fn`` — is
    True only while ALL hold:

    - the parent's last heartbeat verdict said serve (leadership held
      and the global warm-start resync complete),
    - that verdict is FRESH (within ``liveness_s`` — a worker that
      cannot hear the parent is fenced, fail-closed), and
    - LOCAL transport only: the parent process is still our parent
      (``getppid`` unchanged; a dead parent re-parents us, and an
      orphaned worker must stop binding even though its socket may
      linger). A REMOTE (TCP) worker was never forked by the parent —
      across machines the check fences on the WRONG parent, so it is
      skipped: term monotonicity (the client refuses a regressing
      term, which then reads as staleness here) plus heartbeat
      freshness are the remote fence, still fail-closed.

    The heartbeat loop runs on its own daemon thread and ships the
    worker's serve-loop snapshot (``info_fn``) for ``/debug/shards``.
    ``on_orphaned`` (optional) fires once when the parent is detected
    gone — production workers use it to exit instead of idling fenced.
    ``on_new_term`` (optional) fires when a heartbeat lands under a
    HIGHER parent term than before (standby promotion happened while
    we were partitioned) — production workers use it to ship their
    staged-intent log (``residue_sync``); a failed sync re-arms so the
    next beat retries.
    """

    def __init__(
        self,
        client: CommitRPCClient,
        *,
        shard: str,
        liveness_s: float = 3.0,
        period_s: float = 0.5,
        info_fn=None,
        on_orphaned=None,
        on_new_term=None,
        remote: "bool | None" = None,
        clock=time.monotonic,
    ) -> None:
        self.client = client
        self.shard = shard
        self.liveness_s = liveness_s
        self.period_s = period_s
        self.info_fn = info_fn
        self.on_orphaned = on_orphaned
        self.on_new_term = on_new_term
        if remote is None:
            remote = (
                getattr(getattr(client, "transport", None), "kind", "unix")
                == "tcp"
            )
        self.remote = bool(remote)
        self.clock = clock
        self._ppid = os.getppid()
        self._term = 0
        self._last_ok: "float | None" = None
        self._serve = False
        self._orphaned = False
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=f"worker-fence-{self.shard}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.beat()
            self._stop.wait(self.period_s)

    def beat(self) -> None:
        """One heartbeat round-trip (the loop's body; tests drive it
        directly)."""
        if not self.remote and os.getppid() != self._ppid:
            self._orphaned = True
            self._serve = False
            if self.on_orphaned is not None:
                cb, self.on_orphaned = self.on_orphaned, None
                cb()
            return
        info = {}
        if self.info_fn is not None:
            try:
                info = self.info_fn()
            except Exception:  # noqa: BLE001 — a sick snapshot must not stop heartbeats
                info = {}
        try:
            self._serve = self.client.heartbeat(info)
            self._last_ok = self.clock()
        except CommitRPCError:
            # Leave _last_ok as-is: staleness fences after liveness_s.
            return
        term = getattr(self.client, "term_seen", 0)
        if term > self._term:
            prev, self._term = self._term, term
            # prev == 0 is the FIRST successful beat, not a promotion.
            if prev != 0 and self.on_new_term is not None:
                try:
                    self.on_new_term(term)
                except CommitRPCError:
                    self._term = prev  # re-arm: next beat retries the sync

    def serving(self) -> bool:
        if self._orphaned:
            return False
        if not self.remote and os.getppid() != self._ppid:
            return False
        if not self._serve or self._last_ok is None:
            return False
        return (self.clock() - self._last_ok) <= self.liveness_s


# --- worker process entries ---


def _worker_info_fn(stack):
    def info() -> dict:
        return {
            "queue_depth": len(stack.queue),
            "cycles": len(stack.scheduler.stats.results),
            "binds": stack.scheduler.stats.binds,
            "staged": stack.accountant.staged_count(),
        }

    return info


def _build_worker_stack(cluster, config, client, lane, *, stop_event=None):
    """One shard stack around a RemoteAccountant — the worker-process
    analog of one build_sharded_stacks lane. The accountant's watcher
    registers BEFORE build_stack's informer (the build_sharded_stacks
    discipline: reservation releases precede the informer's view of the
    same event)."""
    from yoda_tpu_torch.plugins.yoda.accounting import RemoteAccountant
    from yoda_tpu_torch.standalone import build_stack

    accountant = RemoteAccountant(
        client, scheduler_name=config.scheduler_name
    )
    cluster.add_watcher(accountant.handle)
    stack = build_stack(
        cluster=cluster,
        config=config,
        accountant=accountant,
        stop_event=stop_event,
        shard=lane,
    )
    return stack


def _run_spec_worker(spec: dict, device: str = "cuda") -> int:
    """Bench/test worker: build a private FakeCluster fleet from the
    spec (the parent pre-partitioned hosts and pre-routed pods — the
    rendezvous map is a pure function, so the split is exactly what the
    in-process router would compute), drain a warmup round, park at the
    start barrier until every worker is built, then drain the timed
    round and ship the measurements back over the RPC. ``device`` is
    where the worker's stack evaluates: "cuda" (the card; its build
    raises without one) or "cpu"."""
    from yoda_tpu_torch.agent import FakeTpuAgent
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.cluster.fake import FakeCluster
    from yoda_tpu_torch.cli import _config_on_device
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.framework.shards import shard_name

    lane = shard_name(int(spec.get("shard_index", 0)))
    client = CommitRPCClient(spec["socket"], shard=lane)
    client.hello()
    config = _config_on_device(
        SchedulerConfig.from_dict(dict(spec.get("config") or {})), device
    )
    cluster = FakeCluster(
        bind_latency_s=float(spec.get("bind_latency_s", 0.0))
    )
    stack = _build_worker_stack(cluster, config, client, lane)
    agent = FakeTpuAgent(cluster)
    for h in spec.get("hosts", ()):
        agent.add_host(
            h["name"],
            generation=h.get("generation", "v5e"),
            chips=int(h.get("chips", 8)),
        )
    agent.publish_all()

    def make_pods(rows):
        return [
            PodSpec(p["name"], labels=dict(p.get("labels") or {}))
            for p in rows
        ]

    def drain(pods, timeout_s=240.0) -> float:
        for pod in pods:
            cluster.create_pod(pod)
        t0 = time.monotonic()
        stack.scheduler.run_until_idle(max_wall_s=timeout_s)
        dt = time.monotonic() - t0
        bound = [p for p in cluster.list_pods() if p.node_name]
        if len(bound) != len(pods):
            raise RuntimeError(
                f"{lane}: {len(bound)}/{len(pods)} bound"
            )
        for p in bound:
            cluster.delete_pod(p.key)
        stack.scheduler.run_until_idle(max_wall_s=30.0)
        return dt

    heartbeat_info = _worker_info_fn(stack)
    warmup = make_pods(spec.get("warmup_pods", ()))
    if warmup:
        drain(warmup)
    timed = make_pods(spec.get("pods", ()))
    client.barrier(
        "timed",
        expected=spec.get("workers"),
        timeout_s=float(spec.get("barrier_timeout_s", 300.0)),
    )
    wall_s = drain(timed)
    slo = stack.metrics.slo.evaluate(time.monotonic())
    client.report(
        {
            "lane": lane,
            "pid": os.getpid(),
            "pods": len(timed),
            "wall_s": round(wall_s, 4),
            "pods_per_s": round(len(timed) / wall_s, 2) if wall_s else 0.0,
            "admission_p99_s": slo["fleet"]["admission_wait_p99_s"],
            "commit_conflicts": stack.accountant.commit_conflicts,
            "staged_residue": stack.accountant.staged_count(),
            **heartbeat_info(),
        }
    )
    stack.gang.close()
    client.close()
    return 0


def _run_drive_worker(spec: dict) -> int:
    """Scripted chaos driver: stage the spec'd claims over the RPC,
    announce STAGED on stdout, then execute stdin commands (COMMIT /
    RELEASE / EXIT) until told to stop. The chaos sweep SIGKILLs this
    process at deterministic points — at the STAGED barrier, or
    mid-commit while the parent holds the commit gate closed — to plant
    staged residue whose recovery the test then proves."""
    lane = spec["shard"]
    client = CommitRPCClient(spec["socket"], shard=lane)
    client.hello()
    for c in spec.get("claims", ()):
        client.stage(
            c["uid"], c["node"], int(c["chips"]), lane, c.get("gang", "")
        )
    print("STAGED", flush=True)
    for line in sys.stdin:
        cmd = line.strip().split(" ", 1)
        if not cmd[0]:
            continue
        if cmd[0] == "COMMIT":
            uids = (
                cmd[1].split(",")
                if len(cmd) > 1
                else [c["uid"] for c in spec.get("claims", ())]
            )
            try:
                ok, why = client.commit(uids)
            except CommitRPCError as e:
                ok, why = False, str(e)
            print(f"COMMITTED {int(ok)} {why}", flush=True)
        elif cmd[0] == "RELEASE" and len(cmd) > 1:
            client.release(cmd[1])
            print("RELEASED", flush=True)
        elif cmd[0] == "EXIT":
            break
    client.close()
    return 0


def _run_kube_worker(args) -> int:
    """Production worker (spawned by cli.py under shard_mode=process):
    one shard lane against the real API server, fenced on leadership
    AND parent liveness. Exits when the parent dies (orphan fencing) or
    on SIGTERM; staged residue either way is the parent's to recover
    via journal replay + reconciliation."""
    from yoda_tpu_torch.cli import (
        _build_kube_cluster,
        _config_on_device,
        _init_device,
        _install_stop_handlers,
        _load_config,
    )
    from yoda_tpu_torch.framework.shards import ShardMap, ShardRouter, shard_name

    config = _config_on_device(_load_config(args.config), args.device)
    # The kernels are built (or, built by the parent, loaded) before the
    # informer sync, so nvcc never runs inside a fenced-in serve cycle.
    _init_device(config.kernel_platform)
    idx = int(args.shard_index)
    lane = shard_name(idx)
    stop = threading.Event()
    _install_stop_handlers(stop)
    client = CommitRPCClient(args.socket, shard=lane, stop_event=stop)
    client.hello()
    cluster = _build_kube_cluster()
    # The rendezvous map is a pure function of shard_count: this worker
    # computes its partition + routing locally, no coordination.
    shard_map = ShardMap(int(args.shard_count))
    router = ShardRouter(shard_map)
    cluster.add_watcher(router.observe, batch_fn=router.observe_batch)
    from yoda_tpu_torch.plugins.yoda.accounting import RemoteAccountant
    from yoda_tpu_torch.standalone import build_stack

    accountant = RemoteAccountant(
        client, scheduler_name=config.scheduler_name
    )
    cluster.add_watcher(accountant.handle)
    stack = build_stack(
        cluster=cluster,
        config=config,
        accountant=accountant,
        stop_event=stop,
        shard=lane,
        node_filter_fn=shard_map.node_filter(idx),
        pod_route_fn=lambda pod: router.route(pod) == lane,
    )
    def _sync_residue(term: int) -> None:
        # Reconnected under a NEW parent term (a standby promoted while
        # this worker was partitioned): ship the local staged-intent
        # log so the promoted parent reconciles our residue immediately
        # instead of waiting for the reconciler's warm path. A raised
        # CommitRPCError re-arms the fence to retry on the next beat.
        accountant.apply_residue_verdicts(
            client.residue_sync(accountant.staged_intents())
        )

    fence = WorkerFence(
        client,
        shard=lane,
        info_fn=_worker_info_fn(stack),
        on_orphaned=stop.set,
        on_new_term=_sync_residue,
    )
    stack.scheduler.fence_fn = fence.serving
    fence.start()
    device = stack.batch.device if stack.batch is not None else "host"
    print(
        f"yoda-tpu-scheduler: shard worker {lane} serving "
        f"(pid={os.getpid()}, device={device})",
        file=sys.stderr,
    )
    try:
        stack.scheduler.serve_forever(stop)
    finally:
        fence.stop()
        stack.gang.close()
        if stack.ingestor is not None:
            stack.ingestor.stop()
        client.close()
        cluster.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m yoda_tpu_torch.framework.procserve",
        description="yoda-tpu shard worker process (shard_mode=process), PyTorch/CUDA port",
    )
    ap.add_argument(
        "--serve-spec",
        help="bench/test worker: JSON spec file (private FakeCluster "
        "fleet, timed drain, result shipped over the commit RPC)",
    )
    ap.add_argument(
        "--drive",
        help="scripted chaos driver: JSON spec file (stage claims, then "
        "execute stdin COMMIT/RELEASE/EXIT commands)",
    )
    ap.add_argument("--config", help="scheduler config YAML (kube worker)")
    ap.add_argument(
        "--socket",
        help="parent commit RPC endpoint: AF_UNIX socket path, or "
        "host:port for the TCP transport (commit_listen)",
    )
    ap.add_argument("--shard-index", type=int, default=0)
    ap.add_argument("--shard-count", type=int, default=1)
    ap.add_argument(
        "--device",
        choices=("cpu", "cuda"),
        default="cuda",
        help="where the worker's fleet evaluation runs: 'cuda' (the card, "
        "the default; raises without one) or 'cpu' (the host)",
    )
    args = ap.parse_args(argv)
    if args.device == "cpu":
        # Several workers share the host: bound each one's intra-op pool
        # before its first evaluation (the card's work is not affected).
        from yoda_tpu_torch.ops.kernel import bound_host_pool

        bound_host_pool(lanes=max(args.shard_count, 1))
    if args.serve_spec:
        with open(args.serve_spec) as f:
            return _run_spec_worker(json.load(f), args.device)
    if args.drive:
        with open(args.drive) as f:
            return _run_drive_worker(json.load(f))
    if not args.socket:
        ap.error("--socket is required for a kube shard worker")
    return _run_kube_worker(args)


if __name__ == "__main__":
    raise SystemExit(main())
