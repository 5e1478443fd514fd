"""HTTP endpoint for metrics, health, traces, and why-pending.

The reference exposed /metrics and pprof only via the wrapped upstream
command (reference pkg/register/register.go:10; SURVEY.md §5). Here the
endpoint is first-party and dependency-free (stdlib http.server):

    GET /metrics  -> Prometheus text exposition of the registry
    GET /healthz  -> 200 "ok" (liveness; the Deployment probes this,
                     deploy/yoda-tpu-scheduler.yaml)
    GET /readyz   -> readiness, DISTINCT from liveness: 200 only once the
                     wired ``ready_fn`` reports true — leadership held,
                     informer caches synced, and the warm-start resync
                     complete — else 503, so the Deployment never routes
                     to a still-rebuilding standby (a standby is alive
                     and must not be restarted, hence the split)
    GET /trace    -> last N scheduling traces, one line each;
                     ``?n=`` sizes the window (default 100),
                     ``?format=json`` returns the structured TraceEntry
                     dump instead of one-liners
    GET /debug/traces -> the lifecycle span trace (yoda_tpu_torch/tracing.py).
                     Filters: ``?gang=NAME`` / ``?pod=ns/name`` /
                     ``?subject=`` / ``?trace=ID``; ``?n=`` bounds the
                     record count. ``?format=perfetto`` emits Chrome
                     trace-event JSON loadable at ui.perfetto.dev (one
                     track per loop/thread); the default is a structured
                     JSON record list.
    GET /debug/pending/<key> -> the why-pending summary for a pod key
                     ("default/name") or gang name: aggregated rejection
                     kinds, attempt counts, and top per-node reasons.
                     404 (JSON body) when nothing is pending under that
                     key. Also the backend of `yoda-tpu-scheduler
                     explain <key>`.
    GET /debug/pending -> no key: every currently-pending pod/gang key
                     with verdict-class counts (`explain --list`).
    GET /debug/slo -> the fleet SLO engine's evaluation (yoda_tpu_torch/slo):
                     per-tenant and fleet SLIs (admission-wait
                     quantiles, starvation windows, preemption/repair
                     rates, goodput), declarative targets, multi-window
                     burn rates, and firing alerts. Backend of
                     `yoda-tpu-scheduler slo`; the same numbers export
                     as the yoda_slo_* Prometheus series.
    GET /debug/journal -> the durable claim journal's summary (head/tail
                     sequence, segment count, on-disk size, last
                     compaction, fsync policy, append/fsync/torn-record
                     counters) via the wired ``journal_fn``;
                     ``{"enabled": false}`` when ``journal_path`` is
                     unset. Reading it is covered in the durability
                     runbook (docs/OPERATIONS.md).
    GET /debug/shards -> the shard-lane process view via the wired
                     ``shards_fn``: one row per worker lane — pid,
                     lane, seconds since last heartbeat, queue depth,
                     cycle/bind counters, and the parent accountant's
                     live staged count (a dead worker's residue stays
                     visible here until replay + reconciliation clears
                     it). ``{"enabled": false}`` when sharding is off;
                     thread mode reports the in-process lanes with the
                     shared pid. Covered in the "Multi-process shard
                     serve" runbook (docs/OPERATIONS.md).

Counterpart of ``yoda_tpu/metrics_server.py``, whole. The CLI wires
``journal_fn`` (the accountant's journal) and ``shards_fn``: with thread
lanes the lanes under this pid, with process lanes the commit RPC
server's worker rows merged with the supervisor's liveness and restarts.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from yoda_tpu_torch.observability import SchedulingMetrics

PENDING_PREFIX = "/debug/pending/"


class MetricsServer:
    def __init__(
        self,
        metrics: SchedulingMetrics,
        *,
        host: str = "",
        port: int = 10259,
        ready_fn: "Callable[[], bool] | None" = None,
        journal_fn: "Callable[[], object] | None" = None,
        shards_fn: "Callable[[], dict] | None" = None,
    ):
        self.metrics = metrics
        # None = no readiness concept wired (agent mode, tests): /readyz
        # answers 200 like /healthz. A raising ready_fn reads as NOT
        # ready — fail closed, never route to a broken standby.
        self.ready_fn = ready_fn
        # Returns the stack's FileJournal (or None when journal_path is
        # unset) — a callable, not a reference, because live resizes can
        # retire the stack that owned the journal at wiring time.
        self.journal_fn = journal_fn
        # Returns the /debug/shards dict (CommitRPCServer.debug() in
        # process mode; a lane summary closure in thread mode) — a
        # callable for the same retire-on-resize reason as journal_fn.
        self.shards_fn = shards_fn
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib API)
                path, _, query = self.path.partition("?")
                qs = urllib.parse.parse_qs(query)
                if path == "/metrics":
                    body = outer.metrics.registry.render_prometheus()
                    ctype = "text/plain; version=0.0.4"
                elif path == "/healthz":
                    body, ctype = "ok\n", "text/plain"
                elif path == "/readyz":
                    try:
                        ready = outer.ready_fn is None or bool(outer.ready_fn())
                    except Exception:  # noqa: BLE001 — fail closed
                        ready = False
                    data = (b"ok\n" if ready else b"unready\n")
                    self.send_response(200 if ready else 503)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                elif path == "/trace":
                    body, ctype = self._trace(qs)
                elif path == "/debug/traces":
                    body, ctype = self._debug_traces(qs)
                elif path == "/debug/slo":
                    # Fleet SLO engine (yoda_tpu_torch/slo): a FRESH evaluation
                    # — per-tenant + fleet SLIs, targets, burn rates, and
                    # firing alerts. Backend of `yoda-tpu-scheduler slo`.
                    body = (
                        json.dumps(outer.metrics.slo.summary(), indent=1)
                        + "\n"
                    )
                    ctype = "application/json"
                elif path == "/debug/journal":
                    journal = (
                        outer.journal_fn() if outer.journal_fn else None
                    )
                    summary = (
                        journal.summary()
                        if journal is not None
                        else {"enabled": False}
                    )
                    body = json.dumps(summary, indent=1) + "\n"
                    ctype = "application/json"
                elif path == "/debug/shards":
                    view = (
                        outer.shards_fn()
                        if outer.shards_fn is not None
                        else {"enabled": False}
                    )
                    body = json.dumps(view, indent=1) + "\n"
                    ctype = "application/json"
                elif path in ("/debug/pending", PENDING_PREFIX):
                    # No key: list EVERY currently-pending pod/gang key
                    # with verdict-class counts (before this you had to
                    # already know the key to ask why it was pending).
                    body = (
                        json.dumps(
                            outer.metrics.pending.summary(), indent=1
                        )
                        + "\n"
                    )
                    ctype = "application/json"
                elif path.startswith(PENDING_PREFIX):
                    key = urllib.parse.unquote(path[len(PENDING_PREFIX):])
                    info = outer.metrics.pending.explain(key)
                    if info is None:
                        data = json.dumps(
                            {
                                "key": key,
                                "found": False,
                                "detail": "nothing pending under this key "
                                "(bound, never seen, or aged out)",
                            }
                        ).encode()
                        self.send_response(404)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
                        return
                    body = json.dumps({"found": True, **info}, indent=1) + "\n"
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _qs_int(self, qs, key, default):
                try:
                    return int(qs.get(key, [default])[0])
                except (TypeError, ValueError):
                    return default

            def _trace(self, qs) -> "tuple[str, str]":
                n = self._qs_int(qs, "n", 100)
                entries = outer.metrics.recent_traces(n)
                if qs.get("format", [""])[0] == "json":
                    return (
                        json.dumps([asdict(t) for t in entries], indent=1)
                        + "\n",
                        "application/json",
                    )
                return (
                    "\n".join(t.oneline() for t in entries) + "\n",
                    "text/plain",
                )

            def _debug_traces(self, qs) -> "tuple[str, str]":
                tracer = outer.metrics.tracer
                subject = qs.get("subject", [None])[0]
                if subject is None and "gang" in qs:
                    subject = f"gang:{qs['gang'][0]}"
                if subject is None and "pod" in qs:
                    subject = f"pod:{qs['pod'][0]}"
                n = self._qs_int(qs, "n", -1)
                records = tracer.records(
                    subject=subject,
                    trace_id=qs.get("trace", [None])[0],
                    n=n if n >= 0 else None,
                )
                if qs.get("format", [""])[0] == "perfetto":
                    return (
                        json.dumps(tracer.to_perfetto(records)) + "\n",
                        "application/json",
                    )
                return (
                    json.dumps([r.to_dict() for r in records], indent=1)
                    + "\n",
                    "application/json",
                )

            def log_message(self, *args) -> None:  # quiet
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="yoda-metrics", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
