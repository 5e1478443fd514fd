"""Append-only durable claim journal — the on-disk CommitLog.

Record format (one record per accountant state mutation, write-ahead:
the record is durable BEFORE the in-memory mutation applies):

    [4-byte LE length][4-byte LE CRC32 of payload][payload]

The payload is utf-8 text, fields separated by ``\\x1f`` (unit
separator — cannot appear in uids/node names/gang names, which are
Kubernetes identifiers). Field 0 is the record kind, field 1 the global
record sequence number:

    S seq uid node chips shard stage_seq gang   claim upsert (staged when
                                                shard != "", else committed)
    C seq uid1,uid2,...                         staged claims committed
    R seq uid                                   committed claim released
    B seq uid                                   staged claim rolled back
    P seq json                                  snapshot (full mirror state)
    T seq term                                  epoch term bump — the FIRST
                                                frame a promoted standby
                                                writes (journal/tail.py)

Segments rotate at ``segment_bytes``: a new segment opens with a ``P``
snapshot record of the journal's own mirror state and every older
segment is deleted (compaction) — steady-state journal size is flat at
roughly one snapshot plus one segment of deltas.

Recovery tolerates torn tails: replay stops at the first record whose
length header, payload, or CRC does not check out, truncates the
segment there, discards any later segments, and counts each repair in
``torn_records`` (the ``yoda_journal_torn_records_total`` series). A
write or fsync failure marks the journal DEAD and raises
:class:`JournalFault` — the commit point fail-stops rather than serving
on claims it cannot make durable; the standby's replay owns recovery.

Failure-injection seam: every disk op goes through ``self.io``
(:class:`RealJournalIO`). The chaos harness swaps in a faulty
implementation (short writes, fsync errors, crash-between-append-and-
ack) without the journal knowing.

Counterpart of ``yoda_tpu/journal/journal.py``, whole: the record layout,
the replay and its repairs, rotation, the in-memory ship ring
(:meth:`FileJournal.frames_since`, :meth:`FileJournal.ship_state`) and
:meth:`FileJournal.promote` are the reference's, so a journal written by
either package replays in the other to the same state, byte for byte. Its
readers across processes (the tailing standby, ``journal/tail.py``) wait
for a later slice.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field

# In-memory ship ring depth (journal shipping): the tailing
# standby polls `frames_since`; a follower more than this many frames
# behind catches up from a full mirror snapshot instead.
_SHIP_RING = 4096

_SEP = "\x1f"
_HDR = struct.Struct("<II")
# batch sync policy: fsync at most every N appends (commit/snapshot
# records always sync — they are the durability edges that matter).
_BATCH_EVERY = 64


class JournalFault(RuntimeError):
    """A journal disk operation failed (or a chaos fault fired). The
    journal is dead; the process must fail-stop and let a standby
    replay."""


# A replayed claim is a plain mutable 5-list, NOT a dataclass: a
# 100k-claim snapshot record deserializes straight out of json.loads
# with zero per-claim construction, and that parse sits on the
# promotion blackout (the ≥5x replay-vs-cold-resync bench bounds it).
# Layout: [node, chips, shard, seq, gang]; shard "" = committed, else
# the staging shard/lane; seq = stage order (first-staged wins at
# commit); gang = gang name for resume-mid-gang.
CLAIM_NODE, CLAIM_CHIPS, CLAIM_SHARD, CLAIM_SEQ, CLAIM_GANG = range(5)


def claim(node, chips, shard="", seq=0, gang=""):
    """Build one replayed-claim list (tests, snapshot fixtures)."""
    return [node, int(chips), shard, int(seq), gang]


@dataclass
class ReplayedState:
    """What a journal replay rebuilt — the accountant restores from
    this, and the reconciler's warm resync diffs cluster truth against
    it instead of rebuilding from scratch."""

    claims: "dict[str, list]" = field(default_factory=dict)
    stage_seq: int = 0
    tail_seq: int = 0
    torn_records: int = 0
    replay_ms: float = 0.0
    # Epoch term of the last T record replayed (0 = none seen — a
    # pre-multi-host journal). The promoted standby writes its bumped
    # term as its first frame, so replaying ITS journal recovers the
    # fencing token too.
    term: int = 0

    def staged_gangs(self) -> "dict[str, set[str]]":
        """gang name -> uids of its still-STAGED claims: the mid-gang
        crash residue a promoted standby resumes from (the reconciler
        adopts these instead of rolling the gang back)."""
        out: dict[str, set[str]] = {}
        for uid, c in self.claims.items():
            if c[CLAIM_SHARD] and c[CLAIM_GANG]:
                out.setdefault(c[CLAIM_GANG], set()).add(uid)
        return out


class CommitLog:
    """The commit-point durability interface. Every ChipAccountant state
    mutation reports through exactly one of these methods (the yodalint
    ``journal-discipline`` pass enforces that no other module calls
    them)."""

    def record_stage(
        self, uid: str, node: str, chips: int,
        shard: "str | None", seq: int, gang: str = "",
    ) -> None:
        raise NotImplementedError

    def record_commit(self, uids) -> None:
        raise NotImplementedError

    def record_release(self, uid: str) -> None:
        raise NotImplementedError

    def record_rollback(self, uid: str) -> None:
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - trivial
        pass


class NullCommitLog(CommitLog):
    """Journal off (``journal_path`` unset): every record is a no-op —
    the in-memory accountant IS the commit log, exactly today's
    behavior. (build_stack leaves ``accountant.journal = None`` so even
    the no-op calls are skipped on the hot path; this class exists for
    interface completeness and direct CommitLog consumers.)"""

    def record_stage(self, uid, node, chips, shard, seq, gang=""):
        pass

    def record_commit(self, uids):
        pass

    def record_release(self, uid):
        pass

    def record_rollback(self, uid):
        pass


class RealJournalIO:
    """The real disk ops — one seam for chaos fault injection."""

    def write(self, fobj, data: bytes) -> int:
        return fobj.write(data)

    def flush(self, fobj) -> None:
        fobj.flush()

    def fsync(self, fobj) -> None:
        os.fsync(fobj.fileno())

    def ack(self) -> None:
        """Fires after a record is durable, before the append returns —
        the crash-between-append-and-ack injection point."""


class FileJournal(CommitLog):
    """Segment-rotated append-only journal under a directory.

    ``sync`` and ``segment_bytes`` are LIVE attributes — hot-reload
    (standalone.apply_reloadable) assigns them and the next append reads
    the new values; ``path`` is immutable for the process lifetime.
    """

    def __init__(
        self,
        path: str,
        *,
        sync: str = "batch",
        segment_bytes: int = 4 * 1024 * 1024,
        io: "RealJournalIO | None" = None,
    ) -> None:
        self.path = path
        self.sync = sync
        self.segment_bytes = int(segment_bytes)
        self.io = io or RealJournalIO()
        self._wlock = threading.Lock()
        self._fobj = None
        self._seg_index = 0
        self._seg_size = 0
        self._seq = 0               # last record seq written or replayed
        self._head_seq = 0          # first seq in the oldest segment
        self._dead = False
        self._since_sync = 0
        # The journal's own mirror of accountant claim state (uid ->
        # claim 5-list) — what rotation snapshots serialize, so a
        # snapshot never needs to call back into the accountant (whose
        # lock is held during appends).
        self._mirror: dict[str, list] = {}
        self._stage_seq = 0
        # Epoch term (multi-host control plane): replayed from the last
        # T record; bumped only through promote()/record_term_bump.
        self._term = 0
        # Journal shipping (the standby tailer's feed): recent frame
        # payloads by seq, appended under _wlock so a follower's
        # `frames_since` sees exactly the committed order.
        self._ship: "deque[tuple[int, str]]" = deque(maxlen=_SHIP_RING)
        # Snapshot frame size of the last rotation: the next rotation
        # waits until the segment holds at least this many DELTA bytes
        # again, or a working set bigger than segment_bytes would
        # re-rotate on every append (each rotation opens with a
        # snapshot of the whole working set).
        self._last_snap_bytes = 0
        self.last_compaction_seq = 0
        # Counters behind the yoda_journal_* series.
        self.appends = 0
        self.bytes_written = 0
        self.fsyncs = 0
        self.torn_records = 0
        self.compactions = 0
        self.replay_ms = 0.0

    # --- open / replay ---

    def open(self) -> ReplayedState:
        """Replay every segment in order, repair the tail (truncate at
        the first bad record, discard later segments), position the
        append head, and return the replayed state."""
        t0 = time.perf_counter()
        os.makedirs(self.path, exist_ok=True)
        state = ReplayedState()
        segments = self._segment_indices()
        clean = True
        for idx in segments:
            if not clean:
                # Everything after a torn segment is untrusted (WAL
                # convention: a later segment implies the earlier one
                # closed clean, which it did not).
                os.remove(self._seg_path(idx))
                state.torn_records += 1
                continue
            clean, first_seq = self._replay_segment(idx, state)
            if not self._head_seq and first_seq:
                self._head_seq = first_seq
        self._seq = state.tail_seq
        self._stage_seq = state.stage_seq
        self._term = state.term
        # The mirror SHARES the replayed claim lists with the returned
        # state: by the attach contract (standalone._attach_journal) the
        # caller consumes the state via accountant.restore() — which
        # copies into _Claim records — before any append can mutate
        # these lists.
        self._mirror = state.claims
        live = [i for i in self._segment_indices()]
        self._seg_index = live[-1] if live else 1
        self._open_segment(self._seg_index, append=True)
        self.torn_records += state.torn_records
        state.replay_ms = (time.perf_counter() - t0) * 1e3
        self.replay_ms += state.replay_ms
        return state

    def _segment_indices(self) -> "list[int]":
        out = []
        try:
            names = os.listdir(self.path)
        except FileNotFoundError:
            return []
        for n in names:
            if n.startswith("seg-") and n.endswith(".log"):
                try:
                    out.append(int(n[4:-4]))
                except ValueError:
                    continue
        return sorted(out)

    def _seg_path(self, idx: int) -> str:
        return os.path.join(self.path, f"seg-{idx:08d}.log")

    def _replay_segment(
        self, idx: int, state: ReplayedState
    ) -> "tuple[bool, int]":
        """Apply one segment into ``state``. Returns ``(clean,
        first_seq)`` — clean is False (after a truncate-repair) when the
        tail is torn: a short header or payload, a CRC mismatch, an
        unparseable record, or an unknown kind all stop the replay at the
        last good record, and the segment is truncated there.

        This loop is the promotion blackout (the ≥5x replay-vs-cold-
        resync bench bounds it at the 100k-claim shape), hence the
        hand-tuned shape: local bindings, per-kind inline apply, and seq
        parsed as an int only at the edges — records are written with a
        strictly increasing seq by the single appender, so the LAST
        applied record's seq IS the tail."""
        path = self._seg_path(idx)
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        good_end = 0
        first_seq = 0
        last_seq_s = None
        claims = state.claims
        stage_seq = state.stage_seq
        hdr_size = _HDR.size
        unpack = _HDR.unpack_from
        crc32 = zlib.crc32
        n = len(data)
        try:
            while off < n:
                if off + hdr_size > n:
                    break  # torn header
                length, crc = unpack(data, off)
                start = off + hdr_size
                end = start + length
                if length == 0 or end > n:
                    break  # torn payload
                payload = data[start:end]
                if crc32(payload) != crc:
                    break  # bit flip
                fields = payload.decode("utf-8").split(_SEP)
                kind = fields[0]
                if kind == "S":
                    _k, seq_s, uid, node, chips, shard, sseq, gang = fields
                    if sseq == "0":
                        ss = 0
                    else:
                        ss = int(sseq)
                        if ss > stage_seq:
                            stage_seq = ss
                    claims[uid] = [node, int(chips), shard, ss, gang]
                elif kind == "C":
                    for uid in fields[2].split(","):
                        c = claims.get(uid)
                        if c is not None:
                            c[CLAIM_SHARD] = ""
                            c[CLAIM_SEQ] = 0
                elif kind in ("R", "B"):
                    claims.pop(fields[2], None)
                elif kind == "P":
                    # The snapshot IS the claims mapping (uid -> claim
                    # 5-list): json.loads rebuilds it with zero
                    # per-claim construction.
                    snap = json.loads(fields[2])
                    claims = state.claims = snap["claims"]
                    ss = int(snap["stage_seq"])
                    if ss > stage_seq:
                        stage_seq = ss
                    t = int(snap.get("term", 0))
                    if t > state.term:
                        state.term = t
                elif kind == "T":
                    t = int(fields[2])
                    if t > state.term:
                        state.term = t
                else:
                    break  # unknown kind = corrupt
                if first_seq == 0:
                    first_seq = int(fields[1])
                last_seq_s = fields[1]
                off = end
                good_end = end
        except (ValueError, KeyError, IndexError, UnicodeDecodeError):
            pass  # unparseable record: torn from here
        state.stage_seq = stage_seq
        if last_seq_s is not None:
            seq = int(last_seq_s)
            if seq > state.tail_seq:
                state.tail_seq = seq
        if good_end < n:
            state.torn_records += 1
            with open(path, "r+b") as f:
                f.truncate(good_end)
            return False, first_seq
        return True, first_seq

    def _open_segment(self, idx: int, *, append: bool) -> None:
        if self._fobj is not None:
            self._fobj.close()
        path = self._seg_path(idx)
        self._fobj = open(path, "ab" if append else "wb")
        self._seg_size = self._fobj.tell()
        self._seg_index = idx

    # --- the CommitLog write side ---

    def record_stage(self, uid, node, chips, shard, seq, gang=""):
        self._append(
            "S", uid, node, str(int(chips)), shard or "",
            str(int(seq)), gang or "",
        )
        self._mirror[uid] = [
            node, int(chips), shard or "", int(seq), gang or ""
        ]
        self._stage_seq = max(self._stage_seq, int(seq))

    def record_commit(self, uids):
        uids = list(uids)
        self._append("C", ",".join(uids), sync_now=True)
        for uid in uids:
            c = self._mirror.get(uid)
            if c is not None:
                c[CLAIM_SHARD] = ""
                c[CLAIM_SEQ] = 0

    def record_release(self, uid):
        self._append("R", uid)
        self._mirror.pop(uid, None)

    def record_rollback(self, uid):
        self._append("B", uid)
        self._mirror.pop(uid, None)

    def record_term_bump(self, term: int) -> None:
        """Append the ``T`` record — the epoch-term fencing token. Only
        the promotion path (:meth:`promote`, driven by journal/tail.py)
        may write it; the yodalint journal-discipline pass keeps every
        module outside the journal package off this method. Always
        fsynced: the term must be durable before the promoted parent
        answers anything."""
        term = int(term)
        self._append("T", str(term), sync_now=True)
        self._term = term

    # --- journal shipping (the hot-standby tailer's read side) ---

    def frames_since(self, since: int) -> "tuple[list[str], int] | None":
        """Frame payloads appended after record seq ``since``, served
        from the in-memory ship ring: ``(frames, tail_seq)``, or
        ``None`` when the ring no longer reaches back (a fresh follower
        or one too far behind — it then catches up via
        :meth:`ship_state`)."""
        with self._wlock:
            if since >= self._seq:
                return [], self._seq
            if not self._ship or self._ship[0][0] > since + 1:
                return None
            return [p for s, p in self._ship if s > since], self._seq

    @property
    def term(self) -> int:
        """Epoch term this journal last recorded (replayed from the
        last ``T`` frame at open; 0 = no promotion ever touched it). A
        restarted parent must resume serving AT this term — any worker
        that saw it would fence a term-1 restart as stale."""
        return self._term

    def ship_state(self) -> dict:
        """One consistent copy of the journal's own mirror — the
        follower's snapshot catch-up when the ship ring no longer
        reaches back. Claim lists are copied: the live mirror mutates
        under appends while the copy rides an RPC reply."""
        with self._wlock:
            return {
                "claims": {u: list(c) for u, c in self._mirror.items()},
                "stage_seq": self._stage_seq,
                "tail_seq": self._seq,
                "term": self._term,
            }

    def promote(
        self, state: ReplayedState, term: int, *, snapshot: str = "defer"
    ) -> None:
        """Adopt a tailed mirror and take ownership of the log at a new
        term — the standby's promotion path (journal/tail.py). O(1) on
        the blackout path: the mirror is adopted by reference, the seq
        head continues after the shipped tail (seq continuity across
        parent generations), and the term-bump record is this journal's
        FIRST frame, fsynced before the method returns.

        ``snapshot`` controls when the adopted mirror becomes replayable
        from THIS journal's segments: ``"defer"`` (default) writes the
        base snapshot on a background thread — a crash inside that
        window falls back to the reconciler's warm resync, which is the
        trade that keeps promotion off the ~100 ms 100k-claim
        serialization; ``"sync"`` rotates inline before returning;
        ``"none"`` leaves it to the next size-triggered rotation."""
        with self._wlock:
            self._mirror = state.claims
            self._stage_seq = max(self._stage_seq, state.stage_seq)
            if state.tail_seq > self._seq:
                self._seq = state.tail_seq
        self.record_term_bump(term)
        if snapshot == "sync":
            self._snapshot_now()
        elif snapshot == "defer":
            threading.Thread(
                target=self._snapshot_now,
                name="journal-promote-snapshot",
                daemon=True,
            ).start()

    def _snapshot_now(self) -> None:
        with self._wlock:
            if not self._dead:
                try:
                    self._rotate()
                except JournalFault:
                    pass  # dead now; the next append fail-stops the commit point

    def _append(self, kind: str, *fields: str, sync_now: bool = False) -> None:
        with self._wlock:
            if self._dead:
                raise JournalFault("journal is dead after an earlier fault")
            # Rotate BEFORE appending, so this record lands in the NEW
            # segment — a post-append rotation would snapshot the mirror
            # without this record and then delete the segment holding
            # it: a silently lost claim. The delta-bytes floor
            # (_last_snap_bytes) stops a working set larger than
            # segment_bytes from re-rotating on every append.
            if (
                self._seg_size >= self.segment_bytes
                and self._seg_size >= 2 * self._last_snap_bytes
            ):
                self._rotate()
            self._seq += 1
            payload_s = _SEP.join((kind, str(self._seq)) + fields)
            payload = payload_s.encode()
            frame = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
            self._write_frame(frame, sync_now=sync_now)
            self._ship.append((self._seq, payload_s))
            if not self._head_seq:
                self._head_seq = self._seq

    def _write_frame(self, frame: bytes, *, sync_now: bool) -> None:
        try:
            n = self.io.write(self._fobj, frame)
            if n is not None and n < len(frame):
                raise JournalFault(
                    f"short write: {n}/{len(frame)} bytes reached segment "
                    f"{self._seg_index}"
                )
            self.io.flush(self._fobj)
            sync = self.sync
            self._since_sync += 1
            if sync == "always" or (
                sync == "batch"
                and (sync_now or self._since_sync >= _BATCH_EVERY)
            ):
                self.io.fsync(self._fobj)
                self.fsyncs += 1
                self._since_sync = 0
            self.io.ack()
        except JournalFault:
            self._dead = True
            raise
        except OSError as e:
            self._dead = True
            raise JournalFault(f"journal write failed: {e}") from e
        self._seg_size += len(frame)
        self.appends += 1
        self.bytes_written += len(frame)

    def _rotate(self) -> None:
        """Open the next segment headed by a snapshot of the mirror, then
        delete every older segment — compaction keeps total size flat."""
        old = self._segment_indices()
        self._open_segment(self._seg_index + 1, append=False)
        self._seq += 1
        # Mirror values are already the wire-format 5-lists, so the snapshot
        # is a single json.dumps with no per-claim construction (and replay
        # is a single json.loads).
        snap = json.dumps(
            {
                "claims": self._mirror,
                "stage_seq": self._stage_seq,
                "term": self._term,
            },
            separators=(",", ":"),
        )
        payload_s = _SEP.join(("P", str(self._seq), snap))
        payload = payload_s.encode()
        frame = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
        self._write_frame(frame, sync_now=True)
        self._ship.append((self._seq, payload_s))
        self._last_snap_bytes = len(frame)
        self._head_seq = self._seq
        self.last_compaction_seq = self._seq
        for idx in old:
            if idx != self._seg_index:
                try:
                    os.remove(self._seg_path(idx))
                except OSError:
                    pass
        self.compactions += 1

    # --- introspection (GET /debug/journal, soak assertions) ---

    def size_bytes(self) -> int:
        return sum(
            os.path.getsize(self._seg_path(i))
            for i in self._segment_indices()
        )

    def summary(self) -> dict:
        return {
            "enabled": True,
            "path": self.path,
            "head_seq": self._head_seq,
            "tail_seq": self._seq,
            "term": self._term,
            "segments": len(self._segment_indices()),
            "size_bytes": self.size_bytes(),
            "last_compaction_seq": self.last_compaction_seq,
            "sync": self.sync,
            "segment_bytes": self.segment_bytes,
            "appends": self.appends,
            "fsyncs": self.fsyncs,
            "compactions": self.compactions,
            "torn_records": self.torn_records,
            "replay_ms": round(self.replay_ms, 3),
            "dead": self._dead,
        }

    def close(self) -> None:
        """Graceful close: under ``sync=batch`` up to ``_BATCH_EVERY-1``
        appended frames may sit un-fsynced (flushed to the page cache
        but not durable). A clean shutdown must not drop that tail —
        flush + fsync pending frames before closing the segment. A dead
        journal skips the sync (the fault already fail-stopped the
        commit point); a sync failure here marks it dead rather than
        raising, since close() runs on teardown paths that cannot
        recover anyway."""
        with self._wlock:
            if self._fobj is not None:
                if (
                    not self._dead
                    and self.sync == "batch"
                    and self._since_sync > 0
                ):
                    try:
                        self.io.flush(self._fobj)
                        self.io.fsync(self._fobj)
                        self.fsyncs += 1
                        self._since_sync = 0
                    except (JournalFault, OSError):
                        self._dead = True
                self._fobj.close()
                self._fobj = None
