"""End-to-end lifecycle tracing + why-pending explainability.

The scheduler runs six cooperating control loops (serve, bind executor,
drift reconciler, rebalancer, federation health/spillover, resync repair),
and before this module its debugging story was per-cycle: counters, phase
histograms, and a one-line trace ring. The operator questions at fleet
scale are causal — "why is gang X still parked?", "which loop spent the
p99 budget?" — and Gandiva's core lesson (PAPERS.md) is that introspection
into where scheduling time goes is what unlocks the next optimization.

Two first-class, dependency-free facilities:

- :class:`Tracer` — a span tracer keyed by **subject** (one trace per
  pod/gang lifetime: ``gang:<name>`` for gang members, ``pod:<key>``
  otherwise). Spans carry parent/child links, monotonic-clock durations,
  and the emitting thread's name as a Perfetto track, so one gang's whole
  story — enqueue → gather → joint dispatch → reserve → permit-park →
  bind (on the executor workers) → bound, plus rebalancer moves,
  federation spillover, and resync repairs — is a single connected trace
  even when it crosses threads, passes, or clusters. Bounded ring +
  optional JSONL sink; per-subject deterministic sampling
  (``trace_sample_rate``) with near-zero overhead when off (one float
  compare per call site). Export via :meth:`Tracer.to_perfetto` — Chrome
  trace-event JSON loadable in Perfetto, one track per loop/thread.

- :class:`PendingIndex` — the why-pending index: every rejection verdict
  (Filter's per-node ``Status.unschedulable`` reasons, gang admission
  parks, joint fit-gate parks, permit rejections, preemption nominations)
  is aggregated per pod AND per gang into a top-rejection-reasons summary
  (node names normalized out of the messages so "node h0: no free HBM"
  and "node h1: no free HBM" count as one reason over two nodes). Served
  at ``GET /debug/pending/<key>`` and by ``yoda-tpu-scheduler explain``.

Everything here is stdlib-only and lock-cheap: record paths take one lock
for one deque append / dict update; readers copy under the lock and format
outside it, so a scrape burst can never stall the serve path.

Counterpart of ``yoda_tpu/tracing.py``, whole. The port's span sites are
the reference's: enqueue, cycle, permit-park, bound, gather, joint-park,
gang-dispatch and joint-dispatch (around the card's ``fleet_eval`` and
``joint_fit`` launches), bind and unbind (on whichever thread runs them),
gang release and rollback, and the rebalancer's and repair's spans.
A scheduler lane's cycle spans carry its ``shard`` and a lost gang
commit lands as ``shard-commit-conflict`` on the gang's trace; a gang
the federation migrates gets a ``spillover`` span on the ``federation``
track, under the trace its home cycles recorded. Beyond the reference
(``observability.PORT_ONLY_OBSERVABLES``), the serve loop records a
``burst`` span per prepared burst and the collector hook a ``gc`` span per
full collection; a span's ``wall_unix`` is its start.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping

from yoda_tpu_torch.api.requests import gang_name_of
from yoda_tpu_torch.api.types import PodSpec

# Bound on distinct subjects the tracer remembers sampling decisions (and
# root span ids) for — an LRU so a million-pod churn stream cannot grow the
# map without bound. Eviction only forgets the JOIN key: already-recorded
# spans stay in the ring.
MAX_SUBJECTS = 8192

# Per-entry bound on distinct normalized rejection reasons, and on the node
# names sampled per reason — the summary is for operators, not a full dump.
MAX_REASONS = 16
MAX_REASON_NODES = 12

# The why-pending verdict taxonomy: every park site MUST record one of
# these classes, so `explain` output (and the /debug/pending listing's
# per-class counts) stays interpretable as park sites are added. The
# checker-style test in tests/test_tracing.py walks the source tree for
# ``pending.record(kind=...)`` call sites and fails on any class outside
# this set — a new park site cannot ship unexplained. Documented in
# docs/OPERATIONS.md ("Tracing and why-pending").
VERDICT_CLASSES = frozenset(
    {
        # Scheduling-cycle outcomes (framework/scheduler.done): Filter
        # found no feasible node (per-node reasons attached) / a plugin
        # or kernel error (retried via backoff) / preemption nominated a
        # node and the pod awaits victim drain.
        "unschedulable",
        "error",
        "nominated",
        # A Permit-parked member was rejected (gang rollback, bind
        # failure, fence flip, permit timeout).
        "permit-rejected",
        # Gang/topology admission parked the gang whole (no capacity or
        # no free contiguous ICI block for every member).
        "admission-park",
        # The cross-gang joint fit gate restored the gang untouched
        # (cannot place whole net of higher-priority co-queued gangs).
        "joint-park",
        # Per-tenant quota admission parked the entry (DRF queue).
        "quota-park",
        # Node failure domains: members lost to a DOWN node awaiting
        # gang-whole repair.
        "node-repair",
        # Overload brownout ladder (yoda_tpu_torch/overload.py): a non-prod
        # arrival parked at SHED; requeues when the ladder steps down.
        "overload-shed",
    }
)


def subject_of(pod: PodSpec) -> str:
    """The trace subject a pod's lifecycle records join: its gang (one
    trace tells the whole gang's story, members and moves included) or the
    pod itself."""
    gang = gang_name_of(pod.labels)
    return f"gang:{gang}" if gang else f"pod:{pod.key}"


@dataclass(slots=True)
class SpanRecord:
    """One finished span (or zero-duration event) in a subject's trace.

    ``attrs`` values are whatever the call site passed (str/int/float/
    bool — JSON-scalar by convention); the record path deliberately does
    NOT copy or stringify them, so recording stays a single lock + deque
    append on the serve path."""

    trace_id: str
    span_id: str
    parent_id: str | None
    subject: str
    name: str
    track: str          # Perfetto row: the emitting thread / control loop
    t0_ms: float        # monotonic-clock start, milliseconds
    dur_ms: float
    wall_unix: float    # the start on the Unix clock, seconds
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "subject": self.subject,
            "name": self.name,
            "track": self.track,
            "t0_ms": round(self.t0_ms, 3),
            "dur_ms": round(self.dur_ms, 3),
            "wall_unix": round(self.wall_unix, 6),
            "attrs": dict(self.attrs),
        }


class Tracer:
    """Bounded, sampled, subject-keyed span recorder.

    The first record for a sampled subject becomes the trace ROOT
    (normally the informer's ``enqueue`` event); later records with no
    explicit parent attach to it, so a walk over parent links from the
    root reaches every span of the lifetime — the "single connected
    trace" contract the tests assert.
    """

    def __init__(
        self,
        *,
        sample_rate: float = 1.0,
        capacity: int = 4096,
        sink: str | None = None,
        sink_max_bytes: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.sample_rate = max(0.0, min(float(sample_rate), 1.0))
        self.capacity = max(int(capacity), 16)
        self.sink_path = sink or None
        # Rotate-on-threshold (config trace_sink_max_bytes): past this
        # many bytes the sink rotates to "<sink>.1" (two generations —
        # current + .1 — so a week-long soak is disk-bounded at ~2x the
        # threshold). 0 = never rotate.
        self.sink_max_bytes = max(int(sink_max_bytes), 0)
        self.sink_rotations = 0
        self._sink_bytes = 0
        self.clock = clock
        # A span's wall_unix is its start, t0 shifted by this offset fixed
        # once here: on the Unix clock a span lines up with a device
        # profile (Kineto's chrome-trace ts + baseTimeNanoseconds / 1e3
        # is Unix microseconds).
        self.unix_offset = time.time() - clock()
        self.dropped = 0            # ring overflow count (oldest evicted)
        self._lock = threading.Lock()
        self._ring: deque[SpanRecord] = deque(maxlen=self.capacity)
        # subject -> (trace_id | None if unsampled, root span_id | None)
        self._subjects: "OrderedDict[str, tuple[str | None, str | None]]" = (
            OrderedDict()
        )
        self._ids = itertools.count(1)
        self._sink_file = None
        self._sink_broken = False

    # --- the record path ---

    @property
    def enabled(self) -> bool:
        """False = tracing off: call sites skip all work after this one
        attribute read (the near-zero-overhead-when-off contract)."""
        return self.sample_rate > 0.0

    def _sampled(self, subject: str) -> "tuple[str | None, str | None]":
        """(trace_id, root_id) for the subject, making the sampling
        decision on first sight. Deterministic (crc32 of the subject) so
        a gang's members and its rebalancer moves land on the same side
        of the sample fence in every process."""
        got = self._subjects.get(subject)
        if got is not None:
            self._subjects.move_to_end(subject)
            return got
        if self.sample_rate >= 1.0:
            keep = True
        else:
            keep = (
                zlib.crc32(subject.encode()) % 1_000_000
                < self.sample_rate * 1_000_000
            )
        entry = (f"t{next(self._ids):x}-{zlib.crc32(subject.encode()):08x}"
                 if keep else None, None)
        self._subjects[subject] = entry
        while len(self._subjects) > MAX_SUBJECTS:
            self._subjects.popitem(last=False)
        return entry

    def new_span_id(self) -> str:
        """Pre-allocate a span id (parents that need to hand their id to
        children before the parent record is closed — the rebalancer's
        move primitive)."""
        return f"s{next(self._ids):x}"

    def add(
        self,
        subject: str,
        name: str,
        *,
        t0: float | None = None,
        t1: float | None = None,
        parent: str | None = None,
        track: str | None = None,
        span_id: str | None = None,
        attrs: "Mapping[str, object] | None" = None,
    ) -> str | None:
        """Record one span (``t0``..``t1`` on the tracer's clock; both
        default to now, making a zero-duration event). ``attrs`` ownership
        passes to the tracer — hand it a fresh dict. Returns the span id,
        or None when the subject is unsampled / tracing is off."""
        if not self.enabled:
            return None
        now = self.clock()
        t0 = now if t0 is None else t0
        t1 = t0 if t1 is None else t1
        if track is None:
            track = threading.current_thread().name
        with self._lock:
            trace_id, root_id = self._sampled(subject)
            if trace_id is None:
                return None
            sid = span_id or f"s{next(self._ids):x}"
            if root_id is None:
                # First record of the lifetime: it becomes the root.
                self._subjects[subject] = (trace_id, sid)
            elif parent is None:
                parent = root_id
            rec = SpanRecord(
                trace_id,
                sid,
                parent,
                subject,
                name,
                track,
                t0 * 1e3,
                max(t1 - t0, 0.0) * 1e3,
                self.unix_offset + t0,
                attrs if attrs is not None else {},
            )
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)
        if self.sink_path is not None:
            self._to_sink(rec)
        return sid

    def span(self, subject: str, name: str, **kw) -> "_LiveSpan":
        """Context-manager form: times the body, records on exit. The
        span id is pre-allocated so the body can parent children to it."""
        return _LiveSpan(self, subject, name, kw)

    def _to_sink(self, rec: SpanRecord) -> None:
        if self.sink_path is None or self._sink_broken:
            return
        try:
            with self._lock:
                if self._sink_file is None:
                    self._sink_file = open(self.sink_path, "a")
                    try:
                        self._sink_bytes = os.path.getsize(self.sink_path)
                    except OSError:
                        self._sink_bytes = 0
                line = json.dumps(rec.to_dict()) + "\n"
                self._sink_file.write(line)
                self._sink_file.flush()
                self._sink_bytes += len(line)
                if (
                    self.sink_max_bytes > 0
                    and self._sink_bytes >= self.sink_max_bytes
                ):
                    # Rotate: current -> .1 (previous .1 overwritten),
                    # fresh current. Week-long soaks stay disk-bounded.
                    self._sink_file.close()
                    os.replace(self.sink_path, self.sink_path + ".1")
                    self._sink_file = open(self.sink_path, "a")
                    self._sink_bytes = 0
                    self.sink_rotations += 1
        except OSError:
            # An unwritable sink must never take the serve path down:
            # disable it and keep the in-memory ring.
            self._sink_broken = True

    def close(self) -> None:
        with self._lock:
            f, self._sink_file = self._sink_file, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    # --- the read path ---

    def trace_of(self, subject: str) -> str | None:
        """The subject's trace id, if it has been seen and sampled."""
        with self._lock:
            got = self._subjects.get(subject)
        return got[0] if got else None

    def records(
        self,
        *,
        subject: str | None = None,
        trace_id: str | None = None,
        n: int | None = None,
    ) -> "list[SpanRecord]":
        """Matching records, oldest first. Copies under the lock, filters
        outside it."""
        with self._lock:
            out = list(self._ring)
        if subject is not None:
            tid = self.trace_of(subject)
            out = [
                r
                for r in out
                if r.subject == subject or (tid and r.trace_id == tid)
            ]
        if trace_id is not None:
            out = [r for r in out if r.trace_id == trace_id]
        if n is not None and n >= 0:
            out = out[-n:]
        return out

    @staticmethod
    def to_perfetto(records: "Iterable[SpanRecord]") -> dict:
        """Chrome trace-event JSON (Perfetto's legacy-JSON importer): one
        ``pid``, one ``tid`` per track (thread/loop), complete ``X``
        events with microsecond timestamps, and thread-name metadata rows
        so Perfetto labels each loop's track."""
        records = list(records)
        tracks: "dict[str, int]" = {}
        events: list[dict] = []
        for r in records:
            tid = tracks.setdefault(r.track, len(tracks) + 1)
            events.append(
                {
                    "name": r.name,
                    "cat": r.subject,
                    "ph": "X",
                    "ts": round(r.t0_ms * 1e3, 1),
                    "dur": max(round(r.dur_ms * 1e3, 1), 1.0),
                    "pid": 1,
                    "tid": tid,
                    "args": {
                        "trace_id": r.trace_id,
                        "span_id": r.span_id,
                        "parent_id": r.parent_id or "",
                        "wall_unix": r.wall_unix,
                        **r.attrs,
                    },
                }
            )
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": track},
            }
            for track, tid in tracks.items()
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


class _LiveSpan:
    """``with tracer.span(...) as sp:`` — times the body; ``sp.span_id``
    is valid inside the body for parenting children; ``sp.annotate()``
    adds attrs before the record closes."""

    __slots__ = ("tracer", "subject", "name", "kw", "t0", "span_id")

    def __init__(self, tracer: Tracer, subject: str, name: str, kw: dict):
        self.tracer = tracer
        self.subject = subject
        self.name = name
        self.kw = kw
        self.span_id = tracer.new_span_id() if tracer.enabled else None

    def annotate(self, **attrs) -> None:
        self.kw.setdefault("attrs", {}).update(attrs)

    def __enter__(self) -> "_LiveSpan":
        self.t0 = self.tracer.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.tracer.enabled:
            if exc_type is not None:
                self.annotate(error=exc_type.__name__)
            self.tracer.add(
                self.subject,
                self.name,
                t0=self.t0,
                t1=self.tracer.clock(),
                span_id=self.span_id,
                **self.kw,
            )
        return False


# --- why-pending -----------------------------------------------------------


def _normalize_reason(node: str, message: str) -> str:
    """Fold the node name out of a per-node rejection so identical causes
    on different nodes aggregate into one reason row."""
    return message.replace(node, "<node>") if node and message else message


class PendingIndex:
    """Aggregated rejection reasons per pod and per gang — the answer to
    "why is X still pending" without a debugger.

    Writers (the scheduler's cycle outcomes, gang admission, the joint fit
    gate, permit resolutions) call :meth:`record`; a successful bind calls
    :meth:`resolve` to retire the entry. Bounded LRU over keys."""

    def __init__(
        self,
        *,
        capacity: int = 2048,
        wall: Callable[[], float] = time.time,
    ) -> None:
        self.capacity = max(int(capacity), 16)
        self.wall = wall
        # LRU evictions (config pending_index_max): a million-pod shed
        # flood recycles the oldest keys instead of growing the index —
        # counted into yoda_pending_evicted_total so operators can tell
        # "aged out" from "never seen".
        self.evicted = 0
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, dict]" = OrderedDict()

    def record(
        self,
        key: str,
        *,
        kind: str,
        message: str,
        gang: str | None = None,
        node_reasons: "Mapping[str, str] | None" = None,
        member: str | None = None,
        shard: str | None = None,
    ) -> None:
        """Record one rejection verdict for ``key`` (a pod key or a gang
        name). ``gang`` mirrors the verdict onto the gang's own entry so
        ``explain <gang>`` aggregates across members. ``shard`` names the
        scheduler shard that issued the verdict (sharded serve loops)
        so ``explain`` answers WHICH shard parked a gang."""
        now = self.wall()
        with self._lock:
            self._record_locked(
                key, kind, message, node_reasons, now, member, shard
            )
            if gang and gang != key:
                self._record_locked(
                    gang, kind, message, node_reasons, now, member or key,
                    shard,
                )

    def _record_locked(
        self, key, kind, message, node_reasons, now, member, shard=None
    ):
        e = self._entries.get(key)
        if e is None:
            e = {
                "kind": kind,
                "count": 0,
                "first_wall": now,
                "last_wall": now,
                "last_message": message,
                "members": set(),
                "shard": shard,
                # normalized reason -> [count, set(node names)]
                "reasons": OrderedDict(),
            }
            self._entries[key] = e
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evicted += 1
        else:
            self._entries.move_to_end(key)
        e["kind"] = kind
        e["count"] += 1
        e["last_wall"] = now
        e["last_message"] = message
        if shard is not None:
            e["shard"] = shard
        if member:
            e["members"].add(member)
            if len(e["members"]) > 64:
                e["members"].pop()
        reasons = e["reasons"]
        if node_reasons:
            for node, msg in itertools.islice(node_reasons.items(), 128):
                norm = _normalize_reason(node, msg)
                row = reasons.get(norm)
                if row is None:
                    if len(reasons) >= MAX_REASONS:
                        continue
                    row = reasons[norm] = [0, set()]
                row[0] += 1
                if len(row[1]) < MAX_REASON_NODES:
                    row[1].add(node)
        elif message:
            row = reasons.get(message)
            if row is None and len(reasons) < MAX_REASONS:
                row = reasons[message] = [0, set()]
            if row is not None:
                row[0] += 1

    def resolve(self, key: str, *, gang: str | None = None) -> None:
        """The pod (or a gang member) bound: its pending story is over."""
        with self._lock:
            self._entries.pop(key, None)
            if gang:
                self._entries.pop(gang, None)

    def explain(self, key: str) -> dict | None:
        """The aggregated why-pending summary for a pod key or gang name
        (None when nothing is recorded — bound, never seen, or evicted)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            reasons = [
                {
                    "reason": norm,
                    "count": row[0],
                    "nodes": sorted(row[1]),
                }
                for norm, row in e["reasons"].items()
            ]
            members = sorted(e["members"])
            out = {
                "key": key,
                "kind": e["kind"],
                "attempts": e["count"],
                "first_wall_unix": round(e["first_wall"], 3),
                "last_wall_unix": round(e["last_wall"], 3),
                "last_message": e["last_message"],
                "members": members,
                "shard": e.get("shard"),
            }
        reasons.sort(key=lambda r: -r["count"])
        out["top_reasons"] = reasons
        return out

    def keys(self) -> "list[str]":
        with self._lock:
            return list(self._entries)

    def summary(self) -> dict:
        """Every currently-pending pod/gang key with its verdict class —
        the no-argument half of why-pending (``GET /debug/pending``,
        ``explain --list``): before this you had to already KNOW the key
        to ask why it was pending. Most-recent verdict first; per-class
        counts let an operator triage a big backlog at a glance."""
        with self._lock:
            entries = [
                {
                    "key": key,
                    "kind": e["kind"],
                    "attempts": e["count"],
                    "first_wall_unix": round(e["first_wall"], 3),
                    "last_wall_unix": round(e["last_wall"], 3),
                    "members": len(e["members"]),
                }
                for key, e in self._entries.items()
            ]
        entries.sort(key=lambda e: (-e["last_wall_unix"], e["key"]))
        by_kind: "dict[str, int]" = {}
        for e in entries:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
        return {
            "count": len(entries),
            "by_kind": dict(sorted(by_kind.items())),
            "pending": entries,
        }
