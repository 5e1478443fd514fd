"""Scheduling queue: active heap ordered by the QueueSort plugin, with
backoff for unschedulable pods.

The reference supplies only the ordering function (``Less``, reference
pkg/yoda/sort/sort.go:8-18) and inherits the queue machinery (active /
backoff / unschedulable pools, event-driven re-activation) from upstream;
this module is the from-scratch equivalent of that machinery.

Counterpart of ``yoda_tpu/framework/queue.py``, ported as far as the
singleton and gang paths reach it: one tenant-blind active heap, the
backoff heap, the unresolvable pool, the gang-arrival promotion, the gang
gather (``pop_matching``, ``restore``), ``readd``, ``pending_gangs`` and the
activity signal the scheduler's drain waits on. Left out until a later
slice: per-tenant DRF fair queuing and quota parking, the overload shed
hook, ``take_gang`` (federation spillover), ``all_entries`` / ``find``
(shard reroute, drift reconciler) and ``close``.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable

from yoda_tpu_torch.api.requests import gang_name_of
from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.framework.interfaces import QueueSortPlugin

# Upstream kube-scheduler defaults: initial 1s, doubling, capped at 10s.
INITIAL_BACKOFF_S = 1.0
MAX_BACKOFF_S = 10.0

# Cluster-event reactivation (move_all_to_active) retries a pod IMMEDIATELY
# through this many attempts and respects the pod's backoff timer beyond it
# (upstream's moveAllToActiveOrBackoffQueue semantics).
IMMEDIATE_RETRY_ATTEMPTS = 5


@dataclass
class QueuedPodInfo:
    pod: PodSpec
    attempts: int = 0
    added_unix: float = 0.0
    unschedulable_message: str = ""

    def backoff_seconds(self) -> float:
        # Exponent capped: a chronically-retried entry must saturate at
        # MAX_BACKOFF_S, not overflow float range at 2**1024.
        exp = min(max(self.attempts - 1, 0), 10)
        return min(INITIAL_BACKOFF_S * (2 ** exp), MAX_BACKOFF_S)


class _HeapItem:
    """heapq adapter: delegates ordering to the QueueSort plugin, with a
    monotonic tiebreak so equal-priority pods stay FIFO."""

    __slots__ = ("qpi", "seq", "less")

    def __init__(self, qpi: QueuedPodInfo, seq: int, less: Callable) -> None:
        self.qpi = qpi
        self.seq = seq
        self.less = less

    def __lt__(self, other: "_HeapItem") -> bool:
        if self.less(self.qpi, other.qpi):
            return True
        if self.less(other.qpi, self.qpi):
            return False
        return self.seq < other.seq


class SchedulingQueue:
    def __init__(
        self,
        sort_plugin: QueueSortPlugin | None = None,
        *,
        clock: Callable[[], float] = time.monotonic,
        immediate_retry_attempts: int = IMMEDIATE_RETRY_ATTEMPTS,
    ) -> None:
        if sort_plugin is not None:
            self._less = sort_plugin.less
        else:
            self._less = lambda a, b: a.pod.creation_seq < b.pod.creation_seq
        self._clock = clock
        # 0 = strict upstream semantics (every event move respects backoff).
        self.immediate_retry_attempts = immediate_retry_attempts
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._seq = itertools.count()
        self._active: list[_HeapItem] = []
        self._backoff: list[tuple[float, int, QueuedPodInfo]] = []  # (ready_at, seq, qpi)
        self._unschedulable: dict[str, QueuedPodInfo] = {}  # pod key -> qpi
        # Optional listener fired (outside the queue lock) whenever work
        # arrives or parked pods are reactivated — the scheduler's
        # event-bound drain (Scheduler.run_until_idle) waits on it instead
        # of polling.
        self.on_activity: Callable[[], None] | None = None

    def __len__(self) -> int:
        with self._lock:
            return (
                len(self._active) + len(self._backoff) + len(self._unschedulable)
            )

    def depths(self) -> tuple[int, int, int]:
        """(active, backoff, parked-unresolvable) pool sizes."""
        with self._lock:
            return (
                len(self._active), len(self._backoff), len(self._unschedulable)
            )

    def pending_retry_count(self) -> int:
        """Pods that will re-enter the active queue without an external
        event (active + backoff); excludes the parked-unresolvable pool."""
        with self._lock:
            return len(self._active) + len(self._backoff)

    def has_parked(self) -> bool:
        """Anything waiting on an event or a timer (backoff OR
        unresolvable)? The ``move_all_to_active`` fast-skip reads this."""
        with self._lock:
            return bool(self._backoff or self._unschedulable)

    def add(self, pod: PodSpec) -> None:
        with self._cond:
            self._push_active(QueuedPodInfo(pod=pod, added_unix=self._clock()))
            # Gang-arrival signal: a new member of gang G reactivates every
            # parked/backoff member of G IMMEDIATELY (bypassing their
            # backoff timers) — the late member triggers exactly one retry
            # of its siblings instead of leaving them to walk the
            # backoff-sleep ladder while the gang could now complete.
            gang = gang_name_of(pod.labels)
            if gang:
                self._promote_gang_locked(gang)
            self._cond.notify()
        self._fire_activity()

    def _fire_activity(self) -> None:
        cb = self.on_activity
        if cb is not None:
            cb()

    def _promote_gang_locked(self, gang: str) -> None:
        """Move every parked member of ``gang`` to the active queue now."""
        still: list[tuple[float, int, QueuedPodInfo]] = []
        moved = False
        for ready_at, seq, qpi in self._backoff:
            if gang_name_of(qpi.pod.labels) == gang:
                self._push_active(qpi)
                moved = True
            else:
                still.append((ready_at, seq, qpi))
        if moved:
            heapq.heapify(still)
            self._backoff = still
        for key in [
            k
            for k, q in self._unschedulable.items()
            if gang_name_of(q.pod.labels) == gang
        ]:
            self._push_active(self._unschedulable.pop(key))

    def _push_active(self, qpi: QueuedPodInfo) -> None:
        if qpi.added_unix == 0.0:
            qpi.added_unix = self._clock()
        heapq.heappush(
            self._active, _HeapItem(qpi, next(self._seq), self._less)
        )

    def _flush_backoff_locked(self) -> None:
        now = self._clock()
        while self._backoff and self._backoff[0][0] <= now:
            _, _, qpi = heapq.heappop(self._backoff)
            self._push_active(qpi)

    def pop(self, timeout: float | None = None) -> QueuedPodInfo | None:
        """Pop the highest-priority active pod; blocks up to ``timeout``
        (forever if None) until one is available."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                self._flush_backoff_locked()
                if self._active:
                    qpi = heapq.heappop(self._active).qpi
                    qpi.attempts += 1
                    return qpi
                waits = []
                if self._backoff:
                    waits.append(max(self._backoff[0][0] - self._clock(), 0.0))
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return None
                    waits.append(remaining)
                self._cond.wait(timeout=min(waits) if waits else None)

    def pop_matching(
        self,
        pred: Callable[[PodSpec], bool],
        limit: int | None = None,
        *,
        include_backoff: bool = False,
    ) -> list[QueuedPodInfo]:
        """Pop every ACTIVE entry whose pod satisfies ``pred``, in queue
        order (priority, FIFO) — the gang-aware gather next to the
        scheduler's ``_pop_burst``: when a popped pod is a gang member,
        its co-queued siblings are pulled out so the whole gang runs
        back-to-back in one fused pass instead of one cycle per loop turn.
        Non-blocking; expired backoff entries are flushed first so a
        sibling whose retry timer just lapsed is gathered too.

        ``include_backoff`` additionally pulls matching entries whose
        backoff timer is STILL TICKING (appended after the active matches,
        ready-time order): a gang member's pop can fuse siblings that
        bounced into timed backoff one retry earlier, instead of leaving
        them to the gang-arrival signal or the backoff ladder."""
        with self._cond:
            self._flush_backoff_locked()
            taken: list[_HeapItem] = []
            keep: list[_HeapItem] = []
            for item in self._active:
                if pred(item.qpi.pod) and (limit is None or len(taken) < limit):
                    taken.append(item)
                else:
                    keep.append(item)
            if taken:
                heapq.heapify(keep)
                self._active = keep
            taken.sort()  # heap-internal order -> queue order
            out = [item.qpi for item in taken]
            if include_backoff:
                still: list[tuple[float, int, QueuedPodInfo]] = []
                moved = False
                for entry in sorted(self._backoff):
                    if (limit is None or len(out) < limit) and pred(entry[2].pod):
                        out.append(entry[2])
                        moved = True
                    else:
                        still.append(entry)
                if moved:
                    heapq.heapify(still)
                    self._backoff = still
        for qpi in out:
            qpi.attempts += 1
        return out

    def pending_gangs(self) -> "dict[str, tuple[int, int]]":
        """gang name -> (queued member count, min attempts over them),
        across all three pools: which gangs are WHOLE in the queue and
        have already failed (the view a spillover pass reads)."""
        with self._lock:
            out: dict[str, tuple[int, int]] = {}
            entries = (
                [item.qpi for item in self._active]
                + [qpi for _, _, qpi in self._backoff]
                + list(self._unschedulable.values())
            )
            for qpi in entries:
                gang = gang_name_of(qpi.pod.labels)
                if gang:
                    n, a = out.get(gang, (0, 1 << 30))
                    out[gang] = (n + 1, min(a, qpi.attempts))
            return out

    def readd(self, qpi: QueuedPodInfo) -> None:
        """Return an entry taken out of the queue without a scheduling
        cycle to the active queue untouched (unlike :meth:`restore`, no
        attempt decrement)."""
        with self._cond:
            self._push_active(qpi)
            self._cond.notify()
        self._fire_activity()

    def restore(self, qpi: QueuedPodInfo) -> None:
        """Return a popped-but-unscheduled entry to the active queue (the
        burst pop un-pops gang members it encounters so their own pop runs
        the gang gather; the joint pass restores a gang it parks whole).
        The pop's attempt increment is reverted — no scheduling cycle
        ran."""
        qpi.attempts = max(qpi.attempts - 1, 0)
        with self._cond:
            self._push_active(qpi)
            self._cond.notify()

    def remove(self, uid: str) -> bool:
        """Drop every entry for the pod with this uid from all three pools
        — the delete-event fast path. Returns whether anything was
        removed."""
        removed = False
        with self._cond:
            kept = [it for it in self._active if it.qpi.pod.uid != uid]
            if len(kept) != len(self._active):
                heapq.heapify(kept)
                self._active = kept
                removed = True
            backoff = [e for e in self._backoff if e[2].pod.uid != uid]
            if len(backoff) != len(self._backoff):
                heapq.heapify(backoff)
                self._backoff = backoff
                removed = True
            for key in [
                k for k, q in self._unschedulable.items() if q.pod.uid == uid
            ]:
                del self._unschedulable[key]
                removed = True
        if removed:
            self._fire_activity()
        return removed

    def add_unschedulable(self, qpi: QueuedPodInfo, message: str = "") -> None:
        """Park a pod that failed a cycle. It re-enters the active queue
        after backoff AND on any cluster event via ``move_all_to_active``."""
        qpi.unschedulable_message = message
        if qpi.added_unix == 0.0:
            qpi.added_unix = self._clock()
        with self._cond:
            ready_at = self._clock() + qpi.backoff_seconds()
            heapq.heappush(self._backoff, (ready_at, next(self._seq), qpi))
            self._cond.notify()

    def park_unresolvable(self, qpi: QueuedPodInfo, message: str = "") -> None:
        """Park a pod whose failure retries cannot fix (e.g. malformed
        labels): it returns to the active queue only on an explicit cluster
        event (``move_all_to_active``)."""
        qpi.unschedulable_message = message
        if qpi.added_unix == 0.0:
            qpi.added_unix = self._clock()
        with self._lock:
            self._unschedulable[qpi.pod.key] = qpi

    def move_all_to_active(self, *, force: bool = False) -> None:
        """Cluster changed: retry parked pods — immediately through
        ``immediate_retry_attempts``, after that only when the pod's own
        backoff timer has expired. ``force`` bypasses the cutoff (the
        settlement loop, Scheduler.run_until_idle)."""
        with self._cond:
            now = self._clock()
            cutoff = float("inf") if force else self.immediate_retry_attempts
            still: list[tuple[float, int, QueuedPodInfo]] = []
            for ready_at, seq, qpi in self._backoff:
                if qpi.attempts <= cutoff or ready_at <= now:
                    self._push_active(qpi)
                else:
                    still.append((ready_at, seq, qpi))
            heapq.heapify(still)
            self._backoff = still
            for qpi in self._unschedulable.values():
                if qpi.attempts <= cutoff:
                    self._push_active(qpi)
                else:
                    heapq.heappush(
                        self._backoff,
                        (now + qpi.backoff_seconds(), next(self._seq), qpi),
                    )
            self._unschedulable.clear()
            self._cond.notify_all()
        self._fire_activity()
