"""Scheduling queue: active heap ordered by the QueueSort plugin, with
backoff for unschedulable pods.

The reference supplies only the ordering function (``Less``, reference
pkg/yoda/sort/sort.go:8-18) and inherits the queue machinery (active /
backoff / unschedulable pools, event-driven re-activation) from upstream;
this module is the from-scratch equivalent of that machinery.

Counterpart of ``yoda_tpu/framework/queue.py``, ported as far as the
singleton path reaches it: one tenant-blind active heap, the backoff heap
and the unresolvable pool. Left out until a later slice: per-tenant DRF
fair queuing and quota parking, the overload shed hook, the gang-arrival
promotion and the gang gather / spillover surfaces (``pop_matching``,
``take_gang``, ``readd``, ``pending_gangs``).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable

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
            self._cond.notify()

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
