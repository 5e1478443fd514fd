"""Scheduling queue: active heaps ordered by the QueueSort plugin, with
backoff for unschedulable pods and per-tenant DRF fair queuing.

The reference supplies only the ordering function (``Less``, reference
pkg/yoda/sort/sort.go:8-18) and inherits the queue machinery (active /
backoff / unschedulable pools, event-driven re-activation) from upstream;
this module is the from-scratch equivalent of that machinery, grown a
tenant model: the active pool is sharded per tenant
(``framework/tenancy.tenant_of`` — namespace, overridable via the
``tpu/tenant`` label), and every pop draws from the LOWEST
dominant-resource-share tenant first (DRF over chips/HBM,
``TenantLedger.dominant_share``), so a flooding tenant's backlog cannot
starve anyone. Per-tenant quota admission parks over-quota entries in the
unresolvable pool with a why-pending verdict; they retire when capacity
frees (the freeing event's ``move_all_to_active`` re-admits them through a
fresh quota check). With no ``tenant_of`` hook (fairness off, the
default) everything lives under one tenant key and behavior is
bit-identical to the single-queue implementation.

Counterpart of ``yoda_tpu/framework/queue.py``, ported as far as the
singleton, gang, background and tenancy paths reach it: the per-tenant
active heaps with ``tenant_of`` / ``share_fn``, the backoff heap, the
unresolvable pool, the gang-arrival promotion, the tenant-ordered gang
gather (``pop_matching``, one quota verdict per tenant per pass,
``restore``), ``pending_gangs``, ``take_gang`` / ``readd`` (the
rebalancer's transactional move), ``find`` (the drift reconciler), the
activity signal the scheduler's drain waits on, and the hooks the overload
ladder and the SLO engine read: ``shed_fn`` / ``on_shed``, ``quota_fn`` /
``on_quota_park``, ``overload_depth``, ``tenant_wait_stats`` and the
``shed_parks`` / ``quota_parks`` counters, and ``all_entries`` (the walk
the scheduler lanes' reroute and rescue passes take), and ``close``
(which wakes a blocked ``pop`` empty-handed: a shard worker process's
shutdown).
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
        tenant_of: "Callable[[PodSpec], str] | None" = None,
        share_fn: "Callable[[str], float] | None" = None,
        quota_fn: "Callable[[str, PodSpec], str | None] | None" = None,
        on_quota_park: "Callable[[QueuedPodInfo, str], None] | None" = None,
        shed_fn: "Callable[[PodSpec], str | None] | None" = None,
        on_shed: "Callable[[QueuedPodInfo, str], None] | None" = None,
    ) -> None:
        if sort_plugin is not None:
            self._less = sort_plugin.less
        else:
            self._less = lambda a, b: a.pod.creation_seq < b.pod.creation_seq
        self._clock = clock
        # 0 = strict upstream semantics (every event move respects backoff).
        self.immediate_retry_attempts = immediate_retry_attempts
        # Tenant fair queuing (off when tenant_of is None — everything
        # shares the "" tenant and ordering is the classic single heap):
        # - tenant_of(pod): which tenant an entry bills to;
        # - share_fn(tenant): dominant resource share in [0,1] — pops
        #   draw from the LOWEST share first (DRF); missing/raising hook
        #   reads as share 0 (FIFO among tenants);
        # - quota_fn(tenant, pod): why-pending verdict when admitting the
        #   pod would exceed the tenant's quota or the overload ladder's
        #   BROWNOUT token bucket (None = admit). Verdicted entries park in
        #   the unresolvable pool and re-enter through move_all_to_active
        #   when capacity frees;
        # - on_quota_park(qpi, why): observability callback (counter +
        #   pending index). Fired under the queue lock — must not
        #   re-enter the queue.
        self._tenant_of = tenant_of
        self._share_fn = share_fn
        self._quota_fn = quota_fn
        self.on_quota_park = on_quota_park
        self.quota_parks = 0  # total entries quota-parked (metrics)
        # shed_fn(pod): why-pending message when the entry must PARK at
        # pop time instead of scheduling (the ladder's SHED level) —
        # checked per ITEM (the verdict depends on the pod's tier), into
        # the unresolvable pool so the entry requeues on the ladder's
        # step-down (an explicit move_all_to_active). on_shed(qpi, why)
        # is the observability hook, fired under the queue lock.
        self._shed_fn = shed_fn
        self.on_shed = on_shed
        self.shed_parks = 0  # lifetime shed count
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._seq = itertools.count()
        # tenant -> active heap. Fairness off: single "" key, identical
        # ordering to the pre-tenant single heap.
        self._active: dict[str, list[_HeapItem]] = {}
        self._backoff: list[tuple[float, int, QueuedPodInfo]] = []  # (ready_at, seq, qpi)
        self._unschedulable: dict[str, QueuedPodInfo] = {}  # pod key -> qpi
        self._closed = False
        # Optional listener fired (outside the queue lock) whenever work
        # arrives or parked pods are reactivated — the scheduler's
        # event-bound drain (Scheduler.run_until_idle) waits on it instead
        # of polling.
        self.on_activity: Callable[[], None] | None = None

    # --- tenant helpers ---

    def _tenant(self, pod: PodSpec) -> str:
        if self._tenant_of is None:
            return ""
        try:
            return self._tenant_of(pod)
        except Exception:  # noqa: BLE001 — a bad hook must not wedge the queue
            return ""

    def _share(self, tenant: str) -> float:
        if self._share_fn is None:
            return 0.0
        try:
            return float(self._share_fn(tenant))
        except Exception:  # noqa: BLE001
            return 0.0

    def _tenant_order(self) -> "list[str]":
        """Non-empty tenants, lowest dominant share first (name tiebreak
        for determinism). One entry when fairness is off."""
        tenants = [t for t, h in self._active.items() if h]
        if self._tenant_of is None or len(tenants) <= 1:
            return tenants
        return sorted(tenants, key=lambda t: (self._share(t), t))

    def _active_count(self) -> int:
        return sum(len(h) for h in self._active.values())

    def _active_entries(self) -> "list[QueuedPodInfo]":
        return [item.qpi for h in self._active.values() for item in h]

    # --- overload hooks ---

    def _shed(self, pod: PodSpec) -> "str | None":
        if self._shed_fn is None:
            return None
        try:
            return self._shed_fn(pod)
        except Exception:  # noqa: BLE001 — a bad hook must never wedge pops
            return None

    def _shed_park_locked(self, qpi: QueuedPodInfo, why: str) -> None:
        """Park a shed entry in the unresolvable pool (lock held): it
        re-enters on the ladder's step-down (move_all_to_active) or any
        capacity event, and re-takes the shed check at its next pop."""
        qpi.unschedulable_message = why
        self._unschedulable[qpi.pod.key] = qpi
        self.shed_parks += 1
        if self.on_shed is not None:
            try:
                self.on_shed(qpi, why)
            except Exception:  # noqa: BLE001 — observability must not wedge pops
                pass

    def _quota_park_locked(self, qpi: QueuedPodInfo, why: str) -> None:
        """Park an over-quota entry in the unresolvable pool (lock held):
        no backoff ladder — it re-enters the active queue on the next
        capacity-freeing cluster event and re-takes the quota check."""
        qpi.unschedulable_message = why
        self._unschedulable[qpi.pod.key] = qpi
        self.quota_parks += 1
        if self.on_quota_park is not None:
            try:
                self.on_quota_park(qpi, why)
            except Exception:  # noqa: BLE001 — observability must not wedge pops
                pass

    def _pop_active_locked(self) -> "QueuedPodInfo | None":
        """Next admissible entry in (tenant share, priority, FIFO) order,
        shed- and quota-parking heads along the way. Lock held."""
        while True:
            order = self._tenant_order()
            if not order:
                return None
            tenant = order[0]
            heap = self._active[tenant]
            item = heapq.heappop(heap)
            if not heap:
                del self._active[tenant]
            shed_why = self._shed(item.qpi.pod)
            if shed_why is not None:
                self._shed_park_locked(item.qpi, shed_why)
                continue
            if self._quota_fn is not None:
                why = self._quota_fn(tenant, item.qpi.pod)
                if why is not None:
                    self._quota_park_locked(item.qpi, why)
                    continue
            return item.qpi

    def overload_depth(self) -> int:
        """Entries actively contending for the serve path (active +
        backoff) — the overload monitor's queue-pressure signal. The
        parked-unresolvable pool is EXCLUDED on purpose: shed and
        quota-capped work is already parked by the ladder itself, and
        counting it would wedge the step-down that requeues it."""
        with self._lock:
            return self._active_count() + len(self._backoff)

    def tenant_wait_stats(self) -> "dict[str, tuple[int, float | None]]":
        """tenant -> (queued entries across all three pools, oldest
        ``added_unix`` on the queue clock, None when unknown) — the
        pending/starvation side of the SLO engine's SLIs. With fairness
        off everything reports under the single ``""`` tenant. One locked
        sweep, on evaluation demand only."""
        with self._lock:
            out: dict[str, tuple[int, float | None]] = {}
            entries = (
                self._active_entries()
                + [qpi for _, _, qpi in self._backoff]
                + list(self._unschedulable.values())
            )
            for qpi in entries:
                tenant = self._tenant(qpi.pod)
                n, oldest = out.get(tenant, (0, None))
                t = qpi.added_unix if qpi.added_unix > 0.0 else None
                if t is not None and (oldest is None or t < oldest):
                    oldest = t
                out[tenant] = (n + 1, oldest)
            return out

    def __len__(self) -> int:
        with self._lock:
            return (
                self._active_count() + len(self._backoff) + len(self._unschedulable)
            )

    def depths(self) -> tuple[int, int, int]:
        """(active, backoff, parked-unresolvable) pool sizes."""
        with self._lock:
            return (
                self._active_count(), len(self._backoff), len(self._unschedulable)
            )

    def pending_retry_count(self) -> int:
        """Pods that will re-enter the active queue without an external
        event (active + backoff); excludes the parked-unresolvable pool."""
        with self._lock:
            return self._active_count() + len(self._backoff)

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
        heap = self._active.setdefault(self._tenant(qpi.pod), [])
        heapq.heappush(heap, _HeapItem(qpi, next(self._seq), self._less))

    def _flush_backoff_locked(self) -> None:
        now = self._clock()
        while self._backoff and self._backoff[0][0] <= now:
            _, _, qpi = heapq.heappop(self._backoff)
            self._push_active(qpi)

    def pop(self, timeout: float | None = None) -> QueuedPodInfo | None:
        """Pop the highest-priority active pod of the lowest-share tenant;
        blocks up to ``timeout`` (forever if None) until one is available
        or the queue is closed."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                self._flush_backoff_locked()
                qpi = self._pop_active_locked()
                if qpi is not None:
                    qpi.attempts += 1
                    return qpi
                if self._closed:
                    return None
                # Wake up when the earliest backoff expires, a pod arrives,
                # or the caller's timeout passes.
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
        order — (tenant share, priority, FIFO): tenants are visited lowest
        dominant share first, so the gang gather (and therefore the joint
        pass's placement precedence) inherits DRF fairness. This is the
        gang-aware gather next to the scheduler's ``_pop_burst``: when a
        popped pod is a gang member, its co-queued siblings are pulled out
        so the whole gang runs back-to-back in one fused pass instead of
        one cycle per loop turn. Non-blocking; expired backoff entries are
        flushed first so a sibling whose retry timer just lapsed is
        gathered too.

        ``include_backoff`` additionally pulls matching entries whose
        backoff timer is STILL TICKING (appended after the active matches,
        ready-time order): a gang member's pop can fuse siblings that
        bounced into timed backoff one retry earlier, instead of leaving
        them to the gang-arrival signal or the backoff ladder.

        A matching entry whose shed verdict fires is shed-parked instead
        (per item: the verdict is tier-dependent), and over-quota tenants'
        matching entries are quota-parked, never gathered — usage only
        moves at bind time, so every member of a gang sees one consistent
        verdict within this single locked pass (one probe per tenant: the
        whole gang gathers or the whole gang parks)."""
        with self._cond:
            self._flush_backoff_locked()
            out: list[QueuedPodInfo] = []
            for tenant in self._tenant_order():
                heap = self._active.get(tenant)
                if not heap:
                    continue
                quota_why = None
                if self._quota_fn is not None:
                    probe = next(
                        (it.qpi.pod for it in heap if pred(it.qpi.pod)), None
                    )
                    if probe is not None:
                        quota_why = self._quota_fn(tenant, probe)
                t_taken: list[_HeapItem] = []
                keep: list[_HeapItem] = []
                for item in heap:
                    if not pred(item.qpi.pod):
                        keep.append(item)
                        continue
                    shed_why = self._shed(item.qpi.pod)
                    if shed_why is not None:
                        self._shed_park_locked(item.qpi, shed_why)
                    elif quota_why is not None:
                        self._quota_park_locked(item.qpi, quota_why)
                    elif limit is None or len(out) + len(t_taken) < limit:
                        t_taken.append(item)
                    else:
                        keep.append(item)
                if len(keep) != len(heap):
                    if keep:
                        heapq.heapify(keep)
                        self._active[tenant] = keep
                    else:
                        del self._active[tenant]
                t_taken.sort()  # heap-internal order -> queue order
                out.extend(item.qpi for item in t_taken)
            if include_backoff:
                still: list[tuple[float, int, QueuedPodInfo]] = []
                moved = False
                for entry in sorted(self._backoff):
                    if (limit is None or len(out) < limit) and pred(entry[2].pod):
                        shed_why = self._shed(entry[2].pod)
                        if shed_why is not None:
                            # As in the reference: the backoff heap is
                            # rebuilt only when something was taken.
                            self._shed_park_locked(entry[2], shed_why)
                        else:
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
                self._active_entries()
                + [qpi for _, _, qpi in self._backoff]
                + list(self._unschedulable.values())
            )
            for qpi in entries:
                gang = gang_name_of(qpi.pod.labels)
                if gang:
                    n, a = out.get(gang, (0, 1 << 30))
                    out[gang] = (n + 1, min(a, qpi.attempts))
            return out

    def all_entries(self) -> "list[tuple[PodSpec, int]]":
        """Every queued (pod, attempts) across the three pools (one
        locked sweep) — the shard-set's reroute pass walks this to find
        entries whose owning lane changed with the fleet, and its rescue
        pass to find work a shard has repeatedly failed to place (hand
        it to the global lane, which sees the whole fleet)."""
        with self._lock:
            out: "list[tuple[PodSpec, int]]" = [
                (qpi.pod, qpi.attempts) for qpi in self._active_entries()
            ]
            out.extend((qpi.pod, qpi.attempts) for _, _, qpi in self._backoff)
            out.extend(
                (qpi.pod, qpi.attempts)
                for qpi in self._unschedulable.values()
            )
            return out

    def find(self, uid: str) -> "PodSpec | None":
        """The queued spec for a pod uid, wherever it is parked (active /
        backoff / unresolvable) — the drift reconciler recovers the full
        object this way when it must replay a dropped deletion for a pod
        that exists nowhere else anymore."""
        with self._lock:
            for qpi in self._active_entries():
                if qpi.pod.uid == uid:
                    return qpi.pod
            for _, _, qpi in self._backoff:
                if qpi.pod.uid == uid:
                    return qpi.pod
            for qpi in self._unschedulable.values():
                if qpi.pod.uid == uid:
                    return qpi.pod
        return None

    def take_gang(self, gang: str) -> list[QueuedPodInfo]:
        """Atomically remove EVERY entry of ``gang`` from all three pools
        and return them (attempt counts untouched — no scheduling cycle
        runs on this path), in pool order: active heap, backoff heap,
        unresolvable pool. While taken, this queue cannot pop or bind the
        members: the rebalancer's move holds them while it unbinds the
        gang. Give the entries back with :meth:`readd`."""
        taken: list[QueuedPodInfo] = []
        with self._cond:
            for tenant, heap in list(self._active.items()):
                kept: list[_HeapItem] = []
                for item in heap:
                    if gang_name_of(item.qpi.pod.labels) == gang:
                        taken.append(item.qpi)
                    else:
                        kept.append(item)
                if len(kept) != len(heap):
                    if kept:
                        heapq.heapify(kept)
                        self._active[tenant] = kept
                    else:
                        del self._active[tenant]
            keep_backoff: list[tuple[float, int, QueuedPodInfo]] = []
            for entry in self._backoff:
                if gang_name_of(entry[2].pod.labels) == gang:
                    taken.append(entry[2])
                else:
                    keep_backoff.append(entry)
            if len(keep_backoff) != len(self._backoff):
                heapq.heapify(keep_backoff)
                self._backoff = keep_backoff
            for key in [
                k
                for k, q in self._unschedulable.items()
                if gang_name_of(q.pod.labels) == gang
            ]:
                taken.append(self._unschedulable.pop(key))
        return taken

    def readd(self, qpi: QueuedPodInfo) -> None:
        """Return an entry taken out of the queue without a scheduling
        cycle (:meth:`take_gang`) to the active queue untouched (unlike
        :meth:`restore`, no attempt decrement)."""
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
            for tenant, heap in list(self._active.items()):
                kept = [it for it in heap if it.qpi.pod.uid != uid]
                if len(kept) != len(heap):
                    removed = True
                    if kept:
                        heapq.heapify(kept)
                        self._active[tenant] = kept
                    else:
                        del self._active[tenant]
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

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
