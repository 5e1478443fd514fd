"""The scheduling loop: pop → cycle → reserve → bind.

The from-scratch equivalent of the upstream scheduleOne loop the reference
inherits via ``app.NewSchedulerCommand`` (reference pkg/register/register.go:10).
One scheduling cycle is serialized (as upstream).

Counterpart of ``yoda_tpu/framework/scheduler.py``, ported as far as the
singleton path reaches it: ``schedule_one``, the multi-pod burst pop and
``run_until_idle``, with no metrics registry and no tracer. Left out until
a later slice: Permit waits and the gang gather / joint pass, PostFilter
preemption and nominations, the speculative placement cache, shard
staging and commits, leader fencing, the bind executor and
``serve_forever``.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

log = logging.getLogger("yoda_tpu_torch.scheduler")

from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import (
    Code,
    MAX_NODE_SCORE,
    Snapshot,
    summarize_failure,
)
from yoda_tpu_torch.framework.queue import QueuedPodInfo, SchedulingQueue
from yoda_tpu_torch.framework.runtime import Framework


@dataclass
class ScheduleResult:
    pod_key: str
    outcome: str  # "bound" | "unschedulable" | "error" | "gone"
    node: str | None = None
    message: str = ""
    latency_s: float = 0.0
    # Cycle-completion instant on the scheduler's clock.
    completed_at: float = 0.0


@dataclass
class SchedulerStats:
    results: list[ScheduleResult] = field(default_factory=list)
    binds: int = 0


class Scheduler:
    def __init__(
        self,
        framework: Framework,
        snapshot_fn: Callable[[], Snapshot],
        queue: SchedulingQueue,
        *,
        clock: Callable[[], float] = time.monotonic,
        on_bound: Callable[[PodSpec, str], None] | None = None,
        on_unschedulable: Callable[[PodSpec, str], None] | None = None,
        cycle_lock: "threading.Lock | None" = None,
        pod_alive: Callable[[PodSpec], bool] | None = None,
        burst_size: int = 1,
    ) -> None:
        self.framework = framework
        self.snapshot_fn = snapshot_fn
        self.queue = queue
        self.clock = clock
        self.stats = SchedulerStats()
        self.on_bound = on_bound
        self.on_unschedulable = on_unschedulable
        self.cycle_lock = cycle_lock or threading.Lock()
        self.pod_alive = pod_alive
        # Multi-pod fused dispatch (config batch_requests): pop up to this
        # many queue entries at once and pre-evaluate them in ONE kernel
        # call (Framework.prepare_burst); each entry still runs its own
        # full scheduling cycle, served from the burst cache.
        self.burst_size = max(burst_size, 1)
        self._lock = threading.Lock()

    # --- one pod ---

    def schedule_one(self, qpi: QueuedPodInfo) -> ScheduleResult:
        with self.cycle_lock:
            return self._schedule_one_locked(qpi)

    def _schedule_one_locked(self, qpi: QueuedPodInfo) -> ScheduleResult:
        pod = qpi.pod
        t0 = self.clock()

        def done(
            outcome: str,
            node: str | None = None,
            message: str = "",
            *,
            unresolvable: bool = False,
        ) -> ScheduleResult:
            now = self.clock()
            r = ScheduleResult(
                pod.key, outcome, node, message, now - t0, completed_at=now
            )
            if outcome == "bound":
                log.info("bound %s -> %s (%.1f ms)", pod.key, node, r.latency_s * 1e3)
            elif outcome == "unschedulable":
                log.info("unschedulable %s: %s", pod.key, message)
            elif outcome == "error":
                log.warning("error scheduling %s: %s", pod.key, message)
            with self._lock:
                self.stats.results.append(r)
            if outcome == "unschedulable":
                if unresolvable:
                    self.queue.park_unresolvable(qpi, message)
                else:
                    self.queue.add_unschedulable(qpi, message)
                if self.on_unschedulable:
                    self.on_unschedulable(pod, message)
            elif outcome == "error":
                # Errors are RETRYABLE, not terminal: a kernel-dispatch or
                # plugin exception must not silently drop the pod.
                self.queue.add_unschedulable(qpi, message)
                if self.on_unschedulable:
                    self.on_unschedulable(pod, message)
            return r

        # A pod deleted (or already bound, or gated) while queued is dropped.
        if self.pod_alive is not None and not self.pod_alive(pod):
            return done("gone")
        if pod.scheduling_gates:
            return done(
                "unschedulable",
                message="pod has scheduling gates; not ready to schedule",
                unresolvable=True,
            )
        state = CycleState()
        snapshot = self.snapshot_fn()
        st = self.framework.run_pre_filter(state, pod, snapshot)
        if not st.success:
            return done(
                "unschedulable",
                message=st.message,
                unresolvable=st.code == Code.UNSCHEDULABLE_AND_UNRESOLVABLE,
            )

        try:
            batch = self.framework.run_batch_filter_score(state, pod, snapshot)
        except Exception as e:  # noqa: BLE001 — keep the loop serving
            log.exception("batch filter/score failed for %s", pod.key)
            return done("error", message=f"batch filter/score failed: {e}")
        if batch is None:
            return done(
                "error", message="no batch filter/score plugin is registered"
            )
        statuses, batch_scores = batch
        feasible = sorted(batch_scores)
        if not feasible:
            return done("unschedulable", message=summarize_failure(statuses))

        st = self.framework.run_pre_score(state, pod, snapshot, feasible)
        totals: dict[str, int] = {}
        if st.success:
            totals, st = self.framework.run_scores(state, pod, snapshot, feasible)
        if not st.success:
            return done("error", message=st.message)
        if self.framework.score_plugins:
            # Combining with per-node plugins: bring the batch total onto
            # the same [0,100] scale.
            normalized = _normalize(batch_scores)
            for n in feasible:
                totals[n] = totals.get(n, 0) + normalized[n]
        else:
            # Batch is the only scorer: its scores are already
            # normalized+tiered; re-normalizing would only quantize away
            # within-tier ordering.
            totals = dict(batch_scores)
        best = max(feasible, key=lambda n: (totals.get(n, 0), n))

        st = self.framework.run_reserve(state, pod, best)
        if not st.success:
            return done("unschedulable", node=best, message=st.message)
        st = self.framework.run_bind(state, pod, best)
        if not st.success:
            self.framework.run_unreserve(state, pod, best)
            return done("unschedulable", node=best, message=st.message)
        with self._lock:
            self.stats.binds += 1
        if self.on_bound:
            self.on_bound(pod, best)
        # Cluster changed: retry parked pods (skipped when nothing parked).
        if self.queue.has_parked():
            self.queue.move_all_to_active()
        return done("bound", node=best)

    # --- the loop ---

    def _pop_burst(self, first: QueuedPodInfo) -> list[QueuedPodInfo]:
        """Pop up to burst_size - 1 further entries and pre-evaluate the
        whole batch in one kernel dispatch. Always returns at least
        ``[first]``; scheduling still happens one full cycle per entry."""
        batch = [first]
        if self.burst_size <= 1 or not self.framework.supports_burst:
            return batch
        while len(batch) < self.burst_size:
            nxt = self.queue.pop(timeout=0.0)
            if nxt is None:
                break
            batch.append(nxt)
        if len(batch) > 1:
            try:
                self.framework.prepare_burst(
                    [q.pod for q in batch], self.snapshot_fn()
                )
            except Exception:  # noqa: BLE001 — advisory only
                # A failed prepare must never lose the popped entries —
                # they schedule individually below.
                log.exception("burst pre-evaluation failed; scheduling individually")
        return batch

    def run_until_idle(self, *, max_wall_s: float = 30.0) -> None:
        """Drain the queue until no active work remains or ``max_wall_s``
        passes. Test/demo entry point."""
        deadline = time.monotonic() + max_wall_s
        binds_at_drain = -1  # binds count when the queue last went inactive
        while time.monotonic() < deadline:
            qpi = self.queue.pop(timeout=0.0)
            if qpi is not None:
                for q in self._pop_burst(qpi):
                    self.schedule_one(q)
                continue
            if self.queue.pending_retry_count() == 0:
                return
            # Only backoff pods remain. Retrying them is useful only if the
            # cluster changed (a bind) since their last attempt; otherwise
            # this is a fixed point — leave them to the event-driven path.
            if self.stats.binds == binds_at_drain:
                return
            binds_at_drain = self.stats.binds
            self.queue.move_all_to_active(force=True)


def _normalize(scores: dict[str, int]) -> dict[str, int]:
    """Min-max rescale to [0, MAX_NODE_SCORE] — parity with the reference's
    NormalizeScore including the all-equal guard (reference
    pkg/yoda/scheduler.go:136-144)."""
    if not scores:
        return {}
    lowest, highest = min(scores.values()), max(scores.values())
    if highest == lowest:
        lowest -= 1
    return {
        n: (s - lowest) * MAX_NODE_SCORE // (highest - lowest) for n, s in scores.items()
    }
