"""The scheduling loop: pop → cycle → reserve → permit → bind.

The from-scratch equivalent of the upstream scheduleOne loop the reference
inherits via ``app.NewSchedulerCommand`` (reference pkg/register/register.go:10).
One scheduling cycle is serialized (as upstream); Permit waits do NOT block
the loop — waiting pods park on the framework waitlist and are bound from
the resolution callback (gang scheduling).

Counterpart of ``yoda_tpu/framework/scheduler.py``, ported as far as the
singleton and gang paths reach it: ``schedule_one`` with the Permit step,
the multi-pod burst pop, the gang gather and cross-gang joint pass
(``_gather_gangs``), the transactional gang rollback (``_rollback_bound``)
and the event-bound ``run_until_idle`` with permit expiry — with no metrics
registry and no tracer. Left out until a later slice: PostFilter
preemption and nominations, the speculative placement cache, shard
staging and commits, leader fencing, the bind executor (every bind runs
inline, so a gang's rollback needs no completion barrier) and
``serve_forever``.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

log = logging.getLogger("yoda_tpu_torch.scheduler")

from yoda_tpu_torch.api.requests import gang_name_of
from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import (
    Code,
    MAX_NODE_SCORE,
    Snapshot,
    Status,
    summarize_failure,
)
from yoda_tpu_torch.framework.queue import QueuedPodInfo, SchedulingQueue
from yoda_tpu_torch.framework.runtime import Framework, WaitingPod


@dataclass
class ScheduleResult:
    pod_key: str
    outcome: str  # "bound" | "waiting" | "unschedulable" | "error" | "gone"
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
        # full scheduling cycle, served from the burst cache. The gang
        # gather (_gather_gangs) extends the same bounded-inversion
        # promise: popping one gang member pulls its co-queued siblings.
        self.burst_size = max(burst_size, 1)
        # Event-bound drain (run_until_idle): permit resolutions and queue
        # activity bump _activity_seq and wake the waiter, so drain latency
        # tracks the event, not a poll interval.
        self._activity = threading.Condition()
        self._activity_seq = 0
        queue.on_activity = self._signal_activity
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
            elif outcome == "waiting":
                log.debug("pod %s waiting at permit on %s", pod.key, node)
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

        st = self.framework.run_permit(
            state, pod, best, self._on_permit_resolved, now=self.clock()
        )
        if st.code == Code.WAIT:
            return done("waiting", node=best)
        if not st.success:
            self.framework.run_unreserve(state, pod, best)
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

    # --- permit resolution and the transactional gang rollback ---

    def _signal_activity(self) -> None:
        with self._activity:
            self._activity_seq += 1
            self._activity.notify_all()

    def _on_permit_resolved(self, wp: WaitingPod, status: Status) -> None:
        """Fires when a waiting pod is allowed (bind it) or rejected (roll
        back its reservation and requeue), then signals the drain
        condition — AFTER the bind, requeue and rollbacks landed, so a
        woken ``run_until_idle`` never observes the half-resolved state."""
        try:
            self._do_permit_resolved(wp, status)
        finally:
            self._signal_activity()

    def _do_permit_resolved(self, wp: WaitingPod, status: Status) -> None:
        pod = wp.pod
        if status.success:
            st = self.framework.run_bind(wp.state, pod, wp.node_name)
            if st.success:
                self._confirm_bound(wp)
                log.info("bound %s -> %s (permit released)", pod.key, wp.node_name)
                with self._lock:
                    self.stats.binds += 1
                if self.on_bound:
                    self.on_bound(pod, wp.node_name)
                if self.queue.has_parked():  # see the bind path: skip empty sweeps
                    self.queue.move_all_to_active()
                return
            self._handle_bind_failure(wp, st)
            status = st
        log.info(
            "permit rejected %s on %s: %s", pod.key, wp.node_name, status.message
        )
        self.framework.run_unreserve(wp.state, pod, wp.node_name)
        self.queue.add_unschedulable(QueuedPodInfo(pod=pod), status.message)
        if self.on_unschedulable:
            self.on_unschedulable(pod, status.message)

    def _confirm_bound(self, wp: WaitingPod) -> None:
        """Let Permit plugins observe a landed permit-release bind
        (transactional gang bookkeeping: a later sibling's bind failure
        rolls it back)."""
        for p in self.framework.permit_plugins:
            hook = getattr(p, "on_pod_bound", None)
            if hook is not None:
                hook(self.framework, wp)

    def _handle_bind_failure(self, wp: WaitingPod, st: Status) -> None:
        """A permit-released bind failed after the binder's transient
        retries: Permit plugins make the failure TRANSACTIONAL — the gang
        plugin rejects still-waiting members (the cascade releases their
        reservations) and hands back the siblings whose binds already
        landed, which are unbound, unreserved and requeued here. Every
        bind runs inline on this thread, so the landed set is final when
        the hook returns. The failing member itself goes through the
        caller's standard rejection path."""
        for p in self.framework.permit_plugins:
            hook = getattr(p, "on_bind_failed", None)
            if hook is None:
                continue
            for spec, node, why in hook(self.framework, wp, st) or ():
                self._rollback_bound(spec, node, None, why)

    def _rollback_bound(
        self, pod: PodSpec, node_name: str, state, why: str
    ) -> None:
        """Undo a LANDED bind (transactional gang rollback): unbind via the
        bind plugins, release the reservation, requeue the pod untouched.
        An unbind the backend cannot perform is logged — the watch stream
        stays the source of truth and the pod keeps its membership."""
        state = state if state is not None else CycleState()
        st = self.framework.run_unbind(state, pod, node_name)
        if not st.success:
            # The pod REMAINS bound on the cluster: keep its reservation
            # (a bound pod holds its chips) and restore its membership so
            # the gang completes AROUND it when the rolled-back siblings
            # requeue.
            log.error(
                "gang rollback could not unbind %s from %s (%s); pod "
                "remains bound — restoring its gang membership",
                pod.key, node_name, st.message,
            )
            for p in self.framework.permit_plugins:
                hook = getattr(p, "on_unbind_failed", None)
                if hook is not None:
                    hook(self.framework, pod, node_name)
            return
        self.framework.run_unreserve(state, pod, node_name)
        log.warning("rolled back bind of %s on %s: %s", pod.key, node_name, why)
        self.queue.add_unschedulable(QueuedPodInfo(pod=pod), why)
        if self.on_unschedulable:
            self.on_unschedulable(pod, why)

    # --- the loop ---

    def _pop_batch(self, first: QueuedPodInfo) -> list[QueuedPodInfo]:
        """Expand one popped entry into the batch this loop turn schedules:
        a gang member gathers every co-queued gang (cross-gang joint
        pass), any other pod gathers a multi-pod burst."""
        if gang_name_of(first.pod.labels):
            return self._gather_gangs(first)
        return self._pop_burst(first)

    def _gather_gangs(self, first: QueuedPodInfo) -> list[QueuedPodInfo]:
        """Cross-gang joint scheduling pass: pull EVERY co-queued gang
        member — ``first``'s own siblings and members of other gangs — out
        of the queue (still-ticking backoff siblings of the gathered gangs
        included, so a fuse happens one retry earlier), group them by gang
        in priority order, and evaluate all groups in ONE kernel dispatch
        (``Framework.prepare_joint`` -> YodaBatch.prepare_joint_burst).
        Every fully-placed gang then drives reserve -> permit -> bind
        back-to-back in this same loop turn — the Permit barrier resolves
        inside each gang's last member's cycle, and a later gang's members
        are served net of the earlier gangs' claims. A gang the joint plan
        cannot fit WHOLE is restored to the queue untouched (no
        reservations, no attempt charged); its own later pop runs the
        normal admission path. Priority order is preserved across gangs,
        and the inversion window for a higher-priority singleton stays
        bounded by the gathered gangs' total size."""
        first_name = gang_name_of(first.pod.labels)
        groups: "dict[str, list[QueuedPodInfo]]" = {first_name: [first]}
        for q in self.queue.pop_matching(
            lambda p: gang_name_of(p.labels) is not None
        ):
            groups.setdefault(gang_name_of(q.pod.labels), []).append(q)
        # Satellite gather: siblings of the gathered gangs still ticking
        # down backoff fuse now instead of one retry later.
        names = set(groups)
        for q in self.queue.pop_matching(
            lambda p: gang_name_of(p.labels) in names, include_backoff=True
        ):
            groups[gang_name_of(q.pod.labels)].append(q)
        snapshot = self.snapshot_fn()
        if len(groups) == 1:
            batch = groups[first_name]
            if len(batch) > 1:
                try:
                    self.framework.prepare_gang([q.pod for q in batch], snapshot)
                except Exception:  # noqa: BLE001 — advisory only
                    # Members still schedule back-to-back below, falling
                    # to per-cycle dispatches / the gang plan.
                    log.exception(
                        "gang pre-evaluation failed; scheduling members "
                        "individually"
                    )
            return batch
        ordered = list(groups.items())
        verdicts = None
        try:
            verdicts = self.framework.prepare_joint(
                [[q.pod for q in g] for _, g in ordered], snapshot
            )
        except Exception:  # noqa: BLE001 — advisory only
            # Every gang still schedules back-to-back below through the
            # per-gang machinery (plans / fresh dispatches).
            log.exception(
                "joint gang pre-evaluation failed; scheduling gangs per-gang"
            )
        if verdicts is None:
            return [q for _, g in ordered for q in g]
        batch: list[QueuedPodInfo] = []
        for i, ((name, g), verdict) in enumerate(zip(ordered, verdicts)):
            if verdict == "park" and i > 0:
                # All-or-nothing without churn: the joint plan proved the
                # gang cannot place whole net of the gangs ahead of it —
                # back to the queue untouched. Never the FIRST group: its
                # pop must always progress (to a bind or an admission
                # park), or a re-pop would loop on the same verdict.
                log.debug(
                    "gang %s: does not fit the joint plan; restored "
                    "untouched (%d member(s))", name, len(g),
                )
                for q in g:
                    self.queue.restore(q)
            else:
                batch.extend(g)
        return batch

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
            if gang_name_of(nxt.pod.labels):
                # A gang member must enter through the gang gather, not
                # ride a singleton burst one cycle at a time: un-pop it and
                # stop here — its own pop next loop turn runs the fused
                # gang pass.
                self.queue.restore(nxt)
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

    # Ceiling on one event-bound drain wait: signals wake the waiter
    # immediately, so this bounds only the unsignaled cases (fake clocks
    # skewing permit deadlines, resolutions on paths that cannot signal).
    DRAIN_WAIT_CAP_S = 0.05

    def run_until_idle(self, *, max_wall_s: float = 30.0) -> None:
        """Drain the queue, resolving Permit waits and expirations, until no
        active work remains or ``max_wall_s`` passes. Test/demo entry point.

        Event-bound: while Permit waiters exist the loop sleeps on the
        activity condition — woken by permit resolutions and queue activity
        (adds, event reactivations) — with a timeout no later than the
        earliest permit deadline, so expiry still fires on time."""
        deadline = time.monotonic() + max_wall_s
        binds_at_drain = -1  # binds count when the queue last went inactive
        while time.monotonic() < deadline:
            with self._activity:
                seq = self._activity_seq  # pre-check capture: a resolution
                # landing between the checks below and the wait bumps the
                # seq and turns the wait into a no-op (no lost wakeup).
            qpi = self.queue.pop(timeout=0.0)
            if qpi is not None:
                for q in self._pop_batch(qpi):
                    self.schedule_one(q)
                continue
            self.framework.expire_waiting(now=self.clock())
            waiters = self.framework.waiting_pods()
            if waiters:
                now = self.clock()
                timeout = max(
                    min(
                        min(w.deadline for w in waiters) - now,
                        deadline - time.monotonic(),
                        self.DRAIN_WAIT_CAP_S,
                    ),
                    0.0,
                )
                with self._activity:
                    if self._activity_seq == seq:
                        self._activity.wait(timeout)
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
