"""Framework runtime: drives plugins through the extension points and owns
the Permit waitlist.

Semantics follow the modern upstream framework runtime:
- Filter: every FilterPlugin must succeed for a node to be feasible.
- Score: each ScorePlugin's raw scores are normalized by its ``normalize``
  then summed across plugins.
- Reserve: runs in plugin order; on failure, already-reserved plugins are
  unreserved in reverse order.
- Permit: any WAIT parks the pod on the waitlist; approval requires every
  waiting plugin to allow; rejection or timeout unreserves.

The batch fast path (``BatchFilterScorePlugin``) replaces the per-node
filter/score loops with one fused computation.

Counterpart of ``yoda_tpu/framework/runtime.py``, ported as far as the
singleton and gang paths reach it: the Permit waitlist (``WaitingPod``,
expiry and cancellation), the gang-fused and joint pre-evaluation hooks
and unbind. Left out until a later slice: PostFilter and the per-node
filter loop (preemption, loop mode), the bind executor (``BindExecutor``,
so every bind runs inline on the scheduling thread) and bind tracing.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import (
    BatchFilterScorePlugin,
    BindPlugin,
    Code,
    FilterPlugin,
    PermitPlugin,
    Plugin,
    PreFilterPlugin,
    PreScorePlugin,
    QueueSortPlugin,
    ReservePlugin,
    ScorePlugin,
    Snapshot,
    Status,
)


class WaitingPod:
    """A pod parked at Permit (gang members wait here until the gang is
    complete). Thread-safe; resolution fires ``on_resolved`` exactly once."""

    def __init__(
        self,
        pod: PodSpec,
        node_name: str,
        state: CycleState,
        pending_plugins: set[str],
        deadline: float,
        on_resolved: Callable[["WaitingPod", Status], None],
    ) -> None:
        self.pod = pod
        self.node_name = node_name
        self.state = state
        self.deadline = deadline
        self._pending = set(pending_plugins)
        self._on_resolved = on_resolved
        self._lock = threading.Lock()
        self._resolved: Status | None = None

    def allow(self, plugin_name: str) -> None:
        fire = False
        with self._lock:
            if self._resolved is not None:
                return
            self._pending.discard(plugin_name)
            if not self._pending:
                self._resolved = Status.ok()
                fire = True
        if fire:
            self._on_resolved(self, Status.ok())

    def reject(self, message: str) -> None:
        with self._lock:
            if self._resolved is not None:
                return
            self._resolved = Status.unschedulable(message)
        self._on_resolved(self, Status.unschedulable(message))


class Framework:
    def __init__(self, plugins: Sequence[Plugin]) -> None:
        self.queue_sort = next(
            (p for p in plugins if isinstance(p, QueueSortPlugin)), None
        )
        self.pre_filter_plugins = [p for p in plugins if isinstance(p, PreFilterPlugin)]
        self.filter_plugins = [p for p in plugins if isinstance(p, FilterPlugin)]
        self.pre_score_plugins = [p for p in plugins if isinstance(p, PreScorePlugin)]
        self.score_plugins = [p for p in plugins if isinstance(p, ScorePlugin)]
        self.batch_plugins = [p for p in plugins if isinstance(p, BatchFilterScorePlugin)]
        self.reserve_plugins = [p for p in plugins if isinstance(p, ReservePlugin)]
        self.permit_plugins = [p for p in plugins if isinstance(p, PermitPlugin)]
        self.bind_plugins = [p for p in plugins if isinstance(p, BindPlugin)]
        self._waiting: dict[str, WaitingPod] = {}
        self._waiting_lock = threading.Lock()

    # --- filter / score ---

    def run_pre_filter(self, state: CycleState, pod: PodSpec, snapshot: Snapshot) -> Status:
        for p in self.pre_filter_plugins:
            st = p.pre_filter(state, pod, snapshot)
            if not st.success and st.code != Code.SKIP:
                return st
        return Status.ok()

    @property
    def supports_burst(self) -> bool:
        """True when some batch plugin can pre-evaluate a multi-pod burst
        (YodaBatch.prepare_burst)."""
        return any(hasattr(p, "prepare_burst") for p in self.batch_plugins)

    def prepare_burst(self, pods: Sequence[PodSpec], snapshot: Snapshot) -> None:
        """Hand the next K pending pods to burst-capable batch plugins: one
        kernel dispatch evaluates them all, and their individual scheduling
        cycles are then served from the cached rows. Purely advisory — a
        plugin may decline, and cycles fall back to individual dispatches."""
        for p in self.batch_plugins:
            prepare = getattr(p, "prepare_burst", None)
            if prepare is not None:
                prepare(pods, snapshot)

    def prepare_gang(self, pods: Sequence[PodSpec], snapshot: Snapshot) -> None:
        """Hand a gathered gang (every co-queued member, one gang) to
        gang-burst-capable batch plugins: ONE kernel dispatch evaluates all
        members, and each member's cycle is served from its own row with
        the chips claimed by earlier members deducted
        (YodaBatch.prepare_gang_burst). Advisory, like prepare_burst —
        member cycles fall back to per-cycle dispatches / the gang plan."""
        for p in self.batch_plugins:
            prepare = getattr(p, "prepare_gang_burst", None)
            if prepare is not None:
                prepare(pods, snapshot)

    def prepare_joint(
        self,
        groups: "Sequence[Sequence[PodSpec]]",
        snapshot: Snapshot,
    ) -> "list[str] | None":
        """Hand SEVERAL gathered gangs (one group per gang, priority
        order) to joint-capable batch plugins: ONE kernel dispatch
        evaluates every member of every gang, and each gang's cycles are
        served net of the claims of higher-priority gangs in the same
        dispatch (YodaBatch.prepare_joint_burst). Returns the first
        capable plugin's per-group verdicts — "fused" (drive the members
        this turn), "solo" (schedule per-cycle), "park" (cannot fit
        whole; restore untouched) — or None when no plugin can run a
        joint pass (the scheduler then falls back to per-gang passes)."""
        for p in self.batch_plugins:
            prepare = getattr(p, "prepare_joint_burst", None)
            if prepare is not None:
                return prepare(groups, snapshot)
        return None

    def run_batch_filter_score(
        self, state: CycleState, pod: PodSpec, snapshot: Snapshot
    ) -> tuple[dict[str, Status], dict[str, int]] | None:
        """Fused fast path; None when no batch plugin is registered. Regular
        FilterPlugins still run, but only over the batch-feasible subset."""
        if not self.batch_plugins:
            return None
        if len(self.batch_plugins) == 1:
            # The plugin's dicts are used directly (the batch contract hands
            # ownership to the caller — plugins must return fresh dicts).
            statuses, totals = self.batch_plugins[0].filter_and_score_batch(
                state, pod, snapshot
            )
            for n in snapshot.names():
                if n not in statuses:
                    statuses[n] = Status.ok()
                    totals.setdefault(n, 0)
        else:
            statuses = {n: Status.ok() for n in snapshot.names()}
            totals = {n: 0 for n in snapshot.names()}
            for p in self.batch_plugins:
                p_statuses, p_scores = p.filter_and_score_batch(
                    state, pod, snapshot
                )
                for n, st in p_statuses.items():
                    if not st.success and statuses[n].success:
                        statuses[n] = st
                for n, s in p_scores.items():
                    totals[n] += s
        for n, st in statuses.items():
            if not st.success:
                continue
            for p in self.filter_plugins:
                st2 = p.filter(state, pod, snapshot.get(n))
                if not st2.success:
                    statuses[n] = st2
                    break
        feasible_scores = {
            n: totals.get(n, 0) for n, st in statuses.items() if st.success
        }
        return statuses, feasible_scores

    def run_pre_score(
        self, state: CycleState, pod: PodSpec, snapshot: Snapshot, feasible: Sequence[str]
    ) -> Status:
        for p in self.pre_score_plugins:
            st = p.pre_score(state, pod, snapshot, feasible)
            if not st.success and st.code != Code.SKIP:
                return st
        return Status.ok()

    def run_scores(
        self, state: CycleState, pod: PodSpec, snapshot: Snapshot, feasible: Sequence[str]
    ) -> tuple[dict[str, int], Status]:
        totals: dict[str, int] = {n: 0 for n in feasible}
        for p in self.score_plugins:
            raw: dict[str, int] = {}
            for n in feasible:
                s, st = p.score(state, pod, snapshot.get(n))
                if not st.success:
                    return {}, st
                raw[n] = s
            st = p.normalize(state, pod, raw)
            if not st.success:
                return {}, st
            for n, s in raw.items():
                totals[n] += s
        return totals, Status.ok()

    # --- reserve / permit / bind ---

    def run_reserve(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        done: list[ReservePlugin] = []
        for p in self.reserve_plugins:
            st = p.reserve(state, pod, node_name)
            if not st.success:
                for q in reversed(done):
                    q.unreserve(state, pod, node_name)
                return st
            done.append(p)
        return Status.ok()

    def run_unreserve(self, state: CycleState, pod: PodSpec, node_name: str) -> None:
        for p in reversed(self.reserve_plugins):
            p.unreserve(state, pod, node_name)

    def run_permit(
        self,
        state: CycleState,
        pod: PodSpec,
        node_name: str,
        on_resolved: Callable[[WaitingPod, Status], None],
        *,
        now: float | None = None,
    ) -> Status:
        """Runs Permit plugins. On WAIT, registers a WaitingPod and returns
        WAIT; ``on_resolved`` fires (possibly re-entrantly from a later
        permit call) once it is allowed/rejected."""
        waiting_plugins: set[str] = set()
        max_timeout = 0.0
        for p in self.permit_plugins:
            st, timeout = p.permit(state, pod, node_name)
            if st.code == Code.WAIT:
                waiting_plugins.add(p.name)
                max_timeout = max(max_timeout, timeout)
            elif not st.success:
                return st
        if not waiting_plugins:
            return Status.ok()
        now = time.monotonic() if now is None else now
        wp = WaitingPod(
            pod,
            node_name,
            state,
            waiting_plugins,
            deadline=now + max_timeout,
            on_resolved=lambda w, s: self._finish_waiting(w, s, on_resolved),
        )
        with self._waiting_lock:
            self._waiting[pod.key] = wp
        # A permit plugin may have been waiting for exactly this pod (last
        # gang member): give plugins a chance to flush now it is registered.
        for p in self.permit_plugins:
            post = getattr(p, "on_pod_waiting", None)
            if post is not None:
                post(self, wp)
        return Status.wait()

    def _finish_waiting(
        self, wp: WaitingPod, status: Status, cb: Callable[[WaitingPod, Status], None]
    ) -> None:
        with self._waiting_lock:
            self._waiting.pop(wp.pod.key, None)
        # Permit plugins observe resolutions first (gang bookkeeping and
        # cascade rollback), then the scheduler binds or unreserves.
        for p in self.permit_plugins:
            hook = getattr(p, "on_pod_resolved", None)
            if hook is not None:
                hook(self, wp, status)
        cb(wp, status)

    def waiting_pods(self) -> list[WaitingPod]:
        with self._waiting_lock:
            return list(self._waiting.values())

    def get_waiting_pod(self, pod_key: str) -> WaitingPod | None:
        with self._waiting_lock:
            return self._waiting.get(pod_key)

    def cancel_waiting(self, pod_key: str, message: str) -> bool:
        """Reject ONE waiting pod by key, if present — the delete-event
        fast path cancels a deleted pod's Permit wait immediately instead
        of letting it eat the full timeout (its gang cascade then releases
        every sibling's reservation). Returns whether a wait was actually
        cancelled."""
        wp = self.get_waiting_pod(pod_key)
        if wp is None:
            return False
        wp.reject(message)
        return True

    def expire_waiting(self, *, now: float | None = None) -> int:
        """Reject waiting pods past their Permit deadline. Returns count."""
        now = time.monotonic() if now is None else now
        expired = [w for w in self.waiting_pods() if now >= w.deadline]
        for w in expired:
            w.reject(f"permit wait timed out for pod {w.pod.key}")
        return len(expired)

    def run_bind(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        for p in self.bind_plugins:
            st = p.bind(state, pod, node_name)
            if st.code != Code.SKIP:
                return st
        return Status.error(f"no bind plugin bound pod {pod.key}")

    def run_unbind(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        """Reverse a landed bind (transactional gang rollback): the first
        bind plugin implementing ``unbind`` handles it. An error status —
        including no plugin implementing it — means the pod may be
        stranded bound; the caller logs it and the watch stream remains
        the source of truth."""
        for p in self.bind_plugins:
            unbind = getattr(p, "unbind", None)
            if unbind is not None:
                st = unbind(state, pod, node_name)
                if st.code != Code.SKIP:
                    return st
        return Status.error(f"no bind plugin can unbind pod {pod.key}")
