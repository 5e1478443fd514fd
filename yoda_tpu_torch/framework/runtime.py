"""Framework runtime: drives plugins through the extension points.

Semantics follow the modern upstream framework runtime:
- Filter: every FilterPlugin must succeed for a node to be feasible.
- Score: each ScorePlugin's raw scores are normalized by its ``normalize``
  then summed across plugins.
- Reserve: runs in plugin order; on failure, already-reserved plugins are
  unreserved in reverse order.

The batch fast path (``BatchFilterScorePlugin``) replaces the per-node
filter/score loops with one fused computation.

Counterpart of ``yoda_tpu/framework/runtime.py``, ported as far as the
singleton path reaches it. Left out until a later slice: the Permit
waitlist (``WaitingPod``), PostFilter, the gang / joint pre-evaluation
hooks, unbind, the bind executor (``BindExecutor``) and bind tracing.
"""

from __future__ import annotations

from typing import Sequence

from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import (
    BatchFilterScorePlugin,
    BindPlugin,
    Code,
    FilterPlugin,
    Plugin,
    PreFilterPlugin,
    PreScorePlugin,
    QueueSortPlugin,
    ReservePlugin,
    ScorePlugin,
    Snapshot,
    Status,
)


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
        self.bind_plugins = [p for p in plugins if isinstance(p, BindPlugin)]

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

    # --- reserve / bind ---

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

    def run_bind(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        for p in self.bind_plugins:
            st = p.bind(state, pod, node_name)
            if st.code != Code.SKIP:
                return st
        return Status.error(f"no bind plugin bound pod {pod.key}")
