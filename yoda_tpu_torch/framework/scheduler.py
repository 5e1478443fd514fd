"""The scheduling loop: pop → cycle → reserve → permit → bind.

The from-scratch equivalent of the upstream scheduleOne loop the reference
inherits via ``app.NewSchedulerCommand`` (reference pkg/register/register.go:10).
One scheduling cycle is serialized (as upstream); Permit waits do NOT block
the loop — waiting pods park on the framework waitlist and are bound from
the resolution callback (gang scheduling).

Counterpart of ``yoda_tpu/framework/scheduler.py``, ported as far as the
singleton, gang, preemption and background paths reach it:
``schedule_one`` with the Permit step, the speculative placement cache's
consume chain (lookup -> leader fence -> epoch check -> spot check ->
consume -> Reserve, falling through to the full path on any miss),
PostFilter preemption at both of its call sites (a PreFilter rejection
that is not unresolvable, and no feasible node) with the "nominated"
outcome and the nomination status patch (``on_nominated``, cleared when
the pod binds elsewhere), the multi-pod burst pop, the gang gather and
cross-gang joint pass (``_gather_gangs``), the transactional gang
rollback (``_rollback_bound``), the leader fence (``fence_fn`` /
``_fenced``: a fenced scheduler aborts binds before the API write) and
the event-bound ``run_until_idle`` with permit expiry, and the
observability the reference feeds from its ``metrics`` (a
``SchedulingMetrics``): the per-phase ``PhaseTimer`` spans (prefilter,
spec, filter, score, reserve, permit, postfilter) into
``yoda_scheduling_latency_seconds{phase}`` with the whole cycle as
``phase="total"``, ``attempts{result}``, the ``TraceEntry`` ring, binds,
fenced binds, gang Permit waits, transactional rollbacks, the SLO
engine's bound edge at both bind sites, the why-pending records and
resolutions, and the cycle / permit-park / bound / permit-rejected /
gather / joint-park spans. As in the reference, the cycle lock is
released before PostFilter: preemption's victim selection takes the same
lock. Beyond the reference (``observability.PORT_ONLY_OBSERVABLES``): a
prepared burst is timed as ``phase="burst"`` with one ``burst`` span,
a fused evaluation's ``filter`` is split into ``filter_burst_row`` and
``filter_dispatch`` by what served the cycle, and each loop turn that
popped work adds its wall and on-CPU seconds to
``yoda_serve_busy_seconds_total``.

The bind pipeline and the production loop are here too: with a
``bind_executor`` wired, a gang's release fans its member binds out on the
executor's workers and the loop goes on to the next turn while they are in
flight (``yoda_overlap_cycles_total`` counts such turns, in both
``run_until_idle`` and ``serve_forever``); every settle signals the drain
condition (``bind_executor.on_settled``), ``run_until_idle`` treats
in-flight binds as active work (the drain barrier), and the landed binds
of a gang whose bind failed are unwound only once the whole release has
settled (``_flush_deferred_rollbacks`` over the gang plugin's
``collect_rollbacks``). ``serve_forever`` blocks on the queue, parks while
fenced (permit expiry still sweeps) and runs ``on_serve_start`` (the
reconciler's warm-start resync) once, after the fence first admits
leadership and before the first pop. Loop mode is here as well: without a
batch plugin a cycle runs the per-node filter chain
(``Framework.run_filters``) over a search window that
``percentage_nodes_to_score`` caps, from a rotating origin, then PreScore
and the per-node Score plugins. A scheduler lane (``shard`` set by the
sharded assembly) tags its cycles so the shared accountant STAGES their
claims, validates a singleton's claim at ``commit_fn`` before its bind
write and a gang's landed cohort after its last bind
(``_flush_shard_commits``, rolling the gang back whole on a conflict and
counting ``yoda_shard_commit_rollbacks_total``); ``retire`` fences a lane
a live resize dissolved for good and ends its serve loop.
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
from yoda_tpu_torch.framework.cyclestate import (
    FILTER_PATH_KEY,
    SHARD_STATE_KEY,
    CycleState,
    ShardTag,
)
from yoda_tpu_torch.framework.interfaces import (
    Code,
    MAX_NODE_SCORE,
    Snapshot,
    Status,
    summarize_failure,
)
from yoda_tpu_torch.framework.queue import QueuedPodInfo, SchedulingQueue
from yoda_tpu_torch.framework.runtime import Framework, WaitingPod
from yoda_tpu_torch.observability import (
    SERVE_SUBJECT,
    PhaseTimer,
    SchedulingMetrics,
    TraceEntry,
)
from yoda_tpu_torch.tracing import subject_of


@dataclass
class ScheduleResult:
    pod_key: str
    outcome: str  # "bound" | "waiting" | "unschedulable" | "error" | "nominated" | "gone"
    node: str | None = None
    message: str = ""
    latency_s: float = 0.0
    # Cycle-completion instant on the scheduler's clock.
    completed_at: float = 0.0


@dataclass
class SchedulerStats:
    results: list[ScheduleResult] = field(default_factory=list)
    binds: int = 0
    preempt_nominations: int = 0

    def latencies(self) -> list[float]:
        return [r.latency_s for r in self.results]


# Never score fewer feasible nodes than this when percentage_nodes_to_score
# caps the set (the scaled-down analog of upstream's minFeasibleNodesToFind,
# which is 100 — TPU fleets are 1-2 orders smaller than general clusters).
MIN_FEASIBLE_TO_SCORE = 8


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
        on_nominated: Callable[[PodSpec, "str | None"], None] | None = None,
        percentage_nodes_to_score: int = 100,
        cycle_lock: "threading.Lock | None" = None,
        post_filter_lock: "threading.Lock | None" = None,
        metrics: SchedulingMetrics | None = None,
        pod_alive: Callable[[PodSpec], bool] | None = None,
        burst_size: int = 1,
        fence_fn: Callable[[], bool] | None = None,
        bind_executor=None,
    ) -> None:
        self.framework = framework
        self.snapshot_fn = snapshot_fn
        self.queue = queue
        self.clock = clock
        self.stats = SchedulerStats()
        self.on_bound = on_bound
        self.on_unschedulable = on_unschedulable
        self.on_nominated = on_nominated
        # Covers snapshot -> Filter -> Reserve. Not reentrant: preemption's
        # victim selection takes the same lock, so the cycle releases it
        # before PostFilter.
        self.cycle_lock = cycle_lock or threading.Lock()
        # Serializes PostFilter preemption only (victim selection and the
        # evictions), taken after the cycle lock is released.
        self.post_filter_lock = post_filter_lock or threading.Lock()
        self.metrics = metrics
        self.percentage_nodes_to_score = percentage_nodes_to_score
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
        # Leader fencing: when wired, a False return FENCES the scheduler —
        # binds are aborted BEFORE the API write and the rebalancer does
        # nothing. Settable post-construction.
        self.fence_fn = fence_fn
        # Speculative placement cache (framework/speculation.py): wired by
        # build_stack; None disables the fast path entirely. The
        # consume chain in _schedule_one_locked (lookup -> fence ->
        # epoch_valid -> revalidate -> consume_plan) is the only reader.
        self.speculation = None
        # Bind pipeline: when wired, gang releases fan their member binds
        # out on this executor and the serve loop OVERLAPS the next cycle
        # (snapshot refresh + kernel dispatch) with the in-flight binds.
        # Pending binds are active work: run_until_idle never concludes
        # idle under them, and every settle bumps the activity condition
        # so drain waits stay event-bound.
        self.bind_executor = bind_executor
        if bind_executor is not None:
            bind_executor.on_settled = self._signal_activity
        # Warm-start gate (crash-safe failover): when wired (cli.py sets
        # the stack reconciler's resync), serve_forever invokes this ONCE,
        # after the fence first reports leadership but BEFORE the first
        # queue pop — so the resync pass completes before any
        # post-promotion bind can happen. A raising hook propagates:
        # serving on un-resynced state risks double-placement, so the
        # process fails closed and restarts into standby.
        self.on_serve_start: "Callable[[], None] | None" = None
        # Scheduler shard-out (framework/shards.py): when this loop is one
        # of N parallel shards, `shard` names it (cycles are tagged so the
        # shared accountant STAGES their claims) and `commit_fn`
        # (ChipAccountant.commit_staged) is the optimistic
        # claim->validate->commit point — singletons validate immediately
        # before their bind write; a gang's cohort validates once every
        # member's bind has landed (_flush_shard_commits), rolling the
        # gang back whole through the transactional unbind path on a
        # conflict. Both None (the default) = the unsharded path,
        # nothing staged, nothing committed.
        self.shard: "str | None" = None
        self.commit_fn: "Callable[[list], tuple[bool, str]] | None" = None
        # Live shard resize (ShardSet.resize): a dissolved shard's loop
        # is RETIRED — permanently fenced (no bind can start) and its
        # serve_forever thread exits at the next turn. Queued work was
        # already rerouted by the resizer; anything that straggles in
        # parks fenced until the final reroute sweep moves it.
        self.retired = threading.Event()
        # pod uid -> node nominated by preemption: a pod that binds to a
        # DIFFERENT node gets its stale status.nominatedNodeName cleared.
        # Entries drop on bind or deletion.
        self._nominated: dict[str, str] = {}
        self._lock = threading.Lock()
        self._search_rotor = 0

    def _bind_inflight(self) -> int:
        """Binds currently in flight on the pipeline executor (0 when no
        executor is wired — every bind then runs inline in its cycle)."""
        ex = self.bind_executor
        return ex.inflight() if ex is not None else 0

    def _fenced(self) -> bool:
        """True when a leader gate is wired and this process does NOT hold
        leadership right now: no bind may hit the API. A raising fence
        check counts as fenced — fail closed. A RETIRED loop (its shard
        dissolved by a live resize) is fenced forever."""
        if self.retired.is_set():
            return True
        fn = self.fence_fn
        if fn is None:
            return False
        try:
            return not fn()
        except Exception:  # noqa: BLE001 — fail closed
            log.exception("fence check failed; treating scheduler as fenced")
            return True

    def _search_limit(self, n_nodes: int) -> int:
        """Upstream percentageOfNodesToScore, the SEARCH half: how many
        feasible nodes the filter scan needs before it may stop. 0 = no
        cap (the default 100%%, tiny fleets, or batch mode — the fused
        evaluation filters the fleet in one dispatch where a cap would cost
        placement quality and save nothing)."""
        pct = self.percentage_nodes_to_score
        if pct >= 100 or n_nodes <= MIN_FEASIBLE_TO_SCORE:
            return 0
        return max(-(-(n_nodes * pct) // 100), MIN_FEASIBLE_TO_SCORE)

    def _search_start(self, n_nodes: int) -> int:
        """Rotating scan origin (upstream nextStartNodeIndex). The rotor is
        advanced AFTER the scan by the number of nodes actually visited
        (:meth:`_advance_search`): a long infeasible run is skipped by the
        next cycle instead of being re-filtered window-width at a time."""
        if n_nodes <= 0 or self.percentage_nodes_to_score >= 100:
            return 0
        with self._lock:
            return self._search_rotor % n_nodes

    def _advance_search(self, visited: int) -> None:
        with self._lock:
            self._search_rotor += max(visited, 1)

    # --- one pod ---

    def schedule_one(self, qpi: QueuedPodInfo) -> ScheduleResult:
        # The lock covers snapshot -> Filter -> Reserve; the body releases
        # it before PostFilter (whose victim selection takes it again) and
        # after Reserve.
        self.cycle_lock.acquire()
        released = [False]

        def release_cycle_lock() -> None:
            if not released[0]:
                released[0] = True
                self.cycle_lock.release()

        try:
            return self._schedule_one_locked(qpi, release_cycle_lock)
        finally:
            release_cycle_lock()

    def _schedule_one_locked(
        self,
        qpi: QueuedPodInfo,
        release_cycle_lock: Callable[[], None] = lambda: None,
    ) -> ScheduleResult:
        pod = qpi.pod
        t0 = self.clock()
        # A pod deleted (or already bound, or gated) while queued is
        # dropped: counted as a "gone" attempt, no cycle bookkeeping.
        if self.pod_alive is not None and not self.pod_alive(pod):
            log.debug(
                "pod %s no longer schedulable (deleted/bound/gated); "
                "dropping queue entry", pod.key,
            )
            with self._lock:
                self._nominated.pop(pod.uid, None)
            now = self.clock()
            r = ScheduleResult(
                pod.key, "gone", latency_s=now - t0, completed_at=now
            )
            with self._lock:
                self.stats.results.append(r)
            if self.metrics is not None:
                self.metrics.attempts.inc(result="gone")
            return r
        state = CycleState()
        if self.shard is not None:
            # Tag the cycle so the shared accountant stages (rather than
            # finalizes) this cycle's Reserve claims for the optimistic
            # commit validation.
            state.write(SHARD_STATE_KEY, ShardTag(self.shard))
        snapshot = self.snapshot_fn()
        timer = PhaseTimer(self.clock)
        feasible_count = 0
        # Pre-bound for done()'s closure: the filter section rebinds it
        # with the real per-node verdict map; prefilter-path exits see {}.
        statuses: dict[str, Status] = {}
        # Lifecycle tracing (tracing.py): one "cycle" span per scheduling
        # attempt on the pod/gang's trace, with the outcome, chosen node
        # and per-phase wall splits as attributes. None when tracing is
        # off — the only cost then is this attribute read.
        tracer = self.metrics.tracer if self.metrics is not None else None
        if tracer is not None and not tracer.enabled:
            tracer = None
        subject = subject_of(pod) if tracer is not None else None

        def done(
            outcome: str,
            node: str | None = None,
            message: str = "",
            *,
            unresolvable: bool = False,
        ) -> ScheduleResult:
            # Nothing below needs the cycle lock (stats, queue operations,
            # the nomination patch); no-op when already released.
            release_cycle_lock()
            now = self.clock()
            r = ScheduleResult(
                pod.key, outcome, node, message, now - t0, completed_at=now
            )
            if outcome == "bound":
                log.info(
                    "bound %s -> %s (%d/%d nodes feasible, %.1f ms)",
                    pod.key, node, feasible_count, len(snapshot),
                    r.latency_s * 1e3,
                )
                self._clear_stale_nomination(pod, node)
            elif outcome == "nominated":
                log.info("nominated %s -> %s: %s", pod.key, node, message)
            elif outcome == "unschedulable":
                log.info("unschedulable %s: %s", pod.key, message)
            elif outcome == "error":
                log.warning("error scheduling %s: %s", pod.key, message)
            else:
                log.debug("pod %s waiting at permit on %s", pod.key, node)
            with self._lock:
                self.stats.results.append(r)
            if self.metrics is not None:
                self.metrics.attempts.inc(result=outcome)
                self.metrics.latency.observe(r.latency_s, phase="total")
                timer.observe_into(self.metrics.latency)
                self.metrics.trace(
                    TraceEntry(
                        pod_key=pod.key,
                        outcome=outcome,
                        node=node,
                        nodes_total=len(snapshot),
                        nodes_feasible=feasible_count,
                        message=message,
                        phases_ms=dict(timer.phases_ms),
                    )
                )
            if tracer is not None:
                # timer.phases_ms is handed over as-is (the timer dies
                # with this cycle).
                cycle_attrs = {
                    "pod": pod.key,
                    "outcome": outcome,
                    "node": node or "",
                    "message": message[:200],
                    "phases_ms": timer.phases_ms,
                }
                if self.shard is not None:
                    # Lane spans: which serve loop ran this cycle — the
                    # trace-side half of explain's shard tag.
                    cycle_attrs["shard"] = self.shard
                cycle_id = tracer.add(
                    subject, "cycle", t0=t0, t1=now, attrs=cycle_attrs,
                )
                if outcome == "waiting":
                    tracer.add(
                        subject, "permit-park", parent=cycle_id,
                        attrs={"pod": pod.key, "node": node or ""},
                    )
                elif outcome == "bound" and gang_name_of(pod.labels):
                    # Gang members bound directly (the last member's own
                    # cycle) mark the edge explicitly; singleton cycles
                    # already say outcome=bound on the cycle span.
                    tracer.add(
                        subject, "bound", parent=cycle_id,
                        attrs={"pod": pod.key, "node": node or ""},
                    )
            if self.metrics is not None:
                # Why-pending index: every rejection verdict aggregates
                # per pod AND per gang; a bind retires the entry.
                gang = gang_name_of(pod.labels)
                if outcome in ("unschedulable", "error", "nominated"):
                    self.metrics.pending.record(
                        pod.key,
                        kind=outcome,
                        message=message,
                        gang=gang,
                        node_reasons={
                            n: s.message
                            for n, s in statuses.items()
                            if not s.success
                        }
                        or None,
                        shard=self.shard,
                    )
                elif outcome == "bound":
                    self.metrics.pending.resolve(pod.key, gang=gang)
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
            elif outcome == "nominated":
                # Preemption made room; the pod requeues and a later cycle
                # places it (after its backoff, on the next cluster event,
                # or run_until_idle's forced retry: the victims' deletions
                # landed before this requeue). The nomination is surfaced
                # as status.nominatedNodeName, patched only when it
                # changes (every retry re-nominates while victims drain).
                self.queue.add_unschedulable(qpi, message)
                with self._lock:
                    self.stats.preempt_nominations += 1
                if node is not None:
                    with self._lock:
                        changed = self._nominated.get(pod.uid) != node
                        self._nominated[pod.uid] = node
                    if changed and self.on_nominated is not None:
                        self.on_nominated(pod, node)
            return r

        if pod.scheduling_gates:
            # Defensive (the informer keeps gated pods out of the queue):
            # a gated copy parks through the standard unresolvable path.
            return done(
                "unschedulable",
                message="pod has scheduling gates; not ready to schedule",
                unresolvable=True,
            )
        with timer.span("prefilter"):
            st = self.framework.run_pre_filter(state, pod, snapshot)
        if not st.success:
            if st.code == Code.UNSCHEDULABLE:
                # A PreFilter rejection (gang admission: no room for the
                # whole gang) reaches PostFilter too: preemption is how a
                # training gang displaces inference pods. No Reserve
                # happened, so the cycle lock goes before the evictions.
                release_cycle_lock()
                with timer.span("postfilter"), self.post_filter_lock:
                    nominated, pf_st = self.framework.run_post_filter(
                        state, pod, snapshot, {}
                    )
                if nominated:
                    return done("nominated", node=nominated, message=pf_st.message)
            return done(
                "unschedulable",
                message=st.message,
                unresolvable=st.code == Code.UNSCHEDULABLE_AND_UNRESOLVABLE,
            )

        # Speculative placement cache (framework/speculation.py): a hot,
        # constraint-free shape can bind from a plan the rebalancer thread
        # pre-validated between cycles, skipping the fleet evaluation.
        # Consumption is gated on the leader fence, the plan's epoch
        # validity against BOTH informer delta feeds, and an O(1)
        # admission + reserved-chip spot check on the single chosen node;
        # a failed Reserve falls through to the full path below — a
        # speculative miss never parks the pod.
        best: str | None = None
        spec = self.speculation
        if spec is not None and spec.enabled:
            t_spec = self.clock()
            with timer.span("spec"):
                node = None
                plan = spec.lookup(pod)
                if (
                    plan is not None
                    and not self._fenced()
                    and spec.epoch_valid(plan)
                    and spec.revalidate(plan, pod, snapshot)
                ):
                    node = spec.consume_plan(plan)
            if node is not None:
                with timer.span("reserve"):
                    st = self.framework.run_reserve(state, pod, node)
                if st.success:
                    best = node
                    feasible_count = 1
                    spec.record_bound((self.clock() - t_spec) * 1e3)
                else:
                    # A foreign claim raced the window between the spot
                    # check and Reserve; the plan was already consumed.
                    spec.reserve_rejected(plan)

        if best is None:
            with timer.span("filter"):
                try:
                    batch = self.framework.run_batch_filter_score(
                        state, pod, snapshot
                    )
                except Exception as e:  # noqa: BLE001 — keep the loop serving
                    log.exception("batch filter/score failed for %s", pod.key)
                    return done(
                        "error", message=f"batch filter/score failed: {e}"
                    )
                if batch is not None:
                    statuses, batch_scores = batch
                    feasible = sorted(batch_scores)
                else:
                    # Loop mode: the per-node filter chain over the search
                    # window.
                    limit = self._search_limit(len(snapshot))
                    statuses = self.framework.run_filters(
                        state, pod, snapshot,
                        stop_after_feasible=limit,
                        start_index=self._search_start(len(snapshot)),
                    )
                    if limit:
                        # run_filters records a status per node VISITED, so
                        # the map's size is the processed count (upstream
                        # advances nextStartNodeIndex the same way).
                        self._advance_search(len(statuses))
                    batch_scores = {}
                    feasible = sorted(
                        n for n, s in statuses.items() if s.success
                    )
            if batch is not None:
                # The port's split of the fused evaluation's filter by what
                # served the cycle: a row evaluated before it (a burst's)
                # or a fresh evaluation. Loop mode records neither.
                timer.phases_ms[
                    "filter_burst_row" if state.contains(FILTER_PATH_KEY)
                    else "filter_dispatch"
                ] = timer.phases_ms["filter"]
            feasible_count = len(feasible)
            # The reference's V(3) per-node decision detail (scheduler.go:67).
            # Under search truncation, statuses covers only the scanned
            # window — say so, or 12/1000 reads as 988 infeasible nodes.
            if log.isEnabledFor(logging.DEBUG):
                log.debug(
                    "pod %s: %d/%d scanned nodes feasible (fleet %d)",
                    pod.key, feasible_count, len(statuses), len(snapshot),
                )
                for n in sorted(statuses):
                    s = statuses[n]
                    if not s.success:
                        log.debug(
                            "pod %s: node %s rejected: %s",
                            pod.key, n, s.message,
                        )
            if not feasible:
                # As above: no Reserve on this path, the lock goes first.
                release_cycle_lock()
                with timer.span("postfilter"), self.post_filter_lock:
                    nominated, pf_st = self.framework.run_post_filter(
                        state, pod, snapshot, statuses
                    )
                if nominated:
                    return done("nominated", node=nominated, message=pf_st.message)
                return done("unschedulable", message=summarize_failure(statuses))

            with timer.span("score"):
                st = self.framework.run_pre_score(state, pod, snapshot, feasible)
                totals: dict[str, int] = {}
                if st.success:
                    totals, st = self.framework.run_scores(
                        state, pod, snapshot, feasible
                    )
            # Outside the span: returning from inside it would drop the
            # score phase from this cycle's trace entry and histogram.
            if not st.success:
                return done("error", message=st.message)
            if batch_scores:
                if self.framework.score_plugins:
                    # Combining with per-node plugins: bring the batch total
                    # onto the same [0,100] scale.
                    normalized = _normalize(batch_scores)
                    for n in feasible:
                        totals[n] = totals.get(n, 0) + normalized[n]
                else:
                    # Batch is the only scorer: its scores are already
                    # normalized+tiered; re-normalizing would only quantize
                    # away within-tier ordering.
                    totals = dict(batch_scores)
            best = max(feasible, key=lambda n: (totals.get(n, 0), n))
            # Final scores (the reference's V(3) score log, scheduler.go:143).
            if log.isEnabledFor(logging.DEBUG):
                ranked = sorted(
                    ((totals.get(n, 0), n) for n in feasible), reverse=True
                )
                log.debug(
                    "pod %s: scores %s -> %s",
                    pod.key,
                    [(n, s) for s, n in ranked[:8]],
                    best,
                )

            with timer.span("reserve"):
                st = self.framework.run_reserve(state, pod, best)
            if not st.success:
                return done("unschedulable", node=best, message=st.message)
        # Reservation charged: the rest of the cycle needs no lock.
        release_cycle_lock()

        with timer.span("permit"):
            st = self.framework.run_permit(
                state, pod, best, self._on_permit_resolved, now=self.clock()
            )
        if st.code == Code.WAIT:
            return done("waiting", node=best)
        if not st.success:
            self.framework.run_unreserve(state, pod, best)
            return done("unschedulable", node=best, message=st.message)

        if self._fenced():
            # Leader fencing: abort BEFORE the API write. The reservation
            # rolls back and the pod requeues.
            if self.metrics is not None:
                self.metrics.fenced_binds.inc()
            self.framework.run_unreserve(state, pod, best)
            return done(
                "unschedulable",
                node=best,
                message="scheduler fenced (not leader); bind aborted before "
                "the API write",
            )
        if self.commit_fn is not None:
            # Optimistic shard commit, singleton form: validate this
            # cycle's staged claim at the shared accountant BEFORE the
            # bind write — a conflict (another shard's earlier-staged
            # claim owns the chips) costs one unreserve + requeue, never
            # an API write to roll back. The fence check above dominates
            # this commit (yodalint fence-before-write).
            ok, why = self.commit_fn([pod.uid])
            if not ok:
                self.framework.run_unreserve(state, pod, best)
                return done(
                    "unschedulable",
                    node=best,
                    message=f"shard commit conflict: {why}",
                )
        st = self.framework.run_bind(state, pod, best)
        if not st.success:
            self.framework.run_unreserve(state, pod, best)
            return done("unschedulable", node=best, message=st.message)
        with self._lock:
            self.stats.binds += 1
        if self.metrics is not None:
            self.metrics.binds.inc()
            # SLO engine: close the enqueue->bound admission-wait edge.
            self.metrics.slo.observe_bound(pod, now=self.clock())
        if self.on_bound:
            self.on_bound(pod, best)
        # Cluster changed: retry parked pods (skipped when nothing parked).
        if self.queue.has_parked():
            self.queue.move_all_to_active()
        return done("bound", node=best)

    def _clear_stale_nomination(self, pod: PodSpec, node: str) -> None:
        """On any successful bind (direct or permit-released): drop the
        nomination record, and clear status.nominatedNodeName when the pod
        landed on a DIFFERENT node."""
        with self._lock:
            nominated = self._nominated.pop(pod.uid, None)
        if (
            nominated is not None
            and nominated != node
            and self.on_nominated is not None
        ):
            self.on_nominated(pod, None)

    def retire(self) -> None:
        """Permanently fence this loop and make its serve thread exit
        (a live shard resize dissolved its lane). Idempotent."""
        self.retired.set()
        self._signal_activity()

    # --- permit resolution and the transactional gang rollback ---

    def _signal_activity(self) -> None:
        with self._activity:
            self._activity_seq += 1
            self._activity.notify_all()

    def _on_permit_resolved(self, wp: WaitingPod, status: Status) -> None:
        """Fires when a waiting pod is allowed (bind it) or rejected (roll
        back its reservation and requeue) — on the pipelined release, from
        a bind-executor worker. Flushes any gang rollbacks whose release
        barrier this settle completed, then signals the drain condition —
        AFTER the bind, requeue and rollbacks landed, so a woken
        ``run_until_idle`` never observes the half-resolved state."""
        try:
            self._do_permit_resolved(wp, status)
        finally:
            try:
                self._flush_deferred_rollbacks()
                self._flush_shard_commits()
            finally:
                self._signal_activity()

    def _flush_deferred_rollbacks(self) -> None:
        """Completion-barrier flush: unwind landed binds of gangs whose
        release cohort has FULLY settled after a bind failure (every
        in-flight sibling bound, failed, or was cascade-rejected). Runs
        after every settle, on whichever thread settled last — an unbind
        never races a sibling's bind still mid-air."""
        for p in self.framework.permit_plugins:
            hook = getattr(p, "collect_rollbacks", None)
            if hook is None:
                continue
            for spec, node, why in hook(self.framework):
                self._rollback_bound(spec, node, None, why)

    def _flush_shard_commits(self) -> None:
        """Optimistic shard commit, gang form: validate the staged claims
        of every release cohort whose binds have FULLY landed (the gang
        plugin arms ``collect_commits`` on the last settle). Runs on
        whichever thread settled last — exactly the deferred-rollback
        discipline. A validation conflict (or a fence flip: a new leader
        owns the truth now) makes the shard the LOSER: every landed
        member's bind rolls back through the transactional unbind path
        and the gang requeues whole, counted in
        ``yoda_shard_commit_rollbacks_total``."""
        if self.commit_fn is None:
            return
        for p in self.framework.permit_plugins:
            hook = getattr(p, "collect_commits", None)
            if hook is None:
                continue
            for gang_name, cohort in hook(self.framework):
                fenced = self._fenced()
                if fenced:
                    ok, why = False, (
                        "scheduler fenced (lost leadership) before the "
                        "shard commit; rolling the gang back"
                    )
                else:
                    ok, why = self.commit_fn(
                        [spec.uid for spec, _host in cohort]
                    )
                if ok:
                    continue
                why = f"gang {gang_name}: shard commit conflict: {why}"
                log.warning(
                    "%s — rolling back %d landed member(s)",
                    why, len(cohort),
                )
                if self.metrics is not None:
                    self.metrics.shard_rollbacks.inc(len(cohort))
                    if self.metrics.tracer.enabled:
                        self.metrics.tracer.add(
                            f"gang:{gang_name}", "shard-commit-conflict",
                            attrs={
                                "members": len(cohort),
                                "shard": self.shard or "",
                                "message": why[:200],
                            },
                        )
                    self.metrics.pending.record(
                        gang_name,
                        kind="unschedulable",
                        message=why,
                        shard=self.shard,
                    )
                # EVERY membership drops BEFORE any member requeues: a
                # rolled-back member re-admitted while siblings still
                # read as bound would find a satisfied-looking barrier
                # and release alone — the split gang this path must
                # never produce.
                drop = getattr(p, "drop_membership", None)
                if drop is not None:
                    for spec, _host in cohort:
                        drop(spec)
                for spec, host in cohort:
                    self._rollback_bound(spec, host, None, why)

    def _do_permit_resolved(self, wp: WaitingPod, status: Status) -> None:
        pod = wp.pod
        if self.metrics is not None and wp.parked_at is not None:
            self.metrics.gang_wait.observe(max(self.clock() - wp.parked_at, 0.0))
        if status.success:
            if self._fenced():
                # Leader fencing between permit release and bind: abort
                # before the API write; the gang rolls back transactionally
                # below, exactly as a bind failure would.
                if self.metrics is not None:
                    self.metrics.fenced_binds.inc()
                st = Status.unschedulable(
                    "scheduler fenced (lost leadership); bind aborted "
                    "before the API write"
                )
            else:
                st = self.framework.run_bind(wp.state, pod, wp.node_name)
            if st.success:
                if not self._confirm_bound(wp):
                    # The gang began a bind-failure rollback while this
                    # member's bind was in flight (pipelined release): the
                    # landed bind is unwound, not celebrated.
                    self._rollback_bound(
                        pod,
                        wp.node_name,
                        wp.state,
                        "gang rolled back while this member's bind was in "
                        "flight",
                    )
                    return
                log.info("bound %s -> %s (permit released)", pod.key, wp.node_name)
                with self._lock:
                    self.stats.binds += 1
                if self.metrics is not None:
                    self.metrics.binds.inc()
                    # SLO engine: permit-released members close their
                    # admission-wait edge here, on whichever thread
                    # settled the bind.
                    self.metrics.slo.observe_bound(pod, now=self.clock())
                    gang = gang_name_of(pod.labels)
                    self.metrics.pending.resolve(pod.key, gang=gang)
                    if self.metrics.tracer.enabled:
                        self.metrics.tracer.add(
                            subject_of(pod), "bound",
                            attrs={"pod": pod.key, "node": wp.node_name},
                        )
                if self.on_bound:
                    self.on_bound(pod, wp.node_name)
                self._clear_stale_nomination(pod, wp.node_name)
                if self.queue.has_parked():  # see the bind path: skip empty sweeps
                    self.queue.move_all_to_active()
                return
            self._handle_bind_failure(wp, st)
            status = st
        log.info(
            "permit rejected %s on %s: %s", pod.key, wp.node_name, status.message
        )
        self.framework.run_unreserve(wp.state, pod, wp.node_name)
        if self.metrics is not None:
            self.metrics.pending.record(
                pod.key,
                kind="permit-rejected",
                message=status.message,
                gang=gang_name_of(pod.labels),
                shard=self.shard,
            )
            if self.metrics.tracer.enabled:
                self.metrics.tracer.add(
                    subject_of(pod), "permit-rejected",
                    attrs={
                        "pod": pod.key,
                        "node": wp.node_name,
                        "message": status.message[:200],
                    },
                )
        self.queue.add_unschedulable(QueuedPodInfo(pod=pod), status.message)
        if self.on_unschedulable:
            self.on_unschedulable(pod, status.message)

    def _confirm_bound(self, wp: WaitingPod) -> bool:
        """Let Permit plugins observe a landed permit-release bind
        (transactional gang bookkeeping). Any False verdict means the bind
        must be rolled back — the gang failed while this bind was in
        flight."""
        keep = True
        for p in self.framework.permit_plugins:
            hook = getattr(p, "on_pod_bound", None)
            if hook is not None and not hook(self.framework, wp):
                keep = False
        return keep

    def _handle_bind_failure(self, wp: WaitingPod, st: Status) -> None:
        """A permit-released bind failed after the binder's transient
        retries (or was fenced): Permit plugins make the failure
        TRANSACTIONAL — the gang plugin rejects still-waiting members and
        parks the siblings whose binds already landed for a deferred
        unwind; the unbind / unreserve / requeue happens in
        ``_flush_deferred_rollbacks`` once the release cohort has fully
        settled (an unbind must never race a sibling's bind still mid-air
        on the pipeline). The failing member itself goes through the
        caller's standard rejection path."""
        initiated = False
        for p in self.framework.permit_plugins:
            hook = getattr(p, "on_bind_failed", None)
            if hook is None:
                continue
            if hook(self.framework, wp, st):
                initiated = True
        if initiated and self.metrics is not None:
            self.metrics.recovery_rollbacks.inc()

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
        tracer = self.metrics.tracer if self.metrics is not None else None
        if tracer is not None and not tracer.enabled:
            tracer = None
        tg0 = self.clock()
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
        if tracer is not None:
            # The gather edge: one span per gathered gang, so each gang's
            # trace shows the joint pass it rode (same wall window).
            names = ",".join(n for n, _ in ordered)
            for name, g in ordered:
                tracer.add(
                    f"gang:{name}", "gather",
                    t0=tg0, t1=self.clock(),
                    attrs={"gangs": names, "members": len(g)},
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
                why = (
                    f"gang {name}: joint fit gate — cannot place whole "
                    "net of higher-priority co-queued gangs; restored "
                    "untouched"
                )
                if tracer is not None:
                    tracer.add(
                        f"gang:{name}", "joint-park",
                        attrs={"members": len(g), "behind": i},
                    )
                if self.metrics is not None:
                    for q in g:
                        self.metrics.pending.record(
                            q.pod.key,
                            kind="joint-park",
                            message=why,
                            gang=name,
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
        t0 = self.clock()
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
            self._observe_burst(t0, len(batch))
        return batch

    def _observe_burst(self, t0: float, pods: int) -> None:
        """A prepared burst, from its first further pop to the return of
        prepare_burst: phase="burst" and one burst span on the serve
        thread's track."""
        if self.metrics is None:
            return
        t1 = self.clock()
        self.metrics.latency.observe(t1 - t0, phase="burst")
        tracer = self.metrics.tracer
        if tracer.enabled:
            tracer.add(
                SERVE_SUBJECT, "burst", t0=t0, t1=t1,
                attrs={"pods": pods, "shard": self.shard or ""},
            )

    def _end_turn(self, wall0: float, cpu0: float) -> None:
        """A loop turn that popped work ends: its wall and on-CPU seconds
        into yoda_serve_busy_seconds_total, then the collections it saw
        folded into their histogram and spans. The clocks are read cpu
        inside wall, so cpu never exceeds wall."""
        if self.metrics is None:
            return
        cpu = time.thread_time() - cpu0
        wall = time.monotonic() - wall0
        self.metrics.serve_busy.inc(wall, clock="wall")
        self.metrics.serve_busy.inc(cpu, clock="cpu")
        self.metrics.gc_pauses.fold()

    # Ceiling on one event-bound drain wait: signals wake the waiter
    # immediately, so this bounds only the unsignaled cases (fake clocks
    # skewing permit deadlines, resolutions on paths that cannot signal).
    DRAIN_WAIT_CAP_S = 0.05

    def run_until_idle(self, *, max_wall_s: float = 30.0) -> None:
        """Drain the queue, resolving Permit waits and expirations, until no
        active work remains or ``max_wall_s`` passes. Test/demo entry point; the
        production loop is ``serve_forever``.

        Event-bound: while Permit waiters exist the loop sleeps on the
        activity condition — woken by permit resolutions (allow/reject from
        any thread) and queue activity (adds, event reactivations) — with a
        timeout no later than the earliest permit deadline, so expiry still
        fires on time. The old fixed 2 ms settle poll made every gang's
        drain latency a multiple of the poll interval; now it tracks the
        resolving event itself."""
        deadline = time.monotonic() + max_wall_s
        binds_at_drain = -1  # binds count when the queue last went inactive
        while time.monotonic() < deadline:
            with self._activity:
                seq = self._activity_seq  # pre-check capture: a resolution
                # landing between the checks below and the wait bumps the
                # seq and turns the wait into a no-op (no lost wakeup).
            if self._fenced():
                # Leader fencing: park the queue — nothing is popped or
                # bound while fenced. The drain's fixed-point checks below
                # conclude quickly (no binds advance).
                qpi = None
            else:
                qpi = self.queue.pop(timeout=0.0)
            if qpi is not None:
                wall0, cpu0 = time.monotonic(), time.thread_time()
                if self.metrics is not None and self._bind_inflight() > 0:
                    # Pipeline overlap: this cycle's snapshot + dispatch
                    # runs while the previous release's binds are in
                    # flight — the serialization the pipeline removes.
                    self.metrics.overlap_cycles.inc()
                for q in self._pop_batch(qpi):
                    self.schedule_one(q)
                self._end_turn(wall0, cpu0)
                continue
            self.framework.expire_waiting(now=self.clock())
            waiters = self.framework.waiting_pods()
            inflight = self._bind_inflight()
            if waiters or inflight:
                # Pending pipelined binds are active work: their pods left
                # the waitlist when allow() fired, but the bind API write
                # (and any rollback it triggers) has not landed. Each
                # settle signals the activity condition.
                now = self.clock()
                next_deadline = (
                    min(w.deadline for w in waiters)
                    if waiters
                    else now + self.DRAIN_WAIT_CAP_S
                )
                timeout = max(
                    min(
                        next_deadline - now,
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
            # Forced: the settlement loop must not conclude "idle" while
            # a CHRONIC pod (beyond the event-retry cutoff) could fit the
            # freed capacity — bounded, since it only fires when binds
            # advanced since the last drain.
            if self.stats.binds == binds_at_drain:
                return
            binds_at_drain = self.stats.binds
            self.queue.move_all_to_active(force=True)

    def serve_forever(self, stop: threading.Event, *, poll_s: float = 0.5) -> None:
        """The production loop: block on the queue, schedule the popped
        batch, then sweep permit expirations ONCE per iteration (the sweep
        ran twice per iteration before — once after the pop and once per
        scheduled entry — pure overhead, since expiry resolution only needs
        to be poll_s-grained and each sweep walks the whole waitlist).

        With the bind pipeline wired, a gang release returns before its
        binds land: the next iteration's pop -> snapshot -> kernel dispatch
        OVERLAPS the in-flight bind I/O (yoda_overlap_cycles_total counts
        these turns). Correctness needs no extra synchronization — the
        in-flight members' reservations stay charged to the accountant, so
        the overlapped evaluation already sees their capacity as consumed."""
        while not stop.is_set():
            if self.retired.is_set():
                # Dissolved by a live shard resize: the thread exits; the
                # resizer already rerouted this lane's queue.
                return
            if self._fenced():
                # Leader fencing: park the queue until leadership returns.
                # Permit expirations still sweep so parked gangs cannot
                # hold reservations past their deadlines while fenced.
                self.framework.expire_waiting(now=self.clock())
                stop.wait(poll_s)
                continue
            if self.on_serve_start is not None:
                # Warm-start resync: runs exactly once, after the fence
                # first admits leadership and before the first pop — no
                # bind can precede it (the /readyz contract).
                hook, self.on_serve_start = self.on_serve_start, None
                hook()
            qpi = self.queue.pop(timeout=poll_s)
            if qpi is not None:
                wall0, cpu0 = time.monotonic(), time.thread_time()
                if self.metrics is not None and self._bind_inflight() > 0:
                    self.metrics.overlap_cycles.inc()
                for q in self._pop_batch(qpi):
                    self.schedule_one(q)
            self.framework.expire_waiting(now=self.clock())
            if qpi is not None:
                self._end_turn(wall0, cpu0)


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
