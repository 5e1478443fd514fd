"""The goodput-driven rebalancer: background ICI defragmentation, priority
preemption, and elastic gang resize.

Everything before this subsystem placed once: after a gang bound, the
fleet only got worse — churn fragmented the ICI blocks
(rebalance/score.py quantifies the decay) and a parked high-priority gang
could wait forever behind low-priority singletons even when unbinding a
handful of pods would admit it whole. Pollux (OSDI '21) shows continuous
re-allocation toward aggregate goodput beats static placement; Gandiva
(OSDI '18) hides migration cost behind job boundaries. This module is
that control loop for this scheduler, one :class:`Rebalancer` per stack
(``standalone.build_stack``), run on ONE background thread
(:meth:`run_forever`, leadership-gated like the drift reconciler) — it
never blocks a scheduling cycle.

Each pass (:meth:`run_once`), in order:

1. **Priority preemption.** For every gang parked WHOLE in the queue that
   already failed a local cycle (``SchedulingQueue.pending_gangs`` — the
   federation spillover's candidate test), highest priority first: if the
   gang cannot fit the current occupancy model, select the cheapest set of
   strictly-lower-priority victim units — singletons, whole bound gangs
   (never a slice of one), or the elastic-shrink surplus of a bound
   elastic gang — that admits it, minimizing evicted priority-weighted
   work (``(max(priority,0)+1) x chips`` per pod). Victims are preempted
   through the **unbind path** (``Scheduler._rollback_bound``: unbind,
   unreserve, requeue), not deleted: a preempted gang re-queues whole and
   re-places when capacity returns.
2. **Elastic resize.** Gangs declaring ``tpu/min-members``/
   ``tpu/max-members`` grow up into free capacity (parked surplus members
   admitted by raising the effective size) — the shrink direction runs as
   the cheapest preemption unit above, and never below ``min-members``
   (``GangPlugin.set_effective_size`` clamps).
3. **Repack.** Bound topology gangs whose move to a planner-chosen tight
   block improves the fragmentation score by at least ``min_gain`` are
   migrated with the transactional move primitive: take the gang's queue
   entries (``take_gang`` — the serve loop provably cannot touch the gang
   mid-move, the federation migration discipline), drop memberships,
   unbind every member through the standard rollback path (inline on this
   thread), install
   the target plan (``GangPlugin.install_plan``), and re-add the entries.
   The requeued members re-admit onto the installed block through the
   NORMAL reserve -> permit -> bind cycle — no capacity is ever claimed
   outside standard admission, which is what makes "no oversubscription
   during a move" structural.

Crash safety: a process death mid-move leaves at most a partially-bound
gang — exactly the state the reconciler's warm-start resync classifies
adopt-or-rolled-back-whole, so a half-moved gang can never stay split. A
per-pass simulated occupancy ledger (:class:`FleetOccupancy` clone) keeps
the pass's own promises consistent — two moves (or a move and a
preemption) cannot be promised the same free block — and because every
real claim still goes through admission against the live accountant, the
pass cannot race the joint dispatch either.

Counterpart of ``yoda_tpu/rebalance/rebalancer.py``: every pass, the
victim selection, the move primitive and ``run_forever`` with the
speculation sub-tick. Unbinds fan out on the bind executor when
``build_stack`` hands one over (``bind_workers`` > 0) and run inline on the
rebalancer's thread without one; ``draining_fn`` is the node health
monitor's ``draining_nodes``, which makes the drain pass live. The port has
no registry, so no counters, gauge or lifecycle trace.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from yoda_tpu_torch.api.requests import LabelParseError, gang_name_of, pod_request
from yoda_tpu_torch.api.types import PodSpec, pod_admits_on
from yoda_tpu_torch.framework.queue import QueuedPodInfo
from yoda_tpu_torch.framework.runtime import unbind_all
from yoda_tpu_torch.plugins.yoda.sort import pod_priority
from yoda_tpu_torch.plugins.yoda.topology import plan_multislice_placement
from yoda_tpu_torch.rebalance.score import FleetOccupancy

log = logging.getLogger("yoda_tpu_torch.rebalance")


def priority_weight(pod: PodSpec) -> int:
    """Evicted-work weight of one victim pod: priorities can be negative,
    so the weight floor is chips alone — zero- and negative-priority work
    still counts as work."""
    try:
        chips = pod_request(pod).effective_chips
    except LabelParseError:
        chips = 1
    return (max(pod_priority(pod), 0) + 1) * chips


@dataclass
class _VictimUnit:
    """One atomic preemption choice: a singleton, a WHOLE bound gang, or
    the elastic-shrink surplus of a bound elastic gang. Gangs are never
    preempted partially (they must requeue whole); the shrink unit is the
    sanctioned partial form — the gang keeps running at ``keep``."""

    members: "list[tuple[PodSpec, str]]"   # (pod, bound host)
    max_priority: int
    weight: int
    gang: str | None = None
    keep: int | None = None                # shrink unit: new effective size

    @property
    def kind(self) -> str:
        if self.gang is None:
            return "pod"
        return "shrink" if self.keep is not None else "gang"


@dataclass
class RebalanceReport:
    """What one pass measured and did (tests, logs)."""

    fragmentation_before: float = 0.0
    fragmentation_after: float = 0.0
    # Gangs/singletons migrated off DRAINING nodes (the node health
    # monitor's graceful-drain integration).
    drained: list[str] = field(default_factory=list)
    moves: list[str] = field(default_factory=list)
    aborted_moves: list[str] = field(default_factory=list)
    preempted: list[str] = field(default_factory=list)      # victim pod keys
    admitted_gangs: list[str] = field(default_factory=list)
    resizes: dict[str, tuple[int, int]] = field(default_factory=dict)
    preempted_weight: int = 0


class Rebalancer:
    """One per stack; all I/O and planning on the caller's (background)
    thread — the serve loop only ever feels the standard queue/unbind
    effects."""

    def __init__(
        self,
        *,
        cluster,
        informer,
        accountant,
        gang,
        framework,
        queue,
        scheduler,
        bind_executor=None,
        clock: Callable[[], float] = time.monotonic,
        min_gain: float = 0.05,
        max_moves: int = 1,
        preemption: bool = True,
        elastic: bool = True,
        max_victims: int = 8,
        gate_fn: "Callable[[], bool] | None" = None,
        draining_fn: "Callable[[], frozenset] | None" = None,
    ) -> None:
        self.cluster = cluster
        self.informer = informer
        self.accountant = accountant
        self.gang = gang
        self.framework = framework
        self.queue = queue
        self.scheduler = scheduler
        self.bind_executor = bind_executor
        self.clock = clock
        self.min_gain = min_gain
        self.max_moves = max_moves
        self.enable_preemption = preemption
        self.enable_elastic = elastic
        self.max_victims = max_victims
        # run_forever's per-tick admission gate (build_stack wires the
        # leader fence + resynced); run_once ignores it — direct callers
        # decide themselves.
        self.gate_fn = gate_fn
        # Speculative placement cache (framework/speculation.py), wired by
        # build_stack: this thread's idle capacity between passes
        # drives its producer tick — settable post-construction like
        # gate_fn.
        self.speculator = None
        # Node health integration (the reference's nodehealth): nodes under a
        # graceful drain — the pass migrates bound gangs off them
        # PROACTIVELY (rolling-upgrade support), before the monitor's
        # deadline forces a DOWN-style evacuation.
        self.draining_fn = draining_fn
        self.scheduler_name = informer.scheduler_name
        self._lock = threading.Lock()
        self.passes = 0

    # --- the pass ---

    def run_once(self) -> RebalanceReport:
        report = RebalanceReport()
        snapshot = self.informer.snapshot()
        occ = FleetOccupancy.from_snapshot(
            snapshot, self.accountant.chips_by_node()
        )
        report.fragmentation_before = occ.score()
        self._drain_pass(snapshot, occ, report)
        if self.enable_preemption:
            self._preempt_pass(snapshot, occ, report)
        if self.enable_elastic:
            self._resize_up_pass(snapshot, occ, report)
        self._repack_pass(snapshot, occ, report)
        # Re-score from live state so the report reflects what the pass
        # actually changed (unbinds landed synchronously above).
        report.fragmentation_after = FleetOccupancy.from_snapshot(
            self.informer.snapshot(), self.accountant.chips_by_node()
        ).score()
        with self._lock:
            self.passes += 1
        if (
            report.moves
            or report.aborted_moves
            or report.preempted
            or report.resizes
        ):
            log.info(
                "rebalance pass: %d move(s) (%d aborted), %d pod(s) "
                "preempted for %s, %d resize(s), fragmentation %.3f -> %.3f",
                len(report.moves), len(report.aborted_moves),
                len(report.preempted), report.admitted_gangs or "-",
                len(report.resizes), report.fragmentation_before,
                report.fragmentation_after,
            )
        return report

    def run_forever(
        self,
        stop: threading.Event,
        *,
        period_s: float = 30.0,
        spec_period_s: float = 1.0,
    ) -> None:
        """The background loop (a caller puts this on a thread once
        leadership is held). Gate checked per tick; exceptions logged,
        never fatal — a rebalancer crash must not take the scheduler.

        When a speculator is wired, this thread's idle capacity between
        rebalance passes drives the speculative placement cache on the
        much faster ``spec_period_s`` sub-tick — plans stale at
        fleet-churn speed, so a 30 s refresh would never hit. Both ticks
        share the leadership gate: followers neither rebalance nor
        speculate. Without a speculator the loop is byte-for-byte the old
        one-pass-per-period behavior."""
        ticks = 0
        while not stop.is_set():
            spec = self.speculator
            ratio = (
                max(1, round(period_s / spec_period_s))
                if spec is not None
                else 1
            )
            if stop.wait(spec_period_s if spec is not None else period_s):
                return
            try:
                if self.gate_fn is not None and not self.gate_fn():
                    continue
                if spec is not None:
                    spec.speculate_once()
                ticks += 1
                if ticks >= ratio:
                    ticks = 0
                    self.run_once()
            except Exception:  # noqa: BLE001 — background loop must survive
                log.exception("rebalance pass failed; will retry")

    # --- shared plumbing ---

    def _unbind_all(
        self, items: "list[tuple[PodSpec, str]]", why: str
    ) -> None:
        unbind_all(self.scheduler, self.bind_executor, items, why)

    def _bound_by_gang(
        self, snapshot
    ) -> "tuple[dict[str, list[tuple[PodSpec, str]]], list[tuple[PodSpec, str]]]":
        """This profile's BOUND pods from the snapshot, grouped into
        (gangs, singletons). Only TPU-holding pods — chip-free pods free
        nothing when preempted and pin no blocks."""
        gangs: dict[str, list[tuple[PodSpec, str]]] = {}
        singles: list[tuple[PodSpec, str]] = []
        for ni in snapshot.infos():
            for p in ni.pods:
                if p.scheduler_name != self.scheduler_name:
                    continue
                try:
                    req = pod_request(p)
                except LabelParseError:
                    continue
                if not req.wants_tpu:
                    continue
                name = gang_name_of(p.labels)
                if name:
                    gangs.setdefault(name, []).append((p, ni.name))
                else:
                    singles.append((p, ni.name))
        return gangs, singles

    @staticmethod
    def _spec_of(pods: "list[PodSpec]"):
        for p in pods:
            try:
                spec = pod_request(p).gang
            except LabelParseError:
                continue
            if spec is not None:
                return spec
        return None

    def _fits(
        self,
        snapshot,
        occ: FleetOccupancy,
        pods: "list[PodSpec]",
        *,
        charge: bool,
    ) -> bool:
        """Whole-gang fit check against the occupancy model (the per-pass
        consumption ledger): the real multislice planner for topology
        gangs, a greedy claimable walk for plain ones — the gang admission
        fit-gate shape on the simulated substrate. ``charge=True`` commits
        the chosen hosts' chips to ``occ`` so later decisions this pass
        see them consumed. A predicate, not a placement: real admission
        re-validates everything when the members actually schedule."""
        if not pods:
            return False
        spec = self._spec_of(pods)
        try:
            req0 = pod_request(pods[0])
        except LabelParseError:
            return False
        chips = max(req0.effective_chips, 1)
        # Node-health fence: SUSPECT/DRAINING/DOWN hosts must not be
        # promised capacity by any rebalance decision.
        fenced = getattr(snapshot, "fenced", frozenset())
        if spec is not None and spec.topology is not None:
            plan = plan_multislice_placement(
                snapshot,
                want_dims=spec.topology,
                slices=spec.slices,
                host_ok=lambda ni: (
                    ni.name not in fenced
                    and occ.free_chips(ni.name) >= chips
                    and pod_admits_on(ni.node, pods[0])[0]
                ),
            )
            if plan is None:
                return False
            if charge:
                for host in sorted(plan)[: len(pods)]:
                    occ.occupy(host, chips)
            return True
        taken: list[tuple[str, int]] = []
        for pod in pods:
            try:
                chips = max(pod_request(pod).effective_chips, 1)
            except LabelParseError:
                chips = 1
            best, best_free = None, -1
            for ni in snapshot.infos():
                if ni.name in fenced:
                    continue
                f = occ.free_chips(ni.name)
                if f >= chips and f > best_free and pod_admits_on(ni.node, pod)[0]:
                    best, best_free = ni.name, f
            if best is None:
                for host, c in taken:
                    occ.release(host, c)
                return False
            occ.occupy(best, chips)
            taken.append((best, chips))
        if not charge:
            for host, c in taken:
                occ.release(host, c)
        return True

    # --- (0) graceful drain (node health monitor integration) ---

    def _drain_pass(self, snapshot, occ, report: RebalanceReport) -> None:
        """Migrate bound work off DRAINING nodes proactively (rolling
        cluster upgrades, docs/OPERATIONS.md node-failure runbook): the
        node health monitor fences a draining node from new placements
        and hands its name out via ``draining_fn``; this pass moves every
        bound gang with a member there through the standard transactional
        primitives BEFORE the drain deadline forces a DOWN-style
        evacuation. Topology gangs use the repack move primitive onto a
        live block (no min_gain requirement — the drain overrides the
        churn economics); plain gangs unbind-and-requeue whole and
        re-place off the fence; singletons requeue when capacity exists."""
        if self.draining_fn is None:
            return
        draining = self.draining_fn()
        if not draining:
            return
        gangs, singles = self._bound_by_gang(snapshot)
        for name in sorted(gangs):
            members = gangs[name]
            if not any(h in draining for _, h in members):
                continue
            status = self.gang.gang_status(name)
            if status is not None and status[1] > 0:
                continue  # members waiting at Permit: mid-flight
            spec = self._spec_of([p for p, _ in members])
            why = (
                f"rebalance: draining node(s) "
                f"{sorted({h for _, h in members if h in draining})}; "
                f"migrating gang {name} off before the deadline"
            )
            if spec is not None and spec.topology is not None:
                try:
                    chips = max(
                        pod_request(members[0][0]).effective_chips, 1
                    )
                except LabelParseError:
                    continue
                fenced = getattr(snapshot, "fenced", frozenset())
                sim = occ.clone()
                for _pod, host in members:
                    sim.release(host, chips)
                plan = plan_multislice_placement(
                    snapshot,
                    want_dims=spec.topology,
                    slices=spec.slices,
                    host_ok=lambda ni: (
                        ni.name not in draining
                        and ni.name not in fenced
                        and sim.free_chips(ni.name) >= chips
                        and pod_admits_on(ni.node, members[0][0])[0]
                    ),
                )
                if plan is None or set(plan) == {h for _, h in members}:
                    continue  # nowhere live to go yet; deadline escalates
                if self._execute_move(name, spec, members, plan, report):
                    for _pod, host in members:
                        occ.release(host, chips)
                    for host in plan:
                        occ.occupy(host, chips)
                    report.drained.append(name)
                continue
            # Plain/elastic gang: requeue whole — admission re-places it
            # off the fenced node. Only when live capacity fits it now
            # (a gang with nowhere to go keeps running until the
            # deadline, beats thrashing it into the queue).
            pods = [p for p, _ in members]
            if not self._fits(snapshot, occ, pods, charge=True):
                continue
            qpis = self.queue.take_gang(name)
            try:
                if self.scheduler._fenced():
                    return
                for pod, _host in members:
                    self.gang.drop_membership(pod)
                self._unbind_all(list(members), why)
            finally:
                for q in qpis:
                    self.queue.readd(q)
                self.queue.move_all_to_active()
            report.drained.append(name)
            log.info(
                "rebalance: drained gang %s off %s (requeued whole)",
                name, sorted({h for _, h in members if h in draining}),
            )
        for pod, host in singles:
            if host not in draining:
                continue
            if not self._fits(snapshot, occ, [pod], charge=True):
                continue
            if self.scheduler._fenced():
                return
            self.scheduler._rollback_bound(
                pod, host, None,
                f"rebalance: draining node {host}; pod requeued",
            )
            report.drained.append(pod.key)

    # --- (1) priority preemption ---

    def _preempt_pass(self, snapshot, occ, report: RebalanceReport) -> None:
        pending = self.queue.pending_gangs()
        if not pending:
            return
        held: "list[tuple[int, str, list[QueuedPodInfo]]]" = []
        try:
            for name in sorted(pending):
                count, min_attempts = pending[name]
                if min_attempts < 1:
                    continue  # has not failed a cycle yet: not stuck
                status = self.gang.gang_status(name)
                if status is not None and (status[1] > 0 or status[2] > 0):
                    continue  # members waiting at Permit or bound: mid-flight
                qpis = self.queue.take_gang(name)
                pods = [q.pod for q in qpis]
                spec = self._spec_of(pods)
                target = spec.size if spec is not None else 0
                if spec is not None and spec.elastic:
                    eff = self.gang.effective_size(name)
                    target = eff if eff is not None else spec.size
                if spec is None or len(pods) < min(
                    target, spec.floor if spec.elastic else target
                ):
                    # Not the whole gang in hand: admitting a subset would
                    # split it — the thing preemption must never cause.
                    for q in qpis:
                        self.queue.readd(q)
                    continue
                prio = max(pod_priority(p) for p in pods)
                held.append((prio, name, qpis))
            # Highest priority first: a lower-priority parked gang never
            # takes capacity (or victims) a higher one could use.
            held.sort(key=lambda t: -t[0])
            for prio, name, qpis in held:
                pods = [q.pod for q in qpis]
                spec = self._spec_of(pods)
                target = spec.size
                if spec.elastic:
                    eff = self.gang.effective_size(name)
                    target = max(
                        spec.floor, min(eff if eff is not None else spec.size,
                                        len(pods)),
                    )
                members = pods[:target]
                if self._fits(snapshot, occ, members, charge=True):
                    # Fits already (or after earlier victims this pass):
                    # the serve loop places it once the entries return.
                    report.admitted_gangs.append(name)
                    continue
                chosen = self._select_victims(snapshot, occ, members, prio)
                if chosen is None:
                    if spec.elastic:
                        # No victim set admits the gang at its current
                        # size: shrink the PARKED gang toward its floor
                        # until it fits free capacity — running at
                        # min-members beats parking forever (Pollux's
                        # goodput argument). Never below the floor.
                        for k in range(target - 1, spec.floor - 1, -1):
                            if self._fits(
                                snapshot, occ, pods[:k], charge=True
                            ):
                                new_eff = self.gang.set_effective_size(
                                    name, k
                                )
                                if new_eff is not None:
                                    report.resizes[name] = (target, new_eff)
                                    report.admitted_gangs.append(name)
                                    log.info(
                                        "rebalance: shrank parked elastic "
                                        "gang %s %d -> %d to fit free "
                                        "capacity", name, target, new_eff,
                                    )
                                break
                    continue
                self._execute_victims(name, chosen, occ, report)
                # Charge the admitted gang against the freed capacity so
                # the remaining passes cannot re-promise it.
                self._fits(snapshot, occ, members, charge=True)
                report.admitted_gangs.append(name)
        finally:
            for _, _, qpis in held:
                for q in qpis:
                    self.queue.readd(q)
            if held:
                self.queue.move_all_to_active()

    def _select_victims(
        self, snapshot, occ, gang_pods, prio: int
    ) -> "list[_VictimUnit] | None":
        """Cheapest victim set admitting ``gang_pods`` whole: units sorted
        by (highest member priority, priority-weighted work), added
        greedily into a simulated occupancy until the gang fits. None =
        no feasible set within ``max_victims`` pods."""
        gangs, singles = self._bound_by_gang(snapshot)
        units: list[_VictimUnit] = []
        for pod, host in singles:
            p = pod_priority(pod)
            if p >= prio:
                continue
            units.append(_VictimUnit([(pod, host)], p, priority_weight(pod)))
        for name, members in gangs.items():
            prios = [pod_priority(p) for p, _ in members]
            if max(prios) >= prio:
                continue
            spec = self._spec_of([p for p, _ in members])
            weight = sum(priority_weight(p) for p, _ in members)
            if (
                spec is not None
                and spec.elastic
                and len(members) > spec.floor
            ):
                # Elastic shrink: the cheapest partial form — the gang
                # keeps running at its floor, only the surplus is evicted.
                surplus = sorted(
                    members, key=lambda m: m[0].creation_seq, reverse=True
                )[: len(members) - spec.floor]
                units.append(
                    _VictimUnit(
                        surplus,
                        max(prios),
                        sum(priority_weight(p) for p, _ in surplus),
                        gang=name,
                        keep=spec.floor,
                    )
                )
            units.append(
                _VictimUnit(list(members), max(prios), weight, gang=name)
            )
        units.sort(key=lambda u: (u.max_priority, u.weight))
        # Two greedy rounds: shrink units are cheaper but cap a gang's
        # contribution at its surplus — when only a WHOLE eviction of that
        # gang admits the target, the shrink pick would block it (one unit
        # per gang), so a failed first round retries without shrinks.
        pools = [units]
        if any(u.keep is not None for u in units):
            pools.append([u for u in units if u.keep is None])
        for pool in pools:
            chosen = self._greedy_pick(snapshot, occ, gang_pods, pool)
            if chosen is not None:
                return chosen
        return None

    def _greedy_pick(
        self, snapshot, occ, gang_pods, units: "list[_VictimUnit]"
    ) -> "list[_VictimUnit] | None":
        sim = occ.clone()
        chosen: list[_VictimUnit] = []
        chosen_gangs: set[str] = set()
        n_pods = 0
        for unit in units:
            if unit.gang is not None and unit.gang in chosen_gangs:
                continue  # one unit per gang — no double-free
            if n_pods + len(unit.members) > self.max_victims:
                continue
            for pod, host in unit.members:
                try:
                    sim.release(host, max(pod_request(pod).effective_chips, 1))
                except LabelParseError:
                    sim.release(host, 1)
            chosen.append(unit)
            if unit.gang is not None:
                chosen_gangs.add(unit.gang)
            n_pods += len(unit.members)
            if self._fits(snapshot, sim, gang_pods, charge=False):
                return chosen
        return None

    def _execute_victims(
        self, for_gang: str, chosen: "list[_VictimUnit]", occ, report
    ) -> None:
        if self.scheduler._fenced():
            return
        weight = 0
        for unit in chosen:
            why = (
                f"rebalance: preempted to admit parked gang {for_gang} "
                f"(victim {unit.kind})"
            )
            if unit.kind == "shrink":
                new_eff = self.gang.set_effective_size(unit.gang, unit.keep)
                if new_eff is not None:
                    report.resizes[unit.gang] = (
                        len(unit.members) + unit.keep, new_eff
                    )
            for pod, _host in unit.members:
                if unit.gang is not None:
                    self.gang.drop_membership(pod)
            self._unbind_all(unit.members, why)
            for pod, host in unit.members:
                try:
                    chips = max(pod_request(pod).effective_chips, 1)
                except LabelParseError:
                    chips = 1
                occ.release(host, chips)
                report.preempted.append(pod.key)
                weight += priority_weight(pod)
        report.preempted_weight += weight
        log.info(
            "rebalance: preempted %d pod(s) in %d unit(s) (weight %d) to "
            "admit gang %s",
            sum(len(u.members) for u in chosen), len(chosen), weight, for_gang,
        )

    # --- (2) elastic resize up ---

    def _resize_up_pass(self, snapshot, occ, report: RebalanceReport) -> None:
        pending = self.queue.pending_gangs()
        resized = False
        for name in sorted(pending):
            status = self.gang.gang_status(name)
            if status is None:
                continue
            _size, waiting, bound = status
            if waiting > 0 or bound == 0:
                continue  # mid-flight, or not running — not a grow target
            eff = self.gang.effective_size(name)
            if eff is None or bound < eff:
                continue  # gang not complete at its current size
            qpis = self.queue.take_gang(name)
            try:
                pods = [q.pod for q in qpis]
                spec = self._spec_of(pods)
                if spec is None or not spec.elastic:
                    continue
                room = spec.ceiling - eff
                if room <= 0 or not pods:
                    continue
                grow: list[PodSpec] = []
                for pod in pods[:room]:
                    if self._fits(snapshot, occ, [pod], charge=True):
                        grow.append(pod)
                    else:
                        break
                if not grow:
                    continue
                new_eff = self.gang.set_effective_size(name, eff + len(grow))
                if new_eff is not None and new_eff != eff:
                    resized = True
                    report.resizes[name] = (eff, new_eff)
                    log.info(
                        "rebalance: grew elastic gang %s %d -> %d into free "
                        "capacity", name, eff, new_eff,
                    )
            finally:
                for q in qpis:
                    self.queue.readd(q)
        if resized:
            # Parked surplus members re-admit against the raised size.
            self.queue.move_all_to_active()

    # --- (3) repack (background defragmentation) ---

    def _repack_pass(self, snapshot, occ, report: RebalanceReport) -> None:
        if self.max_moves <= 0:
            return
        gangs, _singles = self._bound_by_gang(snapshot)
        for name in sorted(gangs):
            if len(report.moves) >= self.max_moves:
                return
            members = gangs[name]
            spec = self._spec_of([p for p, _ in members])
            if spec is None or spec.topology is None:
                continue  # repack targets ICI blocks
            if len(members) < spec.size:
                continue  # partial gang: the reconciler's problem, not ours
            status = self.gang.gang_status(name)
            if status is not None and status[1] > 0:
                continue  # members waiting at Permit: mid-flight
            try:
                chips = max(pod_request(members[0][0]).effective_chips, 1)
            except LabelParseError:
                continue
            cur_hosts = {host for _, host in members}
            sim = occ.clone()
            for _pod, host in members:
                sim.release(host, chips)
            fenced = getattr(snapshot, "fenced", frozenset())
            plan = plan_multislice_placement(
                snapshot,
                want_dims=spec.topology,
                slices=spec.slices,
                host_ok=lambda ni: (
                    ni.name not in fenced
                    and sim.free_chips(ni.name) >= chips
                    and pod_admits_on(ni.node, members[0][0])[0]
                ),
            )
            if plan is None or set(plan) == cur_hosts:
                continue
            for host in plan:
                sim.occupy(host, chips)
            gain = occ.score() - sim.score()
            if gain < self.min_gain:
                continue
            if self._execute_move(name, spec, members, plan, report):
                # Commit the simulated state as this pass's ledger.
                for _pod, host in members:
                    occ.release(host, chips)
                for host in plan:
                    occ.occupy(host, chips)

    def _execute_move(
        self, name: str, spec, members, plan, report: RebalanceReport
    ) -> bool:
        """The transactional move primitive: take -> unbind -> install plan
        -> readd. Any member left bound (unbind refused, fence flipped)
        aborts the plan install — the unbound members requeue and the gang
        replans around the stragglers through the normal admission path,
        never split, never oversubscribed."""
        qpis = self.queue.take_gang(name)
        try:
            if self.scheduler._fenced():
                report.aborted_moves.append(name)
                return False
            why = f"rebalance: repacking gang {name} onto a tighter ICI block"
            for pod, _host in members:
                self.gang.drop_membership(pod)
            self._unbind_all(list(members), why)
            stranded = []
            for pod, _host in members:
                try:
                    live = self.cluster.get_pod(pod.key)
                except Exception:  # noqa: BLE001 — unreadable: assume stranded
                    live = pod
                if live is not None and live.node_name:
                    stranded.append(pod.key)
            if stranded:
                log.warning(
                    "rebalance: move of gang %s aborted — %d member(s) "
                    "could not be unbound (%s); gang will replan normally",
                    name, len(stranded), stranded[:3],
                )
                report.aborted_moves.append(name)
                return False
            self.gang.install_plan(name, spec, plan)
            report.moves.append(name)
            log.info(
                "rebalance: moved gang %s onto block %s (was %s)",
                name, sorted(plan), sorted({h for _, h in members}),
            )
            return True
        finally:
            for q in qpis:
                self.queue.readd(q)
            self.queue.move_all_to_active()
