"""Preemption: the modern-PostFilter plugin — evict lower-priority pods so a
pod (or gang) that failed Filter can be placed.

Semantics (modeled on upstream DefaultPreemption, adapted to the exclusive
TPU-chip model):

- Only pods with strictly LOWER ``tpu/priority`` than the preemptor are
  eligible victims; victims are chosen lowest-priority-first, then
  newest-first (minimize lost work).
- Single pod: pick the node whose minimal victim set is cheapest —
  ordered by (highest victim priority, victim count, freed chips) — evict,
  and nominate that node. The preemptor retries once the deletions free
  capacity (the accountant releases chips on the pod-delete watch event).
- Plain gang: buy one member slot at a time from whichever node sells it
  cheapest until every not-yet-placed member (gang size minus bound minus
  parked-at-Permit) has a slot.
- Topology gang, no members waiting: re-run the slice sub-block search
  (plugins/yoda/topology.py) with "feasible after evicting this host's
  eligible victims" as the host predicate, pinned around already-bound
  members; evict the minimal per-host victim sets of the chosen block.
- Topology gang, members parked at Permit: the plan is frozen, so eviction
  is restricted to squatters on the plan's not-yet-reserved hosts.

Capacity simulation assumes a victim's chips return via the accountant's
release-on-delete (plugins/yoda/accounting.py), i.e. ``reserved`` shrinks by
the victim's effective chips immediately.

Counterpart of ``yoda_tpu/plugins/yoda/preemption.py``, whole but for the
parts of the scheduler this port does not have yet:

- No volume, CSI attach-limit or inter-pod checks (the reference's
  ``_attach_fits``, ``_attach_possible``, ``_fits_attach_after``,
  ``volumes_feasible`` and required pod affinity). Pods that need them are
  refused as unresolvable by the port's PreFilter
  (``filter_plugin.unported_constraint``), so they never reach PostFilter.
- The Permit-parked hostPort claims come from the PreFilter's own feed
  (``filter_plugin.get_pending_ports``): the port has no AffinityData.
- No PodDisruptionBudget watch yet: ``pdbs_fn`` stays None, so the
  disruption-allowance preference (``_PdbLedger``) is skipped and budgets
  act only through refused evictions — the reference's own path when no
  PDB watch is live.
- No leader fencing: ``fenced_fn`` stays None.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Callable, Mapping

from yoda_tpu_torch.api.requests import (
    LabelParseError,
    TpuRequest,
    gang_name_of,
    pod_request,
)
from yoda_tpu_torch.api.types import PodSpec, host_ports_conflict, pod_admits_on
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import (
    NodeInfo,
    PostFilterPlugin,
    Snapshot,
    Status,
)
from yoda_tpu_torch.plugins.yoda.filter_plugin import (
    REQUEST_KEY,
    apparently_used_chips,
    available_chips,
    get_pending_ports,
    get_request,
    node_fits_host_ports,
    qualifying_chips,
)
from yoda_tpu_torch.plugins.yoda.sort import pod_priority
from yoda_tpu_torch.plugins.yoda.topology import plan_multislice_placement

log = logging.getLogger("yoda_tpu_torch.preemption")

# Permit-parked hostPort claims per node (filter_plugin.get_pending_ports).
PendingPorts = dict[str, tuple] | None


@dataclass(frozen=True)
class Victim:
    pod: PodSpec
    node: str
    priority: int
    chips: int

    @property
    def eviction_order(self) -> tuple[int, int]:
        """Lowest priority first; among equals, newest first."""
        return (self.priority, -self.pod.creation_seq)


class _PdbLedger:
    """Disruption allowances for one victim-selection pass (upstream
    DefaultPreemption's PDB-violation preference). Duck-typed over budget
    objects with ``matches(pod)``, ``key`` and
    ``allowed_disruptions(matching)``; ``would_violate`` is stateful via the
    caller's ``consumed`` map so a second victim under a one-disruption
    budget counts as the violation it is. A ledger only steers victim
    PREFERENCE — the eviction API remains the enforcement point."""

    def __init__(self, pdbs, pods) -> None:
        self._pdbs = []
        for pdb in pdbs:
            matching = sum(1 for p in pods if pdb.matches(p))
            self._pdbs.append((pdb, pdb.allowed_disruptions(matching)))

    def would_violate(self, pod: PodSpec, consumed: dict[str, int]) -> bool:
        for pdb, allowed in self._pdbs:
            if pdb.matches(pod) and consumed.get(pdb.key, 0) + 1 > allowed:
                return True
        return False

    def consume(self, pod: PodSpec, consumed: dict[str, int]) -> None:
        for pdb, _ in self._pdbs:
            if pdb.matches(pod):
                consumed[pdb.key] = consumed.get(pdb.key, 0) + 1


class TpuPreemption(PostFilterPlugin):
    name = "yoda-preemption"

    def __init__(
        self,
        # Returns False when the eviction was refused (FakeCluster.evict_pod
        # on a protected pod); None/True = accepted.
        evict_fn: Callable[[str], "bool | None"],
        *,
        # The cluster's PodDisruptionBudgets, or None when no budget watch
        # is live (then the violation preference is skipped).
        pdbs_fn: "Callable[[], list | None] | None" = None,
        reserved_fn: Callable[[str], int] | None = None,
        gang_status_fn: Callable[[str], tuple[int, int, int] | None] | None = None,
        gang_plan_fn: Callable[[str], list[str] | None] | None = None,
        on_evicted: Callable[[int], None] | None = None,
        on_victim: Callable[[Victim], None] | None = None,
        scheduler_name: str = "yoda-tpu",
        scheduler_names: "tuple[str, ...] | None" = None,
        select_lock: "threading.Lock | None" = None,
    ) -> None:
        self.evict_fn = evict_fn
        self.pdbs_fn = pdbs_fn
        # Leader fence, re-checked right before the evictions; None =
        # unfenced.
        self.fenced_fn: "Callable[[], bool] | None" = None
        # Held during victim SELECTION (snapshot and reserved_fn reads):
        # the scheduler's cycle lock, so selection cannot race a Filter ->
        # Reserve. The evictions run outside it.
        self.select_lock = select_lock or threading.Lock()
        self.reserved_fn = reserved_fn
        self.gang_status_fn = gang_status_fn
        self.gang_plan_fn = gang_plan_fn
        self.on_evicted = on_evicted
        self.on_victim = on_victim
        self.scheduler_name = scheduler_name
        # Every schedulerName whose pods the accountant charges: the "ours"
        # victim rules must match its occupancy rules.
        self.scheduler_names = frozenset(scheduler_names or (scheduler_name,))
        self._lock = threading.Lock()
        self.preempted_total = 0  # pods evicted

    # --- victim discovery ---

    def _victim_of(self, pod: PodSpec, node: str) -> Victim | None:
        """The pod as an eviction candidate, or None if it occupies no chips
        (not ours and no TPU request). Mirrors the accountant's occupancy
        rules (plugins/yoda/accounting.py)."""
        try:
            req = pod_request(pod)
        except LabelParseError:
            # A valid google.com/tpu limit occupies real chips and must be
            # evictable; a parseable tpu/priority still ranks the pod even
            # when another label is malformed (sort.pod_priority).
            prio = pod_priority(pod)
            if pod.tpu_resource_limit > 0:
                return Victim(pod, node, prio, pod.tpu_resource_limit)
            if pod.scheduler_name not in self.scheduler_names:
                return None
            return Victim(pod, node, prio, 1)
        if not req.wants_tpu and pod.scheduler_name not in self.scheduler_names:
            return None
        return Victim(pod, node, req.priority, req.effective_chips)

    def _victims_on(self, ni: NodeInfo, max_priority: int) -> list[Victim]:
        out = []
        for pod in ni.pods:
            v = self._victim_of(pod, ni.name)
            if v is not None and v.priority < max_priority:
                out.append(v)
        out.sort(key=lambda v: v.eviction_order)
        return out

    def _node_eligible(self, ni: NodeInfo, req: TpuRequest, pod: PodSpec) -> bool:
        """Eviction can only ever help on nodes the preemptor could pass
        Filter on once capacity frees up: generation and cordon/taints are
        immutable within this cycle, and a node whose non-victim floor
        exceeds allocatable never fits. hostPort conflicts are NOT checked
        here: eviction cures them (:meth:`_port_blockers`)."""
        return (
            ni.tpu is not None
            and ni.tpu.generation_rank >= req.min_generation_rank
            and pod_admits_on(ni.node, pod)[0]
            and self._resources_possible(ni, req, pod)
        )

    def _port_blockers(
        self,
        ni: NodeInfo,
        pod: PodSpec,
        max_priority: int,
        pending_ports: PendingPorts = None,
    ) -> "list[Victim] | None":
        """The victims whose eviction cures the preemptor's hostPort
        conflicts on this node. [] = no conflict; None = incurable: a holder
        is not evictable (priority too high) or the conflict is with an
        in-flight Permit-parked placement, which cannot be evicted."""
        if not pod.host_ports:
            return []
        if pending_ports:
            for theirs in pending_ports.get(ni.name, ()):
                if any(
                    host_ports_conflict(ours, theirs) for ours in pod.host_ports
                ):
                    return None
        blockers: list[Victim] = []
        for other in ni.pods:
            if not any(
                host_ports_conflict(ours, theirs)
                for theirs in other.host_ports
                for ours in pod.host_ports
            ):
                continue
            v = self._victim_of(other, ni.name)
            if v is None:
                # Chip-free foreign pod holding the port: a mandatory
                # victim, evictable iff below the preemptor.
                v = Victim(other, ni.name, pod_priority(other), 0)
            if v.priority >= max_priority:
                return None
            blockers.append(v)
        return blockers

    def _resources_possible(
        self, ni: NodeInfo, req: TpuRequest, pod: PodSpec
    ) -> bool:
        """Could cpu/memory/pod-count allocatable fit the preemptor after
        evicting EVERY eligible victim? Non-victim pods keep their requests;
        if that floor alone exceeds allocatable, eviction is waste here.
        Gated so nodes/pods that declare nothing pay nothing."""
        node = ni.node
        if node is None:
            return True
        relevant = (
            node.alloc_pods
            or (pod.cpu_milli_request and node.alloc_cpu_milli)
            or (pod.memory_request and node.alloc_memory)
        )
        if not relevant:
            return True
        floor_cpu = floor_mem = floor_n = 0
        for p in ni.pods:
            v = self._victim_of(p, ni.name)
            if v is not None and v.priority < req.priority:
                continue  # evictable: its requests can be freed
            floor_cpu += p.cpu_milli_request
            floor_mem += p.memory_request
            floor_n += 1
        if node.alloc_pods and floor_n + 1 > node.alloc_pods:
            return False
        if (
            pod.cpu_milli_request
            and node.alloc_cpu_milli
            and floor_cpu + pod.cpu_milli_request > node.alloc_cpu_milli
        ):
            return False
        if (
            pod.memory_request
            and node.alloc_memory
            and floor_mem + pod.memory_request > node.alloc_memory
        ):
            return False
        return True

    def _fits_resources_after(
        self, ni: NodeInfo, pod: PodSpec, chosen: "list[Victim]"
    ) -> bool:
        """Does cpu/memory/pod-count allocatable fit the preemptor once
        exactly ``chosen`` are evicted? _minimal_set keeps buying victims
        until both chips and resources fit."""
        node = ni.node
        if node is None:
            return True
        relevant = (
            node.alloc_pods
            or (pod.cpu_milli_request and node.alloc_cpu_milli)
            or (pod.memory_request and node.alloc_memory)
        )
        if not relevant:
            return True
        gone = {v.pod.uid for v in chosen}
        live = [p for p in ni.pods if p.uid not in gone]
        if node.alloc_pods and len(live) + 1 > node.alloc_pods:
            return False
        if pod.cpu_milli_request and node.alloc_cpu_milli:
            used = sum(p.cpu_milli_request for p in live)
            if used + pod.cpu_milli_request > node.alloc_cpu_milli:
                return False
        if pod.memory_request and node.alloc_memory:
            used = sum(p.memory_request for p in live)
            if used + pod.memory_request > node.alloc_memory:
                return False
        return True

    def _avail_after(self, ni: NodeInfo, req: TpuRequest, freed: int) -> int:
        """Qualifying chips claimable once victims freeing ``freed`` chips
        are gone.

        Each occupied chip is charged EXACTLY once: as an accountant
        reservation whose chip still reads fully free (before the node
        agent's refresh), or as metrics-visible HBM use (after). Eviction
        therefore credits one claimable chip per freed chip, EXCEPT visible
        chips that can never serve this request (hbm_total/clock too
        small); the victims' split between the two forms is unknown, so the
        worst case is assumed. Conservative: may pick one victim more than
        strictly needed, never evicts a set that cannot make the preemptor
        schedulable."""
        # With an accounting source: availability after is exactly
        # available_chips at reserved - freed (monotone in ``freed``, and
        # the same stale-freed credit as the Filter path).
        reserved = self.reserved_fn(ni.name) if self.reserved_fn else None
        if reserved is not None:
            return available_chips(ni.tpu, req, max(reserved - freed, 0))
        if freed == 0:
            return available_chips(ni.tpu, req, None)
        # No accounting: metrics-only worst case.
        unused = sum(
            1 for c in qualifying_chips(ni.tpu, req) if c.hbm_free >= c.hbm_total
        )
        visible = apparently_used_chips(ni.tpu)
        qualifiable_visible = sum(
            1
            for c in ni.tpu.chips
            if c.healthy
            and c.hbm_free < c.hbm_total
            and c.hbm_total >= req.hbm_per_chip
            and c.clock_mhz >= req.min_clock_mhz
        )
        unqualifiable_visible = max(visible - qualifiable_visible, 0)
        credit = freed - min(freed, unqualifiable_visible)
        return unused + credit

    def _minimal_set(
        self,
        ni: NodeInfo,
        req: TpuRequest,
        needed: int,
        max_priority: int,
        pod: PodSpec,
        pending_ports: PendingPorts = None,
        ledger: "_PdbLedger | None" = None,
    ) -> list[Victim] | None:
        """Smallest victim set making ``needed`` member slots of ``req``
        available on the node, or None. hostPort-conflicting holders are
        mandatory members; the rest are bought in eviction order, except
        that victims whose eviction would violate a budget are deferred
        behind every non-violating one."""
        if not self._node_eligible(ni, req, pod):
            return None
        blockers = self._port_blockers(ni, pod, max_priority, pending_ports)
        if blockers is None:
            return None
        forced = {b.pod.uid for b in blockers}
        victims = [
            v for v in self._victims_on(ni, max_priority)
            if v.pod.uid not in forced
        ]
        if ledger is not None and victims:
            consumed: dict[str, int] = {}
            for b in blockers:
                ledger.consume(b.pod, consumed)
            ordered: list[Victim] = []
            remaining = list(victims)
            while remaining:
                pick = next(
                    (
                        v for v in remaining
                        if not ledger.would_violate(v.pod, consumed)
                    ),
                    remaining[0],
                )
                remaining.remove(pick)
                ledger.consume(pick.pod, consumed)
                ordered.append(pick)
            victims = ordered
        chosen: list[Victim] = list(blockers)
        freed = sum(b.chips for b in blockers)
        want = needed * max(req.effective_chips, 1)
        for v in [None, *victims]:
            if v is not None:
                chosen.append(v)
                freed += v.chips
            if (
                self._avail_after(ni, req, freed) >= want
                and self._fits_resources_after(ni, pod, chosen)
            ):
                return chosen
        return None

    def _ledger(self, snapshot: Snapshot) -> "_PdbLedger | None":
        """The disruption-allowance ledger for one selection pass; None
        when no budget data is live or no budgets exist."""
        if self.pdbs_fn is None:
            return None
        pdbs = self.pdbs_fn()
        if not pdbs:
            return None
        pods = [p for ni in snapshot.infos() for p in ni.pods]
        return _PdbLedger(pdbs, pods)

    def _violation_count(
        self, victims: "list[Victim]", ledger: "_PdbLedger | None"
    ) -> int:
        if ledger is None:
            return 0
        consumed: dict[str, int] = {}
        n = 0
        for v in victims:
            if ledger.would_violate(v.pod, consumed):
                n += 1
            ledger.consume(v.pod, consumed)
        return n

    # --- PostFilter ---

    def post_filter(
        self,
        state: CycleState,
        pod: PodSpec,
        snapshot: Snapshot,
        filtered_statuses: Mapping[str, Status],
    ) -> tuple[str | None, Status]:
        if not state.contains(REQUEST_KEY):
            # Label parsing itself failed; eviction cannot help.
            return None, Status.unschedulable("no parsed request; cannot preempt")
        req = get_request(state)
        if pod.preemption_policy == "Never":
            # Upstream PriorityClass preemptionPolicy=Never: the pod queues
            # at its priority but must not displace anyone.
            return None, Status.unschedulable(
                f"{pod.key} has preemptionPolicy=Never; not evicting"
            )
        pending_ports = get_pending_ports(state)
        if req.gang is not None:
            return self._preempt_for_gang(pod, req, snapshot, pending_ports)
        return self._preempt_for_pod(pod, req, snapshot, pending_ports)

    def _preempt_for_pod(
        self,
        pod: PodSpec,
        req: TpuRequest,
        snapshot: Snapshot,
        pending_ports: PendingPorts = None,
    ) -> tuple[str | None, Status]:
        best: tuple[tuple[int, int, int, int, str], list[Victim], str] | None = None
        with self.select_lock:
            ledger = self._ledger(snapshot)
            for ni in snapshot.infos():
                victims = self._minimal_set(
                    ni, req, 1, req.priority, pod, pending_ports, ledger
                )
                if not victims:
                    continue
                # Fewest budget violations dominate, then the cheapness key.
                cost = (
                    self._violation_count(victims, ledger),
                    max(v.priority for v in victims),
                    len(victims),
                    sum(v.chips for v in victims),
                    ni.name,
                )
                if best is None or cost < best[0]:
                    best = (cost, victims, ni.name)
        if best is None:
            return None, Status.unschedulable(
                f"no node can host {pod.key} even after preempting "
                f"pods below priority {req.priority}"
            )
        _, victims, node = best
        evicted, refused = self._evict_or_refused(
            victims,
            f"eviction of all {len(victims)} victim(s) on {node} was "
            "refused (disruption budgets); retrying later",
        )
        if refused is not None:
            return None, refused
        return node, Status(
            message=f"preempted {evicted} pod(s) on {node} for {pod.key}"
        )

    def _preempt_for_gang(
        self,
        pod: PodSpec,
        req: TpuRequest,
        snapshot: Snapshot,
        pending_ports: PendingPorts = None,
    ) -> tuple[str | None, Status]:
        gang = req.gang
        assert gang is not None
        waiting, bound = 0, 0
        if self.gang_status_fn is not None:
            st = self.gang_status_fn(gang.name)
            if st is not None:
                _, waiting, bound = st
        remaining = max(gang.size - bound - waiting, 1)
        if gang.topology is not None:
            if waiting:
                return self._preempt_on_planned_hosts(pod, req, snapshot, pending_ports)
            return self._preempt_for_topology_gang(pod, req, snapshot, pending_ports)

        # Plain gang: evict globally-cheapest victims until enough slots,
        # selection under the shared select lock.
        with self.select_lock:
            ledger = self._ledger(snapshot)
            per_node: dict[str, list[Victim]] = {}
            slots = 0
            for ni in snapshot.infos():
                if not self._node_eligible(ni, req, pod):
                    continue
                # Conservative port rule for PLAIN gangs only: members share
                # host_ports, so several can never co-land on one node and
                # the slot math does not model forced port victims — skip
                # conflicted nodes.
                if not node_fits_host_ports(ni, pod, pending_ports)[0]:
                    continue
                slots += self._avail_after(ni, req, 0) // max(req.effective_chips, 1)
                per_node[ni.name] = self._victims_on(ni, req.priority)
            if slots >= remaining:
                # Capacity exists now (freed since Filter ran): retry, no
                # eviction needed.
                return None, Status.unschedulable("capacity already free; retry")
            # Buy one member slot at a time from whichever node sells it
            # cheapest (lowest max victim priority, then fewest victims): a
            # per-node minimal set, NOT a flat global order — when a member
            # needs a whole host, spreading evictions across hosts frees
            # nothing.
            chosen: list[Victim] = []
            freed_by_node: dict[str, int] = {}
            victims_left = dict(per_node)
            while slots < remaining:
                best: tuple[tuple[int, int, int, int, str], str, list[Victim], int] | None = None
                for name, vs in victims_left.items():
                    if not vs:
                        continue
                    ni = snapshot.get(name)
                    freed = freed_by_node.get(name, 0)
                    base = self._member_slots_after(ni, req, freed, pod)
                    acc, prefix = 0, []
                    for v in vs:
                        prefix.append(v)
                        acc += v.chips
                        gained = (
                            self._member_slots_after(ni, req, freed + acc, pod) - base
                        )
                        if gained > 0:
                            # Budget violations dominate the slot price,
                            # counted against the already-chosen set.
                            cost = (
                                self._violation_count([*chosen, *prefix], ledger)
                                - self._violation_count(chosen, ledger),
                                max(x.priority for x in prefix),
                                len(prefix),
                                acc,
                                name,
                            )
                            if best is None or cost < best[0]:
                                best = (cost, name, list(prefix), gained)
                            break
                if best is None:
                    return None, Status.unschedulable(
                        f"gang {gang.name}: evicting every lower-priority pod "
                        f"still yields {slots} slots < {remaining} members"
                    )
                _, name, prefix, gained = best
                chosen.extend(prefix)
                freed_by_node[name] = freed_by_node.get(name, 0) + sum(
                    v.chips for v in prefix
                )
                victims_left[name] = victims_left[name][len(prefix):]
                slots += gained
        evicted, refused = self._evict_or_refused(
            chosen,
            f"gang {gang.name}: every victim eviction was refused "
            "(disruption budgets); retrying later",
        )
        if refused is not None:
            return None, refused
        return chosen[-1].node, Status(
            message=(
                f"preempted {evicted} pod(s) for gang {gang.name} "
                f"({remaining} members needed slots)"
            )
        )

    def _member_slots_after(
        self, ni: NodeInfo, req: TpuRequest, freed: int, pod: PodSpec
    ) -> int:
        if not self._node_eligible(ni, req, pod):
            return 0
        return self._avail_after(ni, req, freed) // max(req.effective_chips, 1)

    def _preempt_on_planned_hosts(
        self,
        pod: PodSpec,
        req: TpuRequest,
        snapshot: Snapshot,
        pending_ports: PendingPorts = None,
    ) -> tuple[str | None, Status]:
        """Mid-flight topology gang: members wait at Permit, the plan is
        frozen — evict squatters from the plan's unreserved hosts only."""
        gang = req.gang
        assert gang is not None
        hosts = self.gang_plan_fn(gang.name) if self.gang_plan_fn else None
        if not hosts:
            return None, Status.unschedulable(
                f"gang {gang.name}: members parked at Permit but no plan "
                "hosts to clear; waiting for the permit window"
            )
        victims: list[Victim] = []
        clear: list[str] = []
        with self.select_lock:
            ledger = self._ledger(snapshot)
            for h in hosts:
                if h not in snapshot:
                    continue
                vs = self._minimal_set(
                    snapshot.get(h), req, 1, req.priority, pod, pending_ports, ledger
                )
                if vs is None:
                    continue
                clear.append(h)
                victims.extend(vs)
        if not victims or len(clear) < len(hosts):
            return None, Status.unschedulable(
                f"gang {gang.name}: planned hosts cannot all be cleared by "
                f"preempting below priority {req.priority}"
            )
        evicted, refused = self._evict_or_refused(
            victims,
            f"gang {gang.name}: squatter evictions were all refused "
            "(disruption budgets); retrying later",
        )
        if refused is not None:
            return None, refused
        return clear[0], Status(
            message=(
                f"preempted {evicted} squatter(s) on gang {gang.name}'s "
                f"planned hosts {clear}"
            )
        )

    def _preempt_for_topology_gang(
        self,
        pod: PodSpec,
        req: TpuRequest,
        snapshot: Snapshot,
        pending_ports: PendingPorts = None,
    ) -> tuple[str | None, Status]:
        gang = req.gang
        assert gang is not None and gang.topology is not None
        # Pin hosts of already-bound members: the block must complete around
        # them (the gang admission's rule).
        pinned: dict[str, tuple[int, int, int]] = {}
        for ni in snapshot.infos():
            for p in ni.pods:
                if gang_name_of(p.labels) == gang.name and ni.tpu is not None:
                    pinned[ni.name] = ni.tpu.topology_coords

        # Per-host victim sets, memoized: host_ok computes them during the
        # block search; the chosen block reuses them below.
        sets: dict[str, list[Victim] | None] = {}
        ledger = self._ledger(snapshot)

        def host_ok(ni: NodeInfo) -> bool:
            if ni.name not in sets:
                sets[ni.name] = self._minimal_set(
                    ni, req, 1, req.priority, pod, pending_ports, ledger
                )
            return sets[ni.name] is not None

        with self.select_lock:
            plan = plan_multislice_placement(
                snapshot,
                want_dims=gang.topology,
                slices=gang.slices,
                host_ok=host_ok,
                pinned=pinned,
            )
        if plan is None:
            return None, Status.unschedulable(
                f"gang {gang.name}: no slice forms a "
                f"{'x'.join(map(str, gang.topology))} block even after "
                f"preempting pods below priority {req.priority}"
            )
        victims: list[Victim] = []
        for host in plan:
            if host in pinned:
                continue
            victims.extend(sets.get(host) or [])
        if not victims:
            return None, Status.unschedulable(
                f"gang {gang.name}: planned block is already free; retry"
            )
        evicted, refused = self._evict_or_refused(
            victims,
            f"gang {gang.name}: block victim evictions were all refused "
            "(disruption budgets); retrying later",
        )
        if refused is not None:
            return None, refused
        return next(iter(plan)), Status(
            message=(
                f"preempted {evicted} pod(s) across {len(plan)} host(s) "
                f"for gang {gang.name}"
            )
        )

    def _evict(self, victims: list[Victim]) -> int:
        """Evict the victim set; returns how many evictions the API
        accepted. A refused (False) or raising eviction does not abort the
        rest: surviving victims keep their chips and the preemptor retries
        a later cycle against the remaining occupancy."""
        if self.fenced_fn is not None and self.fenced_fn():
            log.warning(
                "scheduler fenced (not leader); dropping %d planned "
                "eviction(s)", len(victims),
            )
            return 0
        evicted = 0
        for v in victims:
            try:
                ok = self.evict_fn(v.pod.key) is not False
            except Exception as e:  # noqa: BLE001 — the rest still go
                log.warning(
                    "evicting %s failed (%s: %s)", v.pod.key, type(e).__name__, e
                )
                ok = False
            if ok:
                log.info(
                    "evicted %s (priority %d, %d chip(s)) on %s",
                    v.pod.key, v.priority, v.chips, v.node,
                )
                evicted += 1
                if self.on_victim is not None:
                    self.on_victim(v)
        if evicted:
            with self._lock:
                self.preempted_total += evicted
            if self.on_evicted is not None:
                self.on_evicted(evicted)
        return evicted

    def _evict_or_refused(
        self, victims: list[Victim], refused_msg: str
    ) -> "tuple[int, Status | None]":
        """Evict; when EVERY eviction was refused, the preemption attempt
        failed — return the Unschedulable status the caller should report."""
        evicted = self._evict(victims)
        if evicted == 0:
            return 0, Status.unschedulable(refused_msg)
        return evicted, None
