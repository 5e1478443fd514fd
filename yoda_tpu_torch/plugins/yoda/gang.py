"""Gang scheduling: all-or-nothing placement of multi-pod TPU jobs.

A gang is declared by pod labels (``tpu/gang`` + ``tpu/gang-size``,
``tpu/topology``, ``tpu/multislice``, or the coscheduling aliases —
api/requests.py): its members bind atomically or not at all.

Mechanism:

- **PreFilter — admission.** Before any chips are reserved for a member, the
  gang's whole remaining demand is checked against CURRENT free capacity
  (for topology gangs: a concrete slice sub-block plan; otherwise a
  chip-slot count). If the gang cannot complete now, the member is rejected
  up front — a gang never takes partial reservations it cannot finish.
- **Permit — barrier.** Each member reserves its chips, then WAITs on the
  framework waitlist. When waiting + already-bound members reach the gang
  size, all waiting members are allowed and bind together.
- **Rollback.** If any member is rejected or times out, every other waiting
  member of the gang is rejected too (cascade), all reservations roll back
  (framework unreserve path), the topology plan is dropped, and members
  retry via queue backoff — a late member's arrival reactivates them
  immediately through the queue's gang-arrival signal. A member whose bind
  fails after release rolls the whole release back: landed binds are
  unbound and requeued with the rest (``on_bind_failed``).

Hot path: when a member pops with its siblings co-queued, the scheduler
gathers them, the batch plugin evaluates the whole gang — or several
co-queued gangs — in ONE kernel dispatch (YodaBatch.prepare_gang_burst /
prepare_joint_burst), and the member cycles run back-to-back in one loop
turn; the barrier then resolves inside the LAST member's own Permit call.

For topology gangs the plan maps members onto a contiguous ICI sub-block
(plugins/yoda/topology.py); the Filter hook restricts members to planned
hosts (one member per host).

Counterpart of ``yoda_tpu/plugins/yoda/gang.py``: admission for plain and
topology gangs, the Filter pin, Permit and the waitlist callbacks, the
transactional bind rollback, the watch handler (host-death marks, delete
fast path, restart reconstruction), the introspection surfaces, and plain
gangs' inter-pod admission: the PreFilter's AffinityData gates each node,
and a required term matching the gang's own labels caps the slots (self
anti-affinity: one member per domain; self affinity: the largest single
domain, with the members steered into domains that hold the whole
remainder), and the rebalancer surface: elastic resize
(``set_effective_size`` / ``effective_size``: admission and the Permit
barrier count to the effective size, and a surplus member parks until a
resize-up), ``install_plan`` and ``bound_members``, and the Event
recorder's rollback hook (``on_rollback``, called on the triggering member
and on every member the rollback touches), and the bind pipeline: with
``parallel_release`` and a ``bind_executor`` a completed gang's member
binds fan out on the executor and the release returns without draining
them; a member's bind failure parks the landed siblings' unwinds behind
the release barrier (``release_pending``) until every in-flight sibling
has settled, and ``collect_rollbacks`` hands them to the scheduler;
``close()`` shuts the executor; and the scheduler lanes' optimistic
commit: on a lane's stack (``shard``, ``track_commits``) a release cohort
whose binds all landed arms ``collect_commits``, which hands it to the
scheduler's commit flush, and a park's why-pending verdict names the lane.
The
tracer and the why-pending index are here (``tracer`` / ``pending``, wired by
``build_stack``): gang-release and gang-rollback spans on the gang's
trace, and a topology park's verdict with a walk over the fleet naming
each host's reason — fenced, no metrics, cannot take a member, or
feasible but outside any free block. The node-health fence is here: a host in
``snapshot.fenced`` (SUSPECT / DRAINING / DOWN) never counts toward a plain
gang's slots and never enters a topology plan.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Callable

from yoda_tpu_torch.api.requests import GangSpec, gang_name_of
from yoda_tpu_torch.api.types import PodSpec, pod_admits_on
from yoda_tpu_torch.cluster.fake import Event
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import (
    FilterPlugin,
    NodeInfo,
    PermitPlugin,
    PreFilterPlugin,
    Snapshot,
    Status,
)
from yoda_tpu_torch.plugins.yoda.filter_plugin import (
    available_chips,
    get_affinity,
    get_pending_resources,
    get_request,
    node_fits_resources,
)
from yoda_tpu_torch.plugins.yoda.topology import plan_multislice_placement

log = logging.getLogger("yoda_tpu_torch.gang")

ALLOWED_HOSTS_KEY = "yoda-gang/allowed-hosts"
# Members of this pod's gang still unplaced (this pod included) — written at
# admission so the batch plugin can place the WHOLE remainder from one
# kernel dispatch (plugins/yoda/batch.py gang plan).
GANG_REMAINING_KEY = "yoda-gang/remaining"


@dataclass(frozen=True)
class _AllowedHosts:
    hosts: frozenset[str]

    def clone(self) -> "_AllowedHosts":
        return self


@dataclass(frozen=True)
class _GangRemaining:
    count: int

    def clone(self) -> "_GangRemaining":
        return self


@dataclass
class _GangState:
    spec: GangSpec
    waiting: set[str] = field(default_factory=set)       # pod keys on waitlist
    bound: set[str] = field(default_factory=set)         # pod keys bound
    assigned: dict[str, str] = field(default_factory=dict)  # pod key -> host
    # pod key -> the member's PodSpec, recorded at Permit so in-flight
    # (reserved-but-unbound) members' resource claims are visible to
    # admission (pending_placements). Pruned with ``assigned``.
    specs: dict[str, PodSpec] = field(default_factory=dict)
    plan: dict[str, tuple[int, int, int]] | None = None  # host -> coord
    failing: bool = False
    # Transactional bind rollback: the member keys of the CURRENT waitlist
    # release, the subset whose binds already landed (key -> host), and
    # whether a bind in this release failed — reset at each release start.
    release_cohort: set[str] = field(default_factory=set)
    release_bound: dict[str, str] = field(default_factory=dict)
    bind_failed: bool = False
    # Completion barrier (the bind pipeline): members of the release whose
    # bind has not SETTLED yet (landed, failed, or was cascade-rejected
    # before binding). After a failure, the landed binds to unwind park in
    # release_rollbacks until the barrier drains — rollback API writes
    # fire only once every in-flight sibling has settled
    # (collect_rollbacks), never while a bind is mid-air.
    release_pending: set[str] = field(default_factory=set)
    release_rollbacks: list = field(default_factory=list)  # (spec, host, why)
    rollback_ready: bool = False
    # Optimistic shard commit (scheduler shard-out): armed when a release
    # cohort FULLY lands (every bind settled, none failed) on a stack
    # whose gang plugin tracks commits — the scheduler then validates the
    # cohort's staged claims at the shared accountant and rolls the gang
    # back whole on a conflict. Never set on unsharded stacks
    # (track_commits False).
    commit_ready: bool = False
    # Hosts that died (value: which kinds' deletion marked them — a Node
    # deletion is only cleared by a Node re-add, not by the agent's CR
    # republish, and vice versa). Marked on EVERY gang so a death landing
    # between a member's Reserve and its waitlist registration is still
    # caught by on_pod_waiting; cleared ONLY per kind on host re-add, so
    # zombie-pod watch events cannot resurrect a lost membership.
    dead_hosts: dict[str, set[str]] = field(default_factory=dict)
    # Elastic gangs: the CURRENT effective size, moved by the rebalancer
    # (set_effective_size). None = the declared spec.size. The Permit
    # barrier releases at it and admission admits up to it.
    eff_size: int | None = None


class GangPlugin(PreFilterPlugin, FilterPlugin, PermitPlugin):
    name = "yoda-gang"

    def __init__(
        self,
        *,
        timeout_s: float = 120.0,
        reserved_fn: Callable[[str], int] | None = None,
        on_rollback: Callable[[PodSpec, str, str], None] | None = None,
        parallel_release: bool = False,
        bind_executor=None,
    ) -> None:
        self.timeout_s = timeout_s
        self.reserved_fn = reserved_fn
        # Pipelined release: with both a bind executor and
        # parallel_release True, a completed gang's member binds FAN OUT
        # on the executor and on_pod_waiting returns without draining
        # them — the serve loop overlaps the next cycle with the in-flight
        # binds. Only worth it when a bind is real I/O (KubeCluster's API
        # round trips, injected bind latency; build_stack's bind_pipeline
        # gate): against an in-process FakeCluster a bind is microseconds
        # and the thread handoff costs more than it saves.
        self.parallel_release = parallel_release
        self.bind_executor = bind_executor
        # (member pod, gang name, why) — build_stack wires the Event
        # recorder's GangRollback reason here.
        self.on_rollback = on_rollback
        # Transactional bind rollbacks initiated (a member's bind failed
        # after the binder's retries and the release was rolled back).
        self.bind_rollbacks = 0
        # Observability surfaces, wired by build_stack: the lifecycle
        # tracer (gang-release / gang-rollback events on the gang's
        # trace) and the why-pending index (topology admission parks
        # record the REAL per-node reason — infeasible host vs
        # feasible-but-no-contiguous-block).
        self.tracer = None
        self.pending = None
        # Scheduler shard-out: which shard this plugin's stack serves
        # (why-pending verdicts carry it so `explain` names the shard
        # that parked a gang) and whether release cohorts arm the
        # optimistic-commit handoff (collect_commits). Both wired by the
        # sharded assembly only; default = unsharded behavior untouched.
        self.shard: "str | None" = None
        self.track_commits = False
        self._lock = threading.RLock()
        self._gangs: dict[str, _GangState] = {}
        self._framework = None

    def attach_framework(self, framework) -> None:
        """Give the plugin a handle to the waitlist so host-death and pod
        delete events can reject waiting members (standalone.build_stack
        wires this)."""
        self._framework = framework

    # --- helpers ---

    @staticmethod
    def _eff(gs: _GangState) -> int:
        """The gang's CURRENT effective size: the member count the Permit
        barrier releases at and admission admits up to. spec.size unless
        an elastic resize (set_effective_size) moved it."""
        return gs.eff_size if gs.eff_size is not None else gs.spec.size

    def _member_slots(self, ni: NodeInfo, req, *, exclude_hosts: set[str]) -> int:
        """How many members of ``req`` the node could take right now."""
        if ni.tpu is None or ni.name in exclude_hosts:
            return 0
        reserved = self.reserved_fn(ni.name) if self.reserved_fn else None
        avail = available_chips(ni.tpu, req, reserved)
        return max(avail // max(req.effective_chips, 1), 0)

    def _host_fits_member(
        self,
        ni: NodeInfo,
        req,
        assigned_hosts: set[str],
        pod: PodSpec,
        pending_res: dict | None = None,
        fenced: frozenset = frozenset(),
    ) -> bool:
        # Node-health fence (yoda_tpu_torch/nodehealth): a SUSPECT /
        # DRAINING / DOWN host must never enter a gang plan — the fence
        # gates planning exactly as it gates the admission row.
        if ni.name in fenced:
            return False
        # Node-object admission (cordon / untolerated taints / selector /
        # required affinity) gates planning the same way it gates Filter —
        # a planned block must never include a host the members cannot
        # bind to.
        if not pod_admits_on(ni.node, pod)[0]:
            return False
        if not node_fits_resources(ni, pod, pending_res)[0]:
            return False
        return self._member_slots(ni, req, exclude_hosts=assigned_hosts) >= 1

    def _reject_waiting(self, key: str, message: str) -> None:
        """Reject one waiting member, outside the gang lock (reject
        re-enters the resolution chain)."""
        fw = self._framework
        w = fw.get_waiting_pod(key) if fw is not None else None
        if w is not None:
            w.reject(message)

    # --- PreFilter: gang admission ---

    def pre_filter(self, state: CycleState, pod: PodSpec, snapshot: Snapshot) -> Status:
        req = get_request(state)
        if req.gang is None:
            return Status.ok()
        deferred: list[str] = []
        with self._lock:
            gs = self._gangs.get(req.gang.name)
            if gs is None:
                gs = _GangState(spec=req.gang)
                self._gangs[req.gang.name] = gs
            elif gs.spec != req.gang:
                return Status.unresolvable(
                    f"gang {req.gang.name}: member declares "
                    f"size/topology/slices {req.gang.size}/"
                    f"{req.gang.topology}/{req.gang.slices}, gang has "
                    f"{gs.spec.size}/{gs.spec.topology}/{gs.spec.slices}"
                )
            if pod.key in gs.waiting:
                return Status.unschedulable(f"pod {pod.key} already waiting in gang")
            if pod.key in gs.bound:
                # The scheduler only schedules unbound pods, so this entry is
                # stale: a bind that failed after permit released the pod, or
                # a delete+recreate the watch hasn't replayed. Self-heal by
                # re-admitting.
                gs.bound.discard(pod.key)
                gs.assigned.pop(pod.key, None)
            remaining = self._eff(gs) - len(gs.bound) - len(gs.waiting)
            if gs.spec.elastic and remaining <= 0:
                # Surplus member of an elastic gang: the gang already runs
                # at its effective size — park until a resize-up
                # (Rebalancer) raises it (the resize calls
                # move_all_to_active, which reactivates this entry).
                return Status.unschedulable(
                    f"gang {req.gang.name}: already at its effective size "
                    f"{self._eff(gs)} (elastic {gs.spec.floor}.."
                    f"{gs.spec.ceiling}); surplus member parked until a "
                    "resize-up"
                )
            state.write(GANG_REMAINING_KEY, _GangRemaining(remaining))
            if gs.spec.topology is not None:
                st = self._pre_filter_topology(
                    state, pod, snapshot, gs, req, deferred
                )
            else:
                # Plain gang: capacity estimate over free slots. This member
                # plus the other remaining members must all fit somewhere.
                # The scan short-circuits at `remaining` — admission only
                # needs enough slots, not the fleet total.
                aff = get_affinity(state)
                pending_res = get_pending_resources(state)
                fenced = getattr(snapshot, "fenced", frozenset())
                # Gang members share labels, so a required term matching the
                # pod's OWN labels constrains the gang against itself and
                # caps admission — without a cap the surplus member holds
                # its siblings' reservations until the permit timeout:
                # - self ANTI-affinity: at most one member per domain of the
                #   term's key (keyless nodes belong to no domain and keep
                #   their full slot count — upstream semantics);
                # - self AFFINITY: every member must land in ONE domain, so
                #   the gang gets max-per-domain slots, not the fleet sum
                #   (keyless nodes contribute nothing: api.affinity rejects
                #   bootstrapping a group onto a keyless node).
                ns_labels = snapshot.namespaces
                anti_self = [
                    t for t in pod.pod_anti_affinity
                    if t.matches_pod(pod, pod.namespace, ns_labels)
                ]
                aff_self = [
                    t for t in pod.pod_affinity
                    if t.matches_pod(pod, pod.namespace, ns_labels)
                ]

                def admits(ni: NodeInfo) -> bool:
                    return (
                        ni.name not in fenced
                        and pod_admits_on(ni.node, pod)[0]
                        and node_fits_resources(ni, pod, pending_res)[0]
                        and (aff is None or aff.feasible(ni)[0])
                    )

                slots = 0
                if not anti_self and not aff_self:
                    # No domain cap possible: keep the short-circuit at
                    # `remaining` even when an evaluator exists (it only
                    # filters nodes, it cannot cap the sum).
                    for ni in snapshot.infos():
                        if not admits(ni):
                            continue
                        slots += self._member_slots(ni, req, exclude_hosts=set())
                        if slots >= remaining:
                            break
                else:
                    # Domain caps need the whole feasible set: no
                    # short-circuit (self-constrained gangs are rare).
                    contributing: list[tuple[NodeInfo, int]] = []
                    for ni in snapshot.infos():
                        if not admits(ni):
                            continue
                        n = self._member_slots(ni, req, exclude_hosts=set())
                        if n > 0:
                            contributing.append((ni, n))
                    slots = sum(n for _, n in contributing)
                    for term in anti_self:
                        keyed: set[str] = set()
                        keyless = 0
                        for ni, n in contributing:
                            labels = ni.node.labels if ni.node is not None else {}
                            v = labels.get(term.topology_key)
                            if v is None:
                                keyless += n
                            else:
                                keyed.add(v)
                        slots = min(slots, len(keyed) + keyless)
                    viable: set[str] | None = None
                    for term in aff_self:
                        per_domain: dict[str, int] = {}
                        node_domain: dict[str, str] = {}
                        for ni, n in contributing:
                            labels = ni.node.labels if ni.node is not None else {}
                            v = labels.get(term.topology_key)
                            if v is not None:
                                per_domain[v] = per_domain.get(v, 0) + n
                                node_domain[ni.name] = v
                        slots = min(slots, max(per_domain.values()) if per_domain else 0)
                        # Steer every member into a domain that can hold the
                        # WHOLE remainder: without this the first member
                        # binds to the best-scoring node even when its
                        # domain is too small for the gang.
                        fits = {
                            name for name, v in node_domain.items()
                            if per_domain[v] >= remaining
                        }
                        viable = fits if viable is None else (viable & fits)
                    if aff_self and viable is not None:
                        if not viable:
                            slots = 0  # no single domain fits the remainder
                        else:
                            state.write(
                                ALLOWED_HOSTS_KEY, _AllowedHosts(frozenset(viable))
                            )
                if slots < remaining:
                    st = Status.unschedulable(
                        f"gang {req.gang.name}: {remaining} members still "
                        f"need placement but only {slots} slots are free"
                    )
                else:
                    st = Status.ok()
        for key in deferred:
            self._reject_waiting(
                key, "gang plan lost a host; rolling back to re-plan"
            )
        return st

    def _pre_filter_topology(
        self, state, pod, snapshot, gs: _GangState, req, deferred: list[str]
    ) -> Status:
        assigned_hosts = set(gs.assigned.values())
        pending_res = get_pending_resources(state)
        fenced = getattr(snapshot, "fenced", frozenset())
        plan_hosts_free = (
            set(gs.plan) - assigned_hosts if gs.plan is not None else set()
        )
        # (Re)plan when there is no plan, or planned hosts became infeasible
        # — a free planned host MISSING from the snapshot (CR deleted) or in
        # dead_hosts counts as infeasible, not skipped.
        plan_broken = gs.plan is not None and any(
            h not in snapshot or h in gs.dead_hosts for h in plan_hosts_free
        )
        # A plan that LOST a host can never complete — waiting members would
        # hold their reservations until the permit timeout. Cancel via the
        # caller's deferred list: one member suffices, the standard cascade
        # rolls back the rest. Only for gone hosts: transient infeasibility
        # keeps the normal wait-for-timeout behavior.
        if plan_broken and gs.waiting:
            log.warning(
                "gang %s: plan lost host(s) %s; rolling back %d waiting "
                "member(s) for re-plan",
                gs.spec.name,
                sorted(gs.dead_hosts) or "<gone from snapshot>",
                len(gs.waiting),
            )
            deferred.append(next(iter(gs.waiting)))
            return Status.unschedulable(
                f"gang {gs.spec.name}: plan lost a host; retry after rollback"
            )
        # Replanning is safe while no member is parked at Permit. Members
        # already BOUND (e.g. replayed after a scheduler restart) pin the
        # new plan: the block must complete around their hosts.
        if len(gs.waiting) == 0 and (
            gs.plan is None
            or plan_broken
            or not plan_hosts_free
            or not all(
                self._host_fits_member(
                    snapshot.get(h), req, assigned_hosts, pod, pending_res,
                    fenced,
                )
                for h in plan_hosts_free
                if h in snapshot
            )
        ):
            pinned: dict[str, tuple[int, int, int]] = {}
            for key in list(gs.bound):
                host = gs.assigned.get(key)
                if host in gs.dead_hosts:
                    # The bound member's host died: the member is lost.
                    # Drop the membership; the replacement pod re-joins.
                    log.warning(
                        "gang %s: dropping bound member %s — its host %s "
                        "is dead; planning around it",
                        gs.spec.name, key, host,
                    )
                    gs.bound.discard(key)
                    gs.assigned.pop(key, None)
                    continue
                ni = snapshot.get(host) if host and host in snapshot else None
                if ni is None or ni.tpu is None:
                    return Status.unschedulable(
                        f"gang {gs.spec.name}: bound member {key} is on host "
                        f"{host} with no TPU metrics; cannot plan around it"
                    )
                pinned[host] = ni.tpu.topology_coords
            gs.plan = plan_multislice_placement(
                snapshot,
                want_dims=gs.spec.topology,
                slices=gs.spec.slices,
                host_ok=lambda ni: self._host_fits_member(
                    ni, req, assigned_hosts, pod, pending_res, fenced
                ),
                pinned=pinned,
            )
            if gs.plan is not None:
                log.info(
                    "gang %s: planned %dx %s block(s) on hosts %s",
                    gs.spec.name,
                    gs.spec.slices,
                    "x".join(map(str, gs.spec.topology)),
                    sorted(gs.plan),
                )
            gs.assigned = {k: v for k, v in gs.assigned.items() if k in gs.bound}
            gs.specs = {k: v for k, v in gs.specs.items() if k in gs.bound}
            plan_hosts_free = (
                set(gs.plan) - set(pinned) if gs.plan else set()
            )
        if not plan_hosts_free:
            msg = (
                f"gang {gs.spec.name}: no slice has a free contiguous "
                f"{'x'.join(map(str, gs.spec.topology))} host block"
            )
            self._note_topology_park(
                snapshot, gs, req, pod, pending_res, assigned_hosts, msg
            )
            return Status.unschedulable(msg)
        state.write(ALLOWED_HOSTS_KEY, _AllowedHosts(frozenset(plan_hosts_free)))
        return Status.ok()

    def _note_topology_park(
        self, snapshot, gs: _GangState, req, pod, pending_res,
        assigned_hosts: set, msg: str,
    ) -> None:
        """Why-pending evidence for a topology admission park: classify
        every node — fenced, without metrics, member-infeasible
        (admission/resources/chips) or feasible-but-outside-any-free-
        contiguous-block — so the operator sees WHICH hosts block the
        block, not just "no block". Only runs when the index is wired and
        only on the park path, so the serve loop pays nothing in the
        steady state."""
        if self.pending is None:
            return
        shape = "x".join(map(str, gs.spec.topology))
        fenced = getattr(snapshot, "fenced", frozenset())
        reasons: dict[str, str] = {}
        for ni in snapshot.infos():
            if ni.name in fenced:
                reasons[ni.name] = (
                    f"node {ni.name} is fenced by the health monitor "
                    "(suspect/draining/down)"
                )
            elif ni.tpu is None:
                reasons[ni.name] = f"node {ni.name} has no TPU metrics"
            elif not self._host_fits_member(
                ni, req, assigned_hosts, pod, pending_res
            ):
                reasons[ni.name] = (
                    f"node {ni.name} cannot take a gang member "
                    "(admission/resources/free chips)"
                )
            else:
                reasons[ni.name] = (
                    f"node {ni.name} is feasible but no free contiguous "
                    f"{shape} block contains it"
                )
        self.pending.record(
            pod.key,
            kind="admission-park",
            message=msg,
            gang=gs.spec.name,
            node_reasons=reasons,
            shard=self.shard,
        )

    # --- Filter: pin topology-gang members to planned hosts ---

    def filter(self, state: CycleState, pod: PodSpec, node: NodeInfo) -> Status:
        if not state.contains(ALLOWED_HOSTS_KEY):
            return Status.ok()
        allowed = state.read(ALLOWED_HOSTS_KEY)
        assert isinstance(allowed, _AllowedHosts)
        if node.name in allowed.hosts:
            return Status.ok()
        return Status.unschedulable("host not in gang's planned ICI block")

    # --- Permit: the barrier ---

    def permit(self, state: CycleState, pod: PodSpec, node_name: str) -> tuple[Status, float]:
        req = get_request(state)
        if req.gang is None:
            return Status.ok(), 0.0
        with self._lock:
            gs = self._gangs.get(req.gang.name)
            if gs is None:
                # A member-delete event can reap the gang between this
                # pod's PreFilter and Permit.
                return (
                    Status.unschedulable(
                        f"gang {req.gang.name} state vanished (member deleted?)"
                    ),
                    0.0,
                )
            gs.waiting.add(pod.key)
            gs.assigned[pod.key] = node_name
            gs.specs[pod.key] = pod
        return Status.wait(f"waiting for gang {req.gang.name}"), self.timeout_s

    def on_pod_waiting(self, framework, wp) -> None:
        """Framework hook, fired after the WaitingPod registers: if this was
        the last member, release the whole gang. A member whose assigned
        host died between Reserve and this registration is rejected now."""
        gang_name = None
        with self._lock:
            for name, gs in self._gangs.items():
                if wp.pod.key in gs.waiting:
                    gang_name = name
                    break
            if gang_name is None:
                return
            gs = self._gangs[gang_name]
            dead = gs.assigned.get(wp.pod.key) in gs.dead_hosts
            complete = len(gs.waiting) + len(gs.bound) >= self._eff(gs)
            targets = list(gs.waiting) if complete and not dead else []
            if targets:
                # Release starts: arm the transactional-bind cohort AND
                # the completion barrier. Any member's bind failure from
                # here rolls the whole cohort back (on_bind_failed), but
                # the unwind of landed binds waits until every in-flight
                # sibling settles (release_pending drains).
                gs.release_cohort = set(targets)
                gs.release_bound = {}
                gs.release_pending = set(targets)
                gs.release_rollbacks = []
                gs.rollback_ready = False
                gs.bind_failed = False
        if dead:
            wp.reject(
                f"assigned host {gs.assigned.get(wp.pod.key)} disappeared "
                "mid-gang"
            )
            return
        if targets:
            log.info(
                "gang %s complete: releasing %d waiting member(s)",
                gang_name, len(targets),
            )
            if self.tracer is not None and self.tracer.enabled:
                self.tracer.add(
                    f"gang:{gang_name}", "gang-release",
                    attrs={"members": len(targets)},
                )
        waiters = [
            w
            for key in targets
            if (w := framework.get_waiting_pod(key)) is not None
        ]
        if (
            len(waiters) <= 1
            or not self.parallel_release
            or self.bind_executor is None
        ):
            self._observed_release(waiters, lambda w: w.allow(self.name))
            return
        # Pipelined release: each allow() runs the member's bind — an API
        # round trip on real clusters, retry backoff included — and a gang
        # of N pays N-1 of them here. Fan them out on the bounded bind
        # executor and RETURN WITHOUT DRAINING: the serve loop goes on to
        # the next cycle's snapshot refresh and kernel dispatch while these
        # binds are in flight, bounded by bind_workers concurrent API
        # writes. The executor is persistent, so the workers' per-thread
        # keep-alive connections (KubeApiClient._pooled) amortize across
        # gangs. Safety: each WaitingPod resolves exactly once under its
        # own lock; in-flight members keep their reservations charged to
        # the accountant, so overlapped dispatches see their capacity as
        # consumed; a member's bind failure rolls the cohort back only
        # after every in-flight sibling settles (release_pending barrier +
        # collect_rollbacks).
        for w in waiters:
            self.bind_executor.submit(lambda w=w: w.allow(self.name))

    @staticmethod
    def _observed_release(waiters, invoke) -> None:
        """Run ``invoke`` over every member, observing EVERY member before
        any failure re-raises: a raising resolution chain must not abandon
        the remaining members to the permit timeout."""
        first_error = None
        for w in waiters:
            try:
                invoke(w)
            except Exception as e:  # noqa: BLE001
                log.exception("releasing gang member %s failed", w.pod.key)
                first_error = first_error or e
        if first_error is not None:
            raise first_error

    def close(self) -> None:
        """Release the bind executor (cli.py's drain path). Shutdown sets
        the executor's stop event, which also aborts any pending
        interruptible retry sleeps in the binder; workers are not joined
        (a SIGTERM during a stalled bind round trip must not block the
        drain — the in-flight HTTP call is bounded by
        KubeApiConfig.request_timeout_s either way)."""
        executor, self.bind_executor = self.bind_executor, None
        if executor is not None:
            executor.shutdown()

    def on_pod_resolved(self, framework, wp, status: Status) -> None:
        """Framework hook on waitlist resolution: success moves the member to
        bound; rejection cascades to the rest of the gang."""
        with self._lock:
            gs = next(
                (g for g in self._gangs.values() if wp.pod.key in g.waiting), None
            )
            if gs is None:
                return
            gs.waiting.discard(wp.pod.key)
            if status.success:
                gs.bound.add(wp.pod.key)
                if len(gs.bound) >= self._eff(gs):
                    gs.assigned = {
                        k: v for k, v in gs.assigned.items() if k in gs.bound
                    }
                    gs.specs = {
                        k: v for k, v in gs.specs.items() if k in gs.bound
                    }
                return
            # Rejection: roll the rest of the gang back (once). A cohort
            # member rejected BEFORE its bind (cascade, host death, permit
            # expiry) settles its slot in the release barrier — it will
            # never reach the API.
            gs.release_pending.discard(wp.pod.key)
            gs.release_cohort.discard(wp.pod.key)
            self._maybe_rollback_ready(gs)
            gs.assigned.pop(wp.pod.key, None)
            gs.specs.pop(wp.pod.key, None)
            if gs.failing:
                if not gs.waiting:  # cascade finished
                    gs.failing = False
                    gs.plan = None
                return
            gs.failing = True
            targets = list(gs.waiting)
            had_bound = bool(gs.bound)
        why = f"member {wp.pod.key} was rejected: {status.message}"
        if targets:
            log.warning(
                "gang %s: member %s rejected (%s); rolling back %d waiting "
                "member(s)",
                gs.spec.name, wp.pod.key, status.message, len(targets),
            )
        if self.on_rollback is not None and (targets or had_bound):
            # The gang-level reason, on the TRIGGERING member too — its own
            # FailedScheduling row only says what happened to it, not that
            # it took the gang down.
            self.on_rollback(wp.pod, gs.spec.name, why)
        for key in targets:
            w = framework.get_waiting_pod(key)
            if w is not None:
                if self.on_rollback is not None:
                    self.on_rollback(w.pod, gs.spec.name, why)
                w.reject(f"gang {why}")
        with self._lock:
            if not gs.waiting:
                gs.failing = False
                gs.plan = None

    # --- transactional bind rollback ---

    def _maybe_rollback_ready(self, gs: _GangState) -> None:
        """Under the lock: arm the deferred-rollback handoff once the
        release cohort has FULLY settled after a failure — every in-flight
        sibling bound, failed, or was rejected. collect_rollbacks then
        hands the parked (spec, host, why) triples to the scheduler."""
        if gs.bind_failed and not gs.release_pending and gs.release_rollbacks:
            gs.rollback_ready = True

    def on_pod_bound(self, framework, wp) -> bool:
        """Framework hook: a permit-released pod's bind SUCCEEDED. Records
        the member in its gang's release cohort so a later sibling's bind
        failure can roll it back, and settles the member's slot in the
        release barrier. Returns False when the gang already began a
        bind-failure rollback — the caller must then undo THIS bind too
        (pipelined-release race: binds in flight concurrently, the first
        failure wins and the stragglers are unwound)."""
        gang_name = gang_name_of(wp.pod.labels)
        if not gang_name:
            return True
        with self._lock:
            gs = self._gangs.get(gang_name)
            if gs is None or wp.pod.key not in gs.release_cohort:
                return True
            gs.release_pending.discard(wp.pod.key)
            if gs.bind_failed:
                gs.bound.discard(wp.pod.key)
                gs.assigned.pop(wp.pod.key, None)
                gs.specs.pop(wp.pod.key, None)
                gs.release_cohort.discard(wp.pod.key)
                self._maybe_rollback_ready(gs)
                return False
            gs.release_bound[wp.pod.key] = wp.node_name
            if (
                self.track_commits
                and not gs.release_pending
                and gs.release_bound
            ):
                # The whole cohort LANDED (this settle was the last and
                # none failed): hand the cohort to the scheduler's
                # shard-commit flush for atomic validation.
                gs.commit_ready = True
            return True

    def on_bind_failed(self, framework, wp, status: Status) -> "bool | None":
        """Framework hook: a permit-released member's bind FAILED after the
        binder's transient retries. Makes the gang bind transactional —
        the all-or-nothing contract the fit gate gives placement, extended
        through the bind phase: siblings whose binds already landed this
        release are parked for unbind/unreserve/requeue, still-waiting
        members are rejected (the standard cascade releases their
        reservations), and the gang's bookkeeping forgets the release so
        the WHOLE gang re-queues untouched. The landed-bind unwinds are
        DEFERRED behind the release barrier: the scheduler collects them
        via ``collect_rollbacks`` once every in-flight sibling has settled
        — an unbind must never race a sibling's bind still mid-air.
        Returns True when this call initiated the rollback, None otherwise
        (not a gang member, or the cohort is already rolling back — repeat
        failures do only their own member bookkeeping)."""
        gang_name = gang_name_of(wp.pod.labels)
        if not gang_name:
            return None
        why = (
            f"member {wp.pod.key} failed to bind: {status.message}; "
            "rolling the gang back"
        )
        with self._lock:
            gs = self._gangs.get(gang_name)
            if gs is None:
                return None
            already = gs.bind_failed
            gs.bind_failed = True
            # The member resolved SUCCESS at Permit, so on_pod_resolved
            # counted it bound — undo that; the caller's standard
            # rejection path unreserves and requeues the member itself.
            gs.bound.discard(wp.pod.key)
            gs.assigned.pop(wp.pod.key, None)
            gs.specs.pop(wp.pod.key, None)
            gs.release_cohort.discard(wp.pod.key)
            gs.release_pending.discard(wp.pod.key)
            if already:
                self._maybe_rollback_ready(gs)
                return None
            rollbacks: list[tuple[PodSpec, str]] = []
            for key, host in gs.release_bound.items():
                spec = gs.specs.pop(key, None)
                gs.bound.discard(key)
                gs.assigned.pop(key, None)
                if spec is not None:
                    rollbacks.append((spec, host))
                    gs.release_rollbacks.append((spec, host, why))
            gs.release_bound = {}
            targets = list(gs.waiting)
            gs.plan = None
            self.bind_rollbacks += 1
            self._maybe_rollback_ready(gs)
        log.warning(
            "gang %s: bind failure on %s — rolling back %d landed member(s) "
            "once the release settles, cascading %d waiting member(s)",
            gang_name, wp.pod.key, len(rollbacks), len(targets),
        )
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.add(
                f"gang:{gang_name}", "gang-rollback",
                attrs={
                    "trigger": wp.pod.key,
                    "landed": len(rollbacks),
                    "cascaded": len(targets),
                },
            )
        if self.on_rollback is not None:
            self.on_rollback(wp.pod, gang_name, why)
            for spec, _host in rollbacks:
                self.on_rollback(spec, gang_name, why)
        # Outside the lock (reject re-enters the resolution chain — the
        # standard collect-then-reject discipline of on_pod_resolved).
        for key in targets:
            w = framework.get_waiting_pod(key)
            if w is not None:
                if self.on_rollback is not None:
                    self.on_rollback(w.pod, gang_name, why)
                w.reject(f"gang {why}")
        return True

    def collect_commits(
        self, framework
    ) -> "list[tuple[str, list[tuple[PodSpec, str]]]]":
        """Framework hook, polled by a SHARDED scheduler after every
        release settle: the (gang name, [(member spec, host), ...])
        cohorts whose binds have fully landed and now need the optimistic
        shard-commit validation at the shared accountant. Each cohort is
        returned exactly once; the scheduler commits it — or, on a
        validation conflict, rolls every landed member back through the
        transactional unbind path and requeues the gang whole."""
        out: "list[tuple[str, list[tuple[PodSpec, str]]]]" = []
        with self._lock:
            for name, gs in self._gangs.items():
                if not gs.commit_ready:
                    continue
                gs.commit_ready = False
                cohort = [
                    (gs.specs[key], host)
                    for key, host in gs.release_bound.items()
                    if key in gs.specs
                ]
                if cohort:
                    out.append((name, cohort))
        return out

    def collect_rollbacks(self, framework) -> "list[tuple[PodSpec, str, str]]":
        """Framework hook, polled by the scheduler after every release
        settle: the deferred (spec, host, why) unwinds of gangs whose
        release cohort has FULLY settled after a bind failure. Each
        rollback is returned exactly once; the scheduler unbinds,
        unreserves, and requeues them (_rollback_bound)."""
        out: list[tuple[PodSpec, str, str]] = []
        with self._lock:
            for gs in self._gangs.values():
                if gs.rollback_ready:
                    gs.rollback_ready = False
                    out.extend(gs.release_rollbacks)
                    gs.release_rollbacks = []
        return out

    def drop_membership(self, pod: PodSpec) -> None:
        """Forget a BOUND member that is about to be rolled back elsewhere:
        its stale bound entry must not satisfy the Permit barrier while the
        unbind is in flight. The plan drops too. If the unbind then FAILS,
        ``on_unbind_failed`` restores the membership."""
        gang_name = gang_name_of(pod.labels)
        if not gang_name:
            return
        with self._lock:
            gs = self._gangs.get(gang_name)
            if gs is None:
                return
            gs.bound.discard(pod.key)
            gs.assigned.pop(pod.key, None)
            gs.specs.pop(pod.key, None)
            gs.plan = None
            if not gs.bound and not gs.waiting:
                self._gangs.pop(gang_name, None)

    def on_unbind_failed(self, framework, pod: PodSpec, node_name: str) -> None:
        """Framework hook: a rollback's unbind FAILED, so the member
        remains bound on the cluster. Restore its membership — the
        re-queued siblings then complete the gang AROUND the stranded
        member instead of waiting at the barrier for a ghost."""
        gang_name = gang_name_of(pod.labels)
        if not gang_name:
            return
        with self._lock:
            gs = self._gangs.get(gang_name)
            if gs is None:
                return
            gs.bound.add(pod.key)
            gs.assigned[pod.key] = node_name
            gs.specs[pod.key] = pod
            log.warning(
                "gang %s: member %s could not be unbound; keeping it as a "
                "bound member (%d/%d)",
                gang_name, pod.key, len(gs.bound), gs.spec.size,
            )

    # --- watch: membership lifecycle across restarts and deletions ---

    def handle(self, event: Event) -> None:
        if event.kind in ("TpuNodeMetrics", "Node"):
            if event.type == "deleted":
                # Node death while members wait at Permit: reject the
                # affected members; the standard cascade rolls back the
                # rest and drops the plan.
                self._on_host_gone(event.obj.name, event.kind)
            else:
                # Host (re)appeared: clear THIS kind's death mark only.
                with self._lock:
                    for gs in self._gangs.values():
                        kinds = gs.dead_hosts.get(event.obj.name)
                        if kinds:
                            kinds.discard(event.kind)
                            if not kinds:
                                del gs.dead_hosts[event.obj.name]
            return
        if event.kind != "Pod":
            return
        pod: PodSpec = event.obj  # type: ignore[assignment]
        # Alias-aware (coscheduling pod-group labels gang too).
        gang_name = gang_name_of(pod.labels)
        if not gang_name:
            return
        if event.type == "deleted":
            reject_key = None
            with self._lock:
                gs = self._gangs.get(gang_name)
                if gs is not None:
                    gs.bound.discard(pod.key)
                    if pod.key in gs.waiting:
                        # Delete-event fast path: the member is PARKED at
                        # Permit holding its (and, via the barrier, its
                        # siblings') reservations. Reject it NOW; membership
                        # cleanup happens through the rejection
                        # (on_pod_resolved), which also runs the cascade.
                        reject_key = pod.key
                    else:
                        gs.assigned.pop(pod.key, None)
                        gs.specs.pop(pod.key, None)
                    if not gs.bound and not gs.waiting:
                        self._gangs.pop(gang_name, None)
            if reject_key is not None and self._framework is not None:
                self._framework.cancel_waiting(
                    reject_key,
                    f"pod {reject_key} was deleted while waiting at permit",
                )
            return
        with self._lock:
            gs = self._gangs.get(gang_name)
            if not pod.node_name:
                # Bound -> pending transition: the member was UNBOUND (a
                # rollback). Members currently WAITING are not touched —
                # their own resolution chain owns them.
                if (
                    gs is not None
                    and pod.key in gs.bound
                    and pod.key not in gs.waiting
                ):
                    gs.bound.discard(pod.key)
                    gs.assigned.pop(pod.key, None)
                    gs.specs.pop(pod.key, None)
                    if not gs.bound and not gs.waiting:
                        self._gangs.pop(gang_name, None)
                return
            # Bound member (bind we initiated, or watch replay after a
            # scheduler restart): reconstruct membership — unless its host
            # is dead-marked (a zombie pod awaiting node GC).
            if gs is not None and pod.node_name in gs.dead_hosts:
                return
            if gs is None:
                from yoda_tpu_torch.api.requests import LabelParseError, pod_request

                try:
                    spec = pod_request(pod).gang
                except LabelParseError:
                    return
                if spec is None:
                    return
                gs = _GangState(spec=spec)
                self._gangs[gang_name] = gs
            gs.bound.add(pod.key)
            gs.assigned.setdefault(pod.key, pod.node_name)

    def _on_host_gone(self, host: str, kind: str) -> None:
        with self._lock:
            targets = []
            for gs in self._gangs.values():
                # Mark on every gang: a member racing between Reserve and
                # waitlist registration has the host in neither plan nor
                # assigned yet, and on_pod_waiting must still catch it.
                gs.dead_hosts.setdefault(host, set()).add(kind)
                targets.extend(
                    (key, f"assigned host {host} disappeared mid-gang")
                    for key in gs.waiting
                    if gs.assigned.get(key) == host
                )
                # A BOUND member on the dead host is lost: cascade one
                # waiting member so all held reservations release now; the
                # membership itself is dropped lazily at replan time.
                lost = [k for k in gs.bound if gs.assigned.get(k) == host]
                if lost and gs.waiting:
                    targets.append((
                        next(iter(gs.waiting)),
                        f"gang lost bound member {lost[0]} with host {host}; "
                        "releasing reservations to re-plan",
                    ))
            targets = list(dict.fromkeys(targets))
        for key, reason in targets:
            log.warning(
                "gang member %s waiting at permit: %s; rejecting "
                "(cascade will re-plan)", key, reason,
            )
            self._reject_waiting(key, reason)

    # --- rebalancer surface ---

    def set_effective_size(self, name: str, n: int) -> int | None:
        """Elastic resize: set the gang's effective size, clamped to
        [spec.floor, spec.ceiling]. Returns the size actually set, or None
        when the gang is unknown or not elastic (rigid gangs cannot be
        resized). The caller (Rebalancer) reactivates parked surplus
        members via ``queue.move_all_to_active`` after a resize-up; a
        resize-down of a BOUND gang additionally unbinds the surplus
        members through the standard rollback path."""
        with self._lock:
            gs = self._gangs.get(name)
            if gs is None or not gs.spec.elastic:
                return None
            n = max(gs.spec.floor, min(gs.spec.ceiling, n))
            gs.eff_size = n
            return n

    def effective_size(self, name: str) -> int | None:
        """The gang's current effective size (None when unknown here)."""
        with self._lock:
            gs = self._gangs.get(name)
            return self._eff(gs) if gs is not None else None

    def install_plan(
        self,
        name: str,
        spec: GangSpec,
        plan: "dict[str, tuple[int, int, int]]",
    ) -> bool:
        """Pin a topology gang's NEXT placement to ``plan`` (host ->
        coord): admission then finds this plan already installed and steers
        the members onto it instead of replanning. Refused while any member
        waits at Permit. Advisory: if the target hosts are taken before the
        members re-admit, the normal replan runs."""
        with self._lock:
            gs = self._gangs.get(name)
            if gs is None:
                gs = _GangState(spec=spec)
                self._gangs[name] = gs
            if gs.waiting:
                return False
            gs.plan = dict(plan)
            return True

    def bound_members(self, name: str) -> "dict[str, str]":
        """pod key -> assigned host for the gang's BOUND members (empty
        when unknown)."""
        with self._lock:
            gs = self._gangs.get(name)
            if gs is None:
                return {}
            return {
                k: h for k, h in gs.assigned.items() if k in gs.bound and h
            }

    # --- introspection (tests, chip_smoke) ---

    def gang_status(self, name: str) -> tuple[int, int, int] | None:
        """(size, waiting, bound) or None."""
        with self._lock:
            gs = self._gangs.get(name)
            if gs is None:
                return None
            return gs.spec.size, len(gs.waiting), len(gs.bound)

    def planned_unassigned_hosts(self, name: str) -> list[str] | None:
        """Hosts of a topology gang's current plan that no member has
        reserved yet — the hosts the remaining members MUST land on. None
        when no plan exists."""
        with self._lock:
            gs = self._gangs.get(name)
            if gs is None or gs.plan is None:
                return None
            return sorted(set(gs.plan) - set(gs.assigned.values()))

    def pending_placements(self) -> list[tuple[str, PodSpec]]:
        """(assigned host, member spec) for every member with a live
        assignment — parked at Permit (reserved but unbound) OR released
        and binding, until the bind's watch event lands. Both are invisible
        in the snapshot's per-node pod lists, so YodaPreFilter feeds them to
        the inter-pod and spread evaluators and their resource, hostPort
        and volume claims to admission, and YodaBatch refuses a burst while
        such a claim is invisible."""
        with self._lock:
            out: list[tuple[str, PodSpec]] = []
            for gs in self._gangs.values():
                for key, host in gs.assigned.items():
                    spec = gs.specs.get(key)
                    if host and spec is not None:
                        out.append((host, spec))
            return out
