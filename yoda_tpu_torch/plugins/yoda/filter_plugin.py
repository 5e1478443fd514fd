"""PreFilter plugin and the per-node admission predicates the batch path
applies.

Counterpart of ``yoda_tpu/plugins/yoda/filter_plugin.py``, ported as far as
the batch path reaches it: label parsing and the per-cycle evaluators in
``YodaPreFilter`` (inter-pod affinity, topology spread, volume claims and
attach limits, carried in ``AffinityData``), the NodeResourcesFit,
NodePorts, volume and attach-limit predicates, the claimable-chip count
gang admission reads (``available_chips``), and the in-flight
(Permit-parked gang member) resource, hostPort and volume feeds. Left out
until a later slice: the per-node ``YodaFilter`` and its per-pod chip
predicates (loop mode), and the ImageLocality spread that only loop mode
reads from CycleState.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from yoda_tpu_torch.api.affinity import (
    InterPodEvaluator,
    SpreadEvaluator,
    fleet_has_inter_pod_terms,
    pod_has_inter_pod_terms,
)
from yoda_tpu_torch.api.requests import LabelParseError, TpuRequest, pod_request
from yoda_tpu_torch.api.types import (
    PodSpec,
    TpuChip,
    TpuNodeMetrics,
    host_ports_conflict,
)
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import PreFilterPlugin, Snapshot, Status

REQUEST_KEY = "yoda-tpu/request"
AFFINITY_KEY = "yoda-tpu/affinity"
PENDING_RES_KEY = "yoda-tpu/pending-resources"


@dataclass
class RequestData:
    """CycleState carrier for the parsed request (immutable)."""

    request: TpuRequest

    def clone(self) -> "RequestData":
        return self


def get_request(state: CycleState) -> TpuRequest:
    data = state.read(REQUEST_KEY)
    assert isinstance(data, RequestData)
    return data.request


@dataclass
class AffinityData:
    """CycleState carrier for the per-cycle admission evaluators: inter-pod
    affinity, topology spread (api.affinity), and the pod's resolved
    constraint-carrying volume claims. Built once in PreFilter; ``None`` /
    empty members mean the dimension cannot fire for this (pod, cycle), so
    per-node checks are skipped entirely."""

    inter: InterPodEvaluator | None = None
    spread: SpreadEvaluator | None = None
    # ResolvedClaim tuples (resolve_volumes): each carries the claim's
    # static pins (selected-node annotation, zone label) plus the dynamic
    # RWO attachment constraint (allowed_nodes) — the minimal
    # VolumeBinding / volume-zone / VolumeRestrictions parity.
    pvcs: tuple = ()
    # node -> hostPort triples held by in-flight placements (gang members
    # reserved at Permit — invisible in NodeInfo.pods until bound). None
    # when no pending pod claims ports (the overwhelming norm).
    pending_ports: "dict[str, tuple] | None" = None
    # (pv_name, csi driver) of the pod's CSI-backed bound claims, plus
    # the snapshot's claim/volume maps for per-node attach counting —
    # upstream NodeVolumeLimits (resolve_attach_volumes). Empty/None for
    # the overwhelming majority of pods.
    pv_volumes: tuple = ()
    claim_maps: "tuple | None" = None  # (pvcs map, pvs map)
    # node -> (pv_name, driver) tuples held by in-flight placements (the
    # attach-limit analog of pending_ports). None in the common case.
    pending_volumes: "dict[str, tuple] | None" = None

    def clone(self) -> "AffinityData":
        return self

    def volumes_feasible(self, node) -> tuple[bool, str]:
        """The volume half alone — preemption's node-eligibility guard
        (eviction can never cure a selected-node or zone pin, unlike
        anti-affinity/spread conflicts). Attach limits are NOT here:
        evicting a volume-using pod detaches its volumes, so attach
        pressure IS curable and must not make a node preemption-
        ineligible."""
        if self.pvcs:
            return node_fits_volumes(self.pvcs, node)
        return True, ""

    def feasible(self, node) -> tuple[bool, str]:
        ok, why = self.volumes_feasible(node)
        if not ok:
            return ok, why
        if self.pv_volumes and self.claim_maps is not None:
            pend = (
                self.pending_volumes.get(node.name, ())
                if self.pending_volumes
                else ()
            )
            ok, why = node_fits_attach_limits(
                self.pv_volumes + tuple(pend), node, *self.claim_maps
            )
            if not ok:
                return ok, why
        if self.inter is not None:
            ok, why = self.inter.feasible(node)
            if not ok:
                return ok, why
        if self.spread is not None:
            ok, why = self.spread.feasible(node)
            if not ok:
                return ok, why
        return True, ""


def get_affinity(state: CycleState) -> AffinityData | None:
    if not state.contains(AFFINITY_KEY):
        return None
    data = state.read(AFFINITY_KEY)
    assert isinstance(data, AffinityData)
    return data


@dataclass
class PendingResources:
    """Per-node (cpu millicores, memory bytes, pod count) held by in-flight
    placements — gang members reserved at Permit or binding, not yet in
    the snapshot's pod lists (GangPlugin.pending_placements, deduped
    against the snapshot by uid). Written by YodaPreFilter; consumed by
    node_fits_resources so sibling cycles cannot overcommit allocatable
    the way they cannot overcommit chips."""

    by_node: dict[str, tuple[int, int, int]]

    def clone(self) -> "PendingResources":
        return self


def get_pending_resources(
    state: CycleState,
) -> dict[str, tuple[int, int, int]] | None:
    if not state.contains(PENDING_RES_KEY):
        return None
    data = state.read(PENDING_RES_KEY)
    assert isinstance(data, PendingResources)
    return data.by_node


# --- claimable chips (reference filter.go parity, exclusive-chip model) ---


def qualifying_chips(node: TpuNodeMetrics, req: TpuRequest) -> list[TpuChip]:
    """Healthy chips meeting the per-chip HBM and clock constraints."""
    return [
        c
        for c in node.chips
        if c.healthy and c.hbm_free >= req.hbm_per_chip and c.clock_mhz >= req.min_clock_mhz
    ]


def apparently_used_chips(node: TpuNodeMetrics) -> int:
    """Healthy chips whose metrics already show consumption: a chip
    occupied by a running pod is charged EITHER via the accountant's
    reservation (before the agent's next refresh) OR via its reduced free
    HBM (after), never both."""
    return sum(1 for c in node.chips if c.healthy and c.hbm_free < c.hbm_total)


def absorbable_used_chips(node: TpuNodeMetrics) -> int:
    """Used chips that can stand in for an accountant reservation: visible
    usage minus the agent-reported external-tenant chips."""
    return max(apparently_used_chips(node) - node.external_used_chips, 0)


def invisible_reservations(node: TpuNodeMetrics, reserved: int) -> int:
    """Reservations not yet reflected in the node's published metrics."""
    return max(reserved - absorbable_used_chips(node), 0)


def stale_freed_chips(
    node: TpuNodeMetrics, req: TpuRequest, reserved: int | None
) -> int:
    """Chips the metrics still show as used but NO live pod claims — freed
    by a delete the node agent hasn't re-scraped yet. ``reserved=None``
    means no accounting source exists: the credit is then zero. A freed
    chip counts only if it would qualify when full, and the worst case is
    assumed for which used chips are free (external-tenant chips and the
    remaining live claims sit on the qualifying used chips first)."""
    if reserved is None:
        return 0
    reserved = max(reserved, 0)
    stale = absorbable_used_chips(node) - reserved
    if stale <= 0:
        return 0
    candidates = sum(
        1
        for c in node.chips
        if c.healthy
        and c.hbm_free < c.hbm_total
        and c.clock_mhz >= req.min_clock_mhz
        and c.hbm_total >= req.hbm_per_chip
    )
    candidates = max(candidates - node.external_used_chips, 0)
    return min(stale, max(candidates - reserved, 0))


def available_chips(
    node: TpuNodeMetrics,
    req: TpuRequest,
    reserved: int | None,
    *,
    freed: int | None = None,
) -> int:
    """Qualifying chips actually claimable under the exclusive-chip model:
    unused qualifying chips, minus reservations the metrics have not
    caught up with, plus chips freed by deletions the metrics have not
    caught up with (:func:`stale_freed_chips`). ``reserved=None`` = no
    accounting: neither correction applies. The evaluation's claimable row
    computes the same count for every node at once."""
    unused = sum(
        1 for c in qualifying_chips(node, req) if c.hbm_free >= c.hbm_total
    )
    if reserved is None:
        return unused
    if freed is None:
        freed = stale_freed_chips(node, req, reserved)
    return unused - invisible_reservations(node, reserved) + freed


def node_fits_host_ports(
    ni, pod: PodSpec, pending_ports: dict[str, tuple] | None = None
) -> tuple[bool, str]:
    """Upstream NodePorts: the pod's hostPort claims must not conflict with
    any pod already on the node (same protocol+port with overlapping
    hostIPs), nor with in-flight placements (``pending_ports``). Port-free
    pods cost one tuple check."""
    if not pod.host_ports:
        return True, ""
    claimed = [
        (theirs, other.key) for other in ni.pods for theirs in other.host_ports
    ]
    if pending_ports:
        claimed += [
            (theirs, "an in-flight placement")
            for theirs in pending_ports.get(ni.name, ())
        ]
    for theirs, who in claimed:
        for ours in pod.host_ports:
            if host_ports_conflict(ours, theirs):
                return False, (
                    f"host port {ours[0]}/{ours[1]} already in use by {who}"
                )
    return True, ""


@dataclass(frozen=True)
class ResolvedClaim:
    """One constraint-carrying claim after per-cycle resolution: the PVC's
    static pins (selected-node annotation, zone label), the bound PV's
    REAL ``spec.nodeAffinity`` when the PV watch resolved it (``pv`` —
    upstream VolumeBinding's hard predicate; it supersedes the zone-label
    stand-in), plus the dynamic attachment constraint from upstream
    VolumeRestrictions — a ``ReadWriteOnce`` claim mounted by running pods
    attaches to one node, so a new pod using it must co-locate
    (``allowed_nodes``)."""

    pvc: object                              # K8sPvc
    allowed_nodes: frozenset | None = None   # None = unconstrained
    pv: object | None = None                 # K8sPv | None (unresolved)


def _claim_restricts(modes: tuple) -> bool:
    """Does this claim's accessModes set force single-node attachment?
    RWOP always; RWO only when no shared mode is also offered — a
    multi-mode claim ([RWO, RWX]) may be bound to an RWX-capable PV, and
    forcing co-location there would park schedulable pods."""
    if "ReadWriteOncePod" in modes:
        return True
    return "ReadWriteOnce" in modes and not (
        {"ReadWriteMany", "ReadOnlyMany"} & set(modes)
    )


def resolve_volumes(snapshot, pod: PodSpec, pending=()):
    """Minimal volume awareness (upstream VolumeBinding / volume-zone /
    VolumeRestrictions parity — the reference ran the full upstream
    default filter set, reference pkg/register/register.go:10). Returns
    (constraining ResolvedClaims, error message | None): the error is a
    missing claim (wait for the PVC event) or a ReadWriteOncePod claim
    already in use (wait for the holder to go away). ``pending`` — the
    (host, pod) placements parked at Permit — counts like bound pods, so
    an in-flight sibling's claim use is visible before its bind event
    lands. Enforced only when the backend supplies PVC data
    (snapshot.pvcs is not None); volume-free pods cost one tuple check."""
    if not pod.pvc_names or snapshot.pvcs is None:
        return (), None
    resolved = []
    users_by_claim: dict[str, set] | None = None
    for claim in pod.pvc_names:
        pvc = snapshot.pvcs.get(f"{pod.namespace}/{claim}")
        if pvc is None:
            # Upstream VolumeBinding: the pod waits for the claim (a PVC
            # watch event reactivates it) rather than scheduling blind.
            return (), (
                f"persistentvolumeclaim {pod.namespace}/{claim} not found"
            )
        allowed = None
        if _claim_restricts(pvc.access_modes):
            if users_by_claim is None:
                # One walk for ALL of the pod's claims: which nodes
                # currently mount each of them — bound pods plus
                # reserved-but-unbound placements, deduped by uid
                # (upstream VolumeRestrictions reads the same attachment
                # state).
                users_by_claim = {c: set() for c in pod.pvc_names}
                seen_uids: set[str] = set()
                for ni in snapshot.infos():
                    for p in ni.pods:
                        seen_uids.add(p.uid)
                        if p.namespace != pod.namespace or p.uid == pod.uid:
                            continue
                        for c in p.pvc_names:
                            if c in users_by_claim:
                                users_by_claim[c].add(ni.name)
                for host, p in pending:
                    if (
                        p.uid in seen_uids
                        or p.uid == pod.uid
                        or p.namespace != pod.namespace
                    ):
                        continue
                    for c in p.pvc_names:
                        if c in users_by_claim:
                            users_by_claim[c].add(host)
            mounted_on = users_by_claim[claim]
            if mounted_on:
                if "ReadWriteOncePod" in pvc.access_modes:
                    return (), (
                        f"claim {claim} is ReadWriteOncePod and already "
                        "in use by another pod"
                    )
                # RWO: single-node attachment — must co-locate.
                allowed = frozenset(mounted_on)
        # Bound claim -> its PV's real nodeAffinity, when the PV watch is
        # live (upstream VolumeBinding). An unresolvable volumeName (PV
        # object not yet seen) falls back to the claim-level stand-ins
        # rather than parking the pod: the PV watch event re-resolves.
        pv = (
            snapshot.pvs.get(pvc.volume_name)
            if pvc.volume_name and snapshot.pvs is not None
            else None
        )
        if pvc.selected_node or pvc.zone or allowed is not None or (
            pv is not None and pv.node_affinity
        ):
            resolved.append(ResolvedClaim(pvc, allowed, pv))
    return tuple(resolved), None


def resolve_attach_volumes(snapshot, pod: PodSpec) -> tuple:
    """(pv_name, csi driver) for each of the pod's claims bound to a CSI
    PersistentVolume — upstream NodeVolumeLimits' pod-side input
    (inherited by the reference via pkg/register/register.go:10). Empty
    without PV data or for non-CSI volumes."""
    if not pod.pvc_names or snapshot.pvcs is None or snapshot.pvs is None:
        return ()
    out = []
    for claim in pod.pvc_names:
        pvc = snapshot.pvcs.get(f"{pod.namespace}/{claim}")
        if pvc is None or not pvc.volume_name:
            continue
        pv = snapshot.pvs.get(pvc.volume_name)
        if pv is not None and pv.driver:
            out.append((pv.name, pv.driver))
    return tuple(out)


def node_fits_attach_limits(
    pv_volumes, ni, pvcs_map, pvs_map
) -> tuple[bool, str]:
    """Upstream NodeVolumeLimits: for each CSI driver the pod's volumes
    use, UNIQUE volumes already attached to the node (bound pods' bound
    claims) plus the pod's new ones must fit the node's declared
    ``attachable-volumes-*`` allocatable. Enforced only when the node
    declares a limit for a driver the pod uses; a volume already attached
    (shared RWX) is not double-counted."""
    node = ni.node
    if node is None or not node.attach_limits:
        return True, ""
    wanted_drivers = {driver for _, driver in pv_volumes}
    limits = {
        driver: limit
        for driver in wanted_drivers
        if (
            limit := node.attach_limits.get(
                f"csi-{driver}", node.attach_limits.get(driver)
            )
        )
        is not None
    }
    if not limits:
        return True, ""
    attached: dict[str, set[str]] = {d: set() for d in limits}
    for p in ni.pods:
        for claim in p.pvc_names:
            pvc = pvcs_map.get(f"{p.namespace}/{claim}")
            if pvc is None or not pvc.volume_name:
                continue
            pv = pvs_map.get(pvc.volume_name)
            if pv is not None and pv.driver in attached:
                attached[pv.driver].add(pv.name)
    for name, driver in pv_volumes:
        if driver in attached:
            attached[driver].add(name)
    for driver, vols in attached.items():
        if len(vols) > limits[driver]:
            return False, (
                f"node's {limits[driver]}-volume attach limit for driver "
                f"{driver} would be exceeded ({len(vols)} volumes)"
            )
    return True, ""


def node_fits_volumes(pvcs, ni) -> tuple[bool, str]:
    """Per-node half of the volume filter: the node must (a) be the one the
    volume binder pinned via ``volume.kubernetes.io/selected-node``,
    (b) satisfy the bound PV's REAL ``spec.nodeAffinity`` when resolved
    (upstream VolumeBinding; it supersedes the claim's zone-label
    stand-in, which applies only while the PV is unresolved), and
    (c) for an attached ReadWriteOnce claim, be where it is mounted."""
    for rc in pvcs:
        pvc = rc.pvc
        if pvc.selected_node and pvc.selected_node != ni.name:
            return False, (
                f"claim {pvc.name} is bound to node {pvc.selected_node}"
            )
        if rc.pv is not None and rc.pv.node_affinity:
            ok, why = rc.pv.allows_node(ni.node)
            if not ok:
                return False, f"claim {pvc.name}: {why}"
        elif rc.pv is None and pvc.zone:
            # Zone stand-in ONLY while the PV is unresolved: a resolved PV
            # with EMPTY nodeAffinity (network volume, mountable anywhere)
            # supersedes a stale/mislabeled claim zone with "no
            # constraint", upstream semantics.
            node_zone = (
                ni.node.labels.get("topology.kubernetes.io/zone")
                if ni.node is not None
                else None
            )
            if node_zone != pvc.zone:
                return False, (
                    f"claim {pvc.name} is in zone {pvc.zone}; node is in "
                    f"{node_zone or 'no zone'}"
                )
        if rc.allowed_nodes is not None and ni.name not in rc.allowed_nodes:
            return False, (
                f"ReadWriteOnce claim {pvc.name} is attached to "
                f"{sorted(rc.allowed_nodes)}; pod must co-locate"
            )
    return True, ""


def node_fits_resources(
    ni,
    pod: PodSpec,
    pending_by_node: dict[str, tuple[int, int, int]] | None = None,
) -> tuple[bool, str]:
    """Upstream NodeResourcesFit (cpu / memory / pod count) against the
    Node's status.allocatable. Enforced only when BOTH sides declare: the
    pod requests the resource AND the node declares an allocatable for it
    (0 = undeclared). ``pending_by_node`` adds (cpu, memory, pods) taken by
    placements not yet visible in ``ni.pods`` (burst siblings, gang members
    parked at Permit)."""
    node = ni.node
    if node is None:
        return True, ""
    p_cpu, p_mem, p_n = (
        pending_by_node.get(ni.name, (0, 0, 0))
        if pending_by_node
        else (0, 0, 0)
    )
    if node.alloc_pods and len(ni.pods) + p_n + 1 > node.alloc_pods:
        return False, f"node pod capacity {node.alloc_pods} exhausted"
    if pod.cpu_milli_request and node.alloc_cpu_milli:
        used = sum(p.cpu_milli_request for p in ni.pods) + p_cpu
        if used + pod.cpu_milli_request > node.alloc_cpu_milli:
            return False, (
                f"insufficient cpu: {used}m used of "
                f"{node.alloc_cpu_milli}m allocatable, pod wants "
                f"{pod.cpu_milli_request}m"
            )
    if pod.memory_request and node.alloc_memory:
        used = sum(p.memory_request for p in ni.pods) + p_mem
        if used + pod.memory_request > node.alloc_memory:
            return False, (
                f"insufficient memory: {used} bytes used of "
                f"{node.alloc_memory} allocatable, pod wants "
                f"{pod.memory_request}"
            )
    return True, ""


class YodaPreFilter(PreFilterPlugin):
    """Parses the pod's tpu/* labels once per cycle into CycleState.
    Malformed labels are UnschedulableAndUnresolvable (retries cannot help),
    unlike the reference's silent-zero (filter.go:60-74).

    Also builds the per-cycle inter-pod affinity / topology-spread
    evaluators (api.affinity) when they could matter: the pod declares
    terms, or some bound (or pending — gang members parked at Permit,
    ``pending_fn``) pod declares required anti-affinity (the symmetry
    direction) or preferred terms. Affinity-free fleets pay only a cached
    per-snapshot-version flag check here — nothing per node. The pod's
    volume claims are resolved here too; a claim that does not exist yet
    parks the pod until the claim's watch event."""

    name = "yoda-prefilter"

    def __init__(
        self,
        *,
        pending_fn: Callable[[], list[tuple[str, PodSpec]]] | None = None,
    ) -> None:
        # GangPlugin.pending_placements when gang scheduling is wired:
        # reserved-but-unbound members, visible to the evaluators so gang
        # siblings honour each other's inter-pod terms mid-flight.
        self.pending_fn = pending_fn
        # (snapshot.version, any bound pod declares required anti-affinity
        #  or preferred inter-pod terms)
        self._inter_cache: tuple[int, bool] = (0, False)

    def _fleet_has_terms(self, snapshot: Snapshot) -> bool:
        """Required-anti symmetry or symmetric preferred scoring possible,
        cached per snapshot version."""
        if snapshot.version and self._inter_cache[0] == snapshot.version:
            return self._inter_cache[1]
        flag = fleet_has_inter_pod_terms(snapshot.infos())
        if snapshot.version:
            self._inter_cache = (snapshot.version, flag)
        return flag

    def pre_filter(self, state: CycleState, pod: PodSpec, snapshot: Snapshot) -> Status:
        try:
            req = pod_request(pod)
        except LabelParseError as e:
            return Status.unresolvable(f"invalid tpu/* labels: {e}")
        state.write(REQUEST_KEY, RequestData(req))
        pending = self.pending_fn() if self.pending_fn is not None else ()
        pvcs, missing = resolve_volumes(snapshot, pod, pending)
        if missing is not None:
            # Unresolvable until the claim exists (no eviction helps), but
            # not permanent: the PVC's watch event reactivates the pod.
            return Status.unresolvable(missing)
        inter = spread = None
        if (
            pod_has_inter_pod_terms(pod)
            or self._fleet_has_terms(snapshot)
            # Pending (reserved-but-unbound) siblings count like bound
            # pods: their required anti-affinity repels and their
            # preferred terms score symmetrically.
            or any(pod_has_inter_pod_terms(p) for _, p in pending)
        ):
            inter = InterPodEvaluator.build(snapshot, pod, pending=pending)
            if inter.trivial:
                inter = None
        if pod.topology_spread:
            spread = SpreadEvaluator.build(snapshot, pod, pending=pending)
        ports_by_node: dict[str, tuple] = {}
        pending_vols_by_node: dict[str, tuple] = {}
        if pending:
            # In-flight claims, deduped against the snapshot by uid (bind
            # events may have landed since the member was recorded):
            # resources for NodeResourcesFit, hostPorts for NodePorts and
            # CSI volumes for the attach limit.
            seen = {p.uid for ni in snapshot.infos() for p in ni.pods}
            by_node: dict[str, tuple[int, int, int]] = {}
            for host, p in pending:
                if p.uid in seen:
                    continue
                c, m, n = by_node.get(host, (0, 0, 0))
                by_node[host] = (
                    c + p.cpu_milli_request,
                    m + p.memory_request,
                    n + 1,
                )
                if p.host_ports:
                    ports_by_node[host] = ports_by_node.get(host, ()) + p.host_ports
                if p.pvc_names:
                    vols = resolve_attach_volumes(snapshot, p)
                    if vols:
                        pending_vols_by_node[host] = (
                            pending_vols_by_node.get(host, ()) + vols
                        )
            if by_node:
                state.write(PENDING_RES_KEY, PendingResources(by_node))
        pv_volumes = resolve_attach_volumes(snapshot, pod)
        if inter is not None or spread is not None or pvcs or ports_by_node or pv_volumes:
            state.write(
                AFFINITY_KEY,
                AffinityData(
                    inter,
                    spread,
                    pvcs,
                    ports_by_node or None,
                    pv_volumes,
                    (snapshot.pvcs, snapshot.pvs) if pv_volumes else None,
                    pending_vols_by_node or None,
                ),
            )
        return Status.ok()
