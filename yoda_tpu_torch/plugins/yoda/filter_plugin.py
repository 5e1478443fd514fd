"""Feasibility predicates and the PreFilter / Filter plugins.

Counterpart of ``yoda_tpu/plugins/yoda/filter_plugin.py``: label parsing
and the per-cycle evaluators in ``YodaPreFilter`` (inter-pod affinity,
topology spread, volume claims and attach limits, carried in
``AffinityData``; the ImageLocality spread that loop mode's
``ImageLocalityScore`` reads), the reference's per-pod chip predicates
(``pod_fits_chips``, ``pod_fits_hbm``, ``pod_fits_clock``), the
NodeResourcesFit, NodePorts, volume and attach-limit predicates, the
claimable-chip count (``available_chips``), the in-flight (Permit-parked
gang member) resource, hostPort and volume feeds, and loop mode's per-node
``YodaFilter``. The batch path evaluates the same predicates for the whole
fleet at once (ops/kernel.py).
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
    pod_admits_on,
)
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import (
    FilterPlugin,
    NodeInfo,
    PreFilterPlugin,
    Snapshot,
    Status,
)

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


# --- pure predicates (reference filter.go parity) ---


def chip_fits_hbm(hbm: int, chip: TpuChip) -> bool:
    """Reference ``CardFitsMemory`` (filter.go:52-54)."""
    return chip.healthy and chip.hbm_free >= hbm


def chip_fits_clock(clock_mhz: int, chip: TpuChip) -> bool:
    """Reference ``CardFitsClock`` (filter.go:56-58), with >= semantics."""
    return chip.healthy and chip.clock_mhz >= clock_mhz


def qualifying_chips(node: TpuNodeMetrics, req: TpuRequest) -> list[TpuChip]:
    """Healthy chips meeting the per-chip HBM and clock constraints — the
    chip set both collection and scoring iterate."""
    return [
        c
        for c in node.chips
        if c.healthy and c.hbm_free >= req.hbm_per_chip and c.clock_mhz >= req.min_clock_mhz
    ]


def pod_fits_chips(req: TpuRequest, node: TpuNodeMetrics) -> tuple[bool, int]:
    """Reference ``PodFitsNumber`` (filter.go:11-16): an explicit count
    must fit the healthy chips; the default is "node has at least one
    healthy chip", count 1."""
    healthy = len(node.healthy_chips())
    if req.chips is not None:
        return req.chips <= healthy, req.chips
    return healthy > 0, 1


def pod_fits_hbm(number: int, req: TpuRequest, node: TpuNodeMetrics) -> bool:
    """Reference ``PodFitsMemory`` (filter.go:18-33): >= ``number`` healthy
    chips each with enough free HBM."""
    if req.hbm_per_chip == 0:
        return True
    return sum(1 for c in node.chips if chip_fits_hbm(req.hbm_per_chip, c)) >= number


def pod_fits_clock(number: int, req: TpuRequest, node: TpuNodeMetrics) -> bool:
    """Reference ``PodFitsClock`` (filter.go:35-50) with >= semantics."""
    if req.min_clock_mhz == 0:
        return True
    return sum(1 for c in node.chips if chip_fits_clock(req.min_clock_mhz, c)) >= number


# --- claimable chips (exclusive-chip model) ---


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
    parks the pod until the claim's watch event. In loop mode it writes
    ImageLocality's fleet view too (``write_image_spread``)."""

    name = "yoda-prefilter"

    def __init__(
        self,
        *,
        pending_fn: Callable[[], list[tuple[str, PodSpec]]] | None = None,
        image_locality_weight: int = 1,
        write_image_spread: bool = True,
    ) -> None:
        # GangPlugin.pending_placements when gang scheduling is wired:
        # reserved-but-unbound members, visible to the evaluators so gang
        # siblings honour each other's inter-pod terms mid-flight.
        self.pending_fn = pending_fn
        # Weights.image_locality: a zero weight skips the ImageLocality
        # fleet walk entirely (the batch path gates the same way in
        # _preference_bonus).
        self.image_locality_weight = image_locality_weight
        # False in batch mode: only loop mode's ImageLocalityScore reads
        # the CycleState spread; the batch path computes its own inside
        # _preference_bonus, so writing it here would be a duplicated
        # O(fleet) walk.
        self.write_image_spread = write_image_spread
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
        if (
            pod.container_images
            and self.image_locality_weight
            and self.write_image_spread
        ):
            # ImageLocality's fleet view (image_locality.py): one walk, only
            # for image-naming pods on image-reporting fleets with the knob
            # enabled.
            from yoda_tpu_torch.plugins.yoda.image_locality import (
                IMAGE_SPREAD_KEY,
                build_image_spread,
            )

            image_spread = build_image_spread(snapshot, pod)
            if image_spread is not None:
                state.write(IMAGE_SPREAD_KEY, image_spread)
        return Status.ok()


class YodaFilter(FilterPlugin):
    """Per-node feasibility — the reference's Filter hook
    (pkg/yoda/scheduler.go:66-84) minus its per-node API round trip: the
    node's TPU CR arrives on the NodeInfo from the informer snapshot.
    Loop mode's filter; the batch path's evaluation computes the same
    verdicts for the whole fleet at once.

    ``reserved_chips_fn`` (the accountant's) reports chips already reserved
    by in-flight pods on a node; ``max_metrics_age_s`` > 0 also rejects
    nodes with stale metrics. The node-health fence is applied before this
    plugin runs (``Framework.run_filters``)."""

    name = "yoda-filter"

    def __init__(
        self,
        reserved_chips_fn: Callable[[str], int] | None = None,
        *,
        max_metrics_age_s: float = 0.0,
        now_fn: Callable[[], float] | None = None,
    ) -> None:
        self.reserved_chips_fn = reserved_chips_fn
        self.max_metrics_age_s = max_metrics_age_s
        self.now_fn = now_fn

    def filter(self, state: CycleState, pod: PodSpec, node: NodeInfo) -> Status:
        # Node-object admission first: cordon / untolerated hard taints make
        # every capacity question moot.
        admitted, why = pod_admits_on(node.node, pod)
        if not admitted:
            return Status.unschedulable(f"node {node.name}: {why}")
        aff = get_affinity(state)
        if aff is not None:
            admitted, why = aff.feasible(node)
            if not admitted:
                return Status.unschedulable(f"node {node.name}: {why}")
        admitted, why = node_fits_resources(
            node, pod, get_pending_resources(state)
        )
        if not admitted:
            return Status.unschedulable(f"node {node.name}: {why}")
        admitted, why = node_fits_host_ports(
            node, pod, aff.pending_ports if aff is not None else None
        )
        if not admitted:
            return Status.unschedulable(f"node {node.name}: {why}")
        tpu = node.tpu
        if tpu is None:
            # Reference: SCV Get error -> Unschedulable (scheduler.go:72-74).
            return Status.unschedulable(f"node {node.name} has no TPU metrics")
        if self.max_metrics_age_s > 0:
            now = self.now_fn() if self.now_fn else None
            if not tpu.fresh(max_age_s=self.max_metrics_age_s, now=now):
                return Status.unschedulable(f"node {node.name} TPU metrics are stale")

        req = get_request(state)
        if req.min_generation_rank and tpu.generation_rank < req.min_generation_rank:
            return Status.unschedulable(
                f"node {node.name} generation {tpu.generation} below requested"
            )

        ok, number = pod_fits_chips(req, tpu)
        if not ok:
            return Status.unschedulable(
                f"node {node.name} has {len(tpu.healthy_chips())} healthy chips, "
                f"pod needs {number}"
            )
        reserved = (
            self.reserved_chips_fn(node.name)
            if self.reserved_chips_fn
            else None
        )
        freed = stale_freed_chips(tpu, req, reserved)
        # Freed-but-not-yet-rescraped chips will have full HBM, so they
        # satisfy the per-chip HBM predicate (stale_freed_chips already
        # required hbm_total >= the requirement).
        if not pod_fits_hbm(max(number - freed, 0), req, tpu):
            return Status.unschedulable(f"node {node.name} lacks free HBM on {number} chips")
        if not pod_fits_clock(number, req, tpu):
            return Status.unschedulable(
                f"node {node.name} lacks {number} chips at >= {req.min_clock_mhz} MHz"
            )

        available = available_chips(tpu, req, reserved, freed=freed)
        if available < number:
            return Status.unschedulable(
                f"node {node.name}: {reserved or 0} chips reserved in-flight, "
                f"only {max(available, 0)} unoccupied qualifying chips"
            )
        return Status.ok()
