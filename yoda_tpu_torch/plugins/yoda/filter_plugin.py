"""PreFilter plugin and the per-node admission predicates the batch path
applies.

Counterpart of ``yoda_tpu/plugins/yoda/filter_plugin.py``, ported as far as
the singleton and gang paths reach it: label parsing in ``YodaPreFilter``,
the NodeResourcesFit and NodePorts predicates, the claimable-chip count
gang admission reads (``available_chips``), and the in-flight
(Permit-parked gang member) resource and hostPort feeds
(``PENDING_RES_KEY``, ``PENDING_PORTS_KEY``). Left out until a later
slice: the per-node ``YodaFilter`` and its per-pod chip predicates (loop
mode), the inter-pod affinity / topology-spread evaluators, volume
resolution and attach limits.

Pods whose admission needs one of those parts are refused at PreFilter
with an explicit UnschedulableAndUnresolvable status naming what is not
ported — never scheduled as if the constraint were absent. In the
reference the in-flight hostPort claims ride its AffinityData; the port
has no AffinityData, so they ride ``PENDING_PORTS_KEY`` on their own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from yoda_tpu_torch.api.affinity import (
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
PENDING_RES_KEY = "yoda-tpu/pending-resources"
PENDING_PORTS_KEY = "yoda-tpu/pending-ports"


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


@dataclass
class PendingPorts:
    """Per-node hostPort claims of in-flight placements (the NodePorts
    companion of :class:`PendingResources`)."""

    by_node: dict[str, tuple]

    def clone(self) -> "PendingPorts":
        return self


def get_pending_ports(state: CycleState) -> dict[str, tuple] | None:
    if not state.contains(PENDING_PORTS_KEY):
        return None
    data = state.read(PENDING_PORTS_KEY)
    assert isinstance(data, PendingPorts)
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


def unported_constraint(pod: PodSpec) -> "str | None":
    """Why this pod needs a part of the scheduler this port does not have
    yet, or None."""
    if pod_has_inter_pod_terms(pod):
        return "inter-pod affinity is not yet ported"
    if pod.topology_spread:
        return "topology spread constraints are not yet ported"
    if pod.pvc_names:
        return "volume (PersistentVolumeClaim) constraints are not yet ported"
    return None


class YodaPreFilter(PreFilterPlugin):
    """Parses the pod's tpu/* labels once per cycle into CycleState.
    Malformed labels are UnschedulableAndUnresolvable (retries cannot help),
    unlike the reference's silent-zero (filter.go:60-74). Pods that need an
    unported part (see the module docstring) are refused the same way.

    With ``pending_fn`` (GangPlugin.pending_placements) it also writes the
    in-flight members' resource and hostPort claims into CycleState, so a
    cycle cannot overcommit allocatable or ports under a gang that waits
    at Permit."""

    name = "yoda-prefilter"

    def __init__(
        self,
        *,
        pending_fn: Callable[[], list[tuple[str, PodSpec]]] | None = None,
    ) -> None:
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
        why = unported_constraint(pod)
        if why is None and self._fleet_has_terms(snapshot):
            why = (
                "bound pods declare inter-pod affinity terms; their "
                "evaluation is not yet ported"
            )
        if why is not None:
            return Status.unresolvable(why)
        state.write(REQUEST_KEY, RequestData(req))
        pending = self.pending_fn() if self.pending_fn is not None else ()
        if pending:
            # In-flight claims, deduped against the snapshot by uid (bind
            # events may have landed since the member was recorded).
            seen = {p.uid for ni in snapshot.infos() for p in ni.pods}
            by_node: dict[str, tuple[int, int, int]] = {}
            ports_by_node: dict[str, tuple] = {}
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
                    ports_by_node[host] = (
                        ports_by_node.get(host, ()) + p.host_ports
                    )
            if by_node:
                state.write(PENDING_RES_KEY, PendingResources(by_node))
            if ports_by_node:
                state.write(PENDING_PORTS_KEY, PendingPorts(ports_by_node))
        return Status.ok()
