"""PreFilter plugin and the per-node admission predicates the batch path
applies.

Counterpart of ``yoda_tpu/plugins/yoda/filter_plugin.py``, ported as far as
the singleton path reaches it: label parsing in ``YodaPreFilter``, the
NodeResourcesFit and NodePorts predicates. Left out until a later slice:
the per-node ``YodaFilter`` and its chip predicates (loop mode), the
inter-pod affinity / topology-spread evaluators, volume resolution and
attach limits, and the in-flight (Permit-parked) resource feeds.

Pods whose admission needs one of those parts are refused at PreFilter
with an explicit UnschedulableAndUnresolvable status naming what is not
ported — never scheduled as if the constraint were absent. That covers
gang, topology and multislice pods (``tpu/gang`` or the coscheduling
aliases, ``tpu/topology``, ``tpu/multislice``).
"""

from __future__ import annotations

from dataclasses import dataclass

from yoda_tpu_torch.api.affinity import (
    fleet_has_inter_pod_terms,
    pod_has_inter_pod_terms,
)
from yoda_tpu_torch.api.requests import LabelParseError, TpuRequest, pod_request
from yoda_tpu_torch.api.types import PodSpec, host_ports_conflict
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import PreFilterPlugin, Snapshot, Status

REQUEST_KEY = "yoda-tpu/request"

GANG_NOT_PORTED = (
    "gang scheduling is not yet ported (tpu/gang, tpu/topology and "
    "tpu/multislice pods need the gang path of yoda_tpu_torch)"
)


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


def node_fits_host_ports(ni, pod: PodSpec) -> tuple[bool, str]:
    """Upstream NodePorts: the pod's hostPort claims must not conflict with
    any pod already on the node (same protocol+port with overlapping
    hostIPs). Port-free pods cost one tuple check."""
    if not pod.host_ports:
        return True, ""
    for other in ni.pods:
        for theirs in other.host_ports:
            for ours in pod.host_ports:
                if host_ports_conflict(ours, theirs):
                    return False, (
                        f"host port {ours[0]}/{ours[1]} already in use by "
                        f"{other.key}"
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
    placements not yet visible in ``ni.pods`` (burst siblings)."""
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


def unported_constraint(pod: PodSpec, req: TpuRequest) -> "str | None":
    """Why this pod needs a part of the scheduler this port does not have
    yet, or None."""
    if req.gang is not None:
        return GANG_NOT_PORTED
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
    unported part (see the module docstring) are refused the same way."""

    name = "yoda-prefilter"

    def __init__(self) -> None:
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
        why = unported_constraint(pod, req)
        if why is None and self._fleet_has_terms(snapshot):
            why = (
                "bound pods declare inter-pod affinity terms; their "
                "evaluation is not yet ported"
            )
        if why is not None:
            return Status.unresolvable(why)
        state.write(REQUEST_KEY, RequestData(req))
        return Status.ok()
