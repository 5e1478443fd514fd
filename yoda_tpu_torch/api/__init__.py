"""API types, quantities and pod-label requests (counterpart of yoda_tpu/api),
with the reference's 14 re-exports."""

from yoda_tpu_torch.api.quantity import parse_quantity, QuantityError
from yoda_tpu_torch.api.types import (
    TpuChip,
    TpuNodeMetrics,
    PodSpec,
    HEALTHY,
    GENERATION_RANK,
    make_node,
)
from yoda_tpu_torch.api.requests import (
    GangSpec,
    LabelParseError,
    TpuRequest,
    parse_request,
    pod_request,
    parse_topology,
)

__all__ = [
    "parse_quantity",
    "QuantityError",
    "TpuChip",
    "TpuNodeMetrics",
    "PodSpec",
    "HEALTHY",
    "GENERATION_RANK",
    "make_node",
    "GangSpec",
    "TpuRequest",
    "LabelParseError",
    "parse_request",
    "pod_request",
    "parse_topology",
]
