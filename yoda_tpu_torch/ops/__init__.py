"""The fleet arrays, the fleet evaluation and its CUDA kernels (counterpart
of yoda_tpu/ops, with the reference's exports): the informer snapshot
lowered into padded int32 arrays (``FleetArrays``) and one evaluation of
feasibility, cluster maxima, scores and the best node for every node at
once (``fused_filter_score``; ``ops.kernel.TorchFleetKernel`` holds the
fleet on the card between evaluations)."""

from yoda_tpu_torch.ops.arrays import FleetArrays, MIB
from yoda_tpu_torch.ops.kernel import (
    KernelRequest,
    KernelResult,
    fused_filter_score,
    REASON_OK,
    REASON_MESSAGES,
)

__all__ = [
    "FleetArrays",
    "MIB",
    "KernelRequest",
    "KernelResult",
    "fused_filter_score",
    "REASON_OK",
    "REASON_MESSAGES",
]
