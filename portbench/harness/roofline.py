"""The least time the fleet evaluation's hand kernel can take on one H100,
from the shapes of its calls: the larger of the bytes it must move over the memory
rate and the integer operations it must do over the 32-bit rate. Frozen
here so the yardstick reads the same work whatever implements it.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3 and 67 TOP/s of
non-tensor-core 32-bit integer work, both at the full 700 W power limit.
Each input is counted read once and each output written once.
"""

from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
# Integer operations per (chip, request) pair of the fleet evaluation, both
# of its passes over the chip grid (the filter's predicates and counts, the
# collection's maxima and the score's six normalized terms).
OPS_PER_CHIP_ELEMENT = 60
MAX_REQUESTS = 128  # requests per fleet_eval launch


def fleet_eval_least_s(n: int, c: int, k: int) -> float:
    """One fleet_eval launch over ``n`` padded nodes of ``c`` chips and
    ``k`` requests: chip grids [9, C, N], static and dynamic node rows
    [4, N] each, admission rows [K, N] and requests [K, 5] in, results
    [K, 6, N] out, all int32."""
    in_bytes = (9 * c * n + 4 * n + 4 * n + k * n + 5 * k) * 4
    out_bytes = 6 * k * n * 4
    return max(
        (in_bytes + out_bytes) / MEM_BYTES_PER_S,
        OPS_PER_CHIP_ELEMENT * c * n * k / INT32_OPS_PER_S,
    )


def fleet_eval_call(n: int, c: int, k: int) -> list:
    """Least seconds of each launch one call makes (one per 128 requests)."""
    return [
        fleet_eval_least_s(n, c, min(MAX_REQUESTS, k - lo))
        for lo in range(0, k, MAX_REQUESTS)
    ]
