"""The fused filter + collect + score + select evaluation, in PyTorch.

Counterpart of ``yoda_tpu/ops/kernel.py``. One evaluation replaces the
reference's entire per-pod hot path (Filter per node -> CollectMaxValues
over all cards -> Score per node -> NormalizeScore -> selection;
reference pkg/yoda/scheduler.go:66-147):

    feasibility:  chips / HBM / clock / generation / freshness / reservation
                  predicates over [nodes, chips]
    collection:   cluster maxima over feasible nodes' qualifying chips
    scoring:      weighted per-chip scores + allocation headroom + actual
                  free ratio
    normalize:    min-max to [0,100] with the all-equal guard
    select:       argmax, ties to the later row

All arithmetic is int32 and wraps the way the reference's jnp int32 does;
``//`` is floor division (``torch.div(..., rounding_mode="floor")``), as
jnp's is. :func:`kernel_impl` is the plain PyTorch version of the whole
computation; ``vmap`` becomes a leading request axis K. On a CUDA device
:class:`TorchFleetKernel` never runs it: it launches the hand-written CUDA
kernel (ops/cuda_kernel.py), which is held against this version.

Left out until a later slice: ``kernel_joint_plan`` / ``joint_fit_scan``,
``stack_joint_burst`` and the joint evaluation helpers (gang path),
``apply_row_update`` (the resident row scatter), ``NumpyFleetKernel``
(the reference's degraded-mode rung; the port has no fallback chain).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from yoda_tpu_torch.api.requests import TpuRequest
from yoda_tpu_torch.config import SLICE_PROTECT_TIER, Weights
from yoda_tpu_torch.ops.arrays import MIB, FleetArrays

REASON_OK = 0
REASON_NO_METRICS = 1
REASON_STALE = 2
REASON_GENERATION = 3
REASON_CHIPS = 4
REASON_HBM = 5
REASON_CLOCK = 6
REASON_RESERVED = 7
REASON_NODE = 8

REASON_MESSAGES = {
    REASON_NO_METRICS: "node has no TPU metrics",
    REASON_STALE: "node TPU metrics are stale",
    REASON_GENERATION: "node generation below requested",
    REASON_CHIPS: "not enough healthy chips",
    REASON_HBM: "not enough chips with free HBM",
    REASON_CLOCK: "not enough chips at requested clock",
    REASON_RESERVED: "qualifying chips reserved by in-flight pods",
    REASON_NODE: "node is cordoned, has untolerated taints, or does not "
    "match the pod's nodeSelector/required node affinity",
}

# The evaluation's input schema: FleetArrays fields, split by shape.
NODE_KEYS = (
    "node_valid",
    "in_slice",
    "fresh",
    "host_ok",
    "generation_rank",
    "reserved_chips",
    "claimed_hbm_mib",
    "ext_chips",
)
# Row order of the stacked [9, C, N] chip grids the device holds.
CHIP_KEYS = (
    "chip_valid",
    "chip_healthy",
    "chip_used",
    "hbm_free_mib",
    "hbm_total_mib",
    "clock_mhz",
    "hbm_bandwidth",
    "tflops",
    "power_w",
)

# Static per metrics version (row order of the stacked [4, N] node array)
# vs changing every scheduling cycle (row order of the [4, N] dynamics).
STATIC_NODE_KEYS = ("node_valid", "in_slice", "generation_rank", "ext_chips")
DYN_KEYS = ("fresh", "reserved_chips", "claimed_hbm_mib", "host_ok")

_BIG = np.iinfo(np.int32).max
_BOOL_KEYS = frozenset(
    {"node_valid", "in_slice", "fresh", "host_ok", "chip_valid",
     "chip_healthy", "chip_used"}
)


@dataclass(frozen=True)
class KernelRequest:
    """Request scalars (one evaluation serves every request shape)."""

    number: int          # effective chip count
    hbm_mib: int         # per-chip free-HBM requirement, MiB
    clock_mhz: int
    generation_rank: int
    wants_topology: int  # 1 when the pod is part of a topology gang

    @classmethod
    def from_request(cls, req: TpuRequest) -> "KernelRequest":
        return cls(
            number=req.effective_chips,
            # Ceil so sub-MiB requests stay a real constraint (chip free HBM
            # is floored to MiB, so both roundings are conservative).
            hbm_mib=-(-req.hbm_per_chip // MIB),
            clock_mhz=req.min_clock_mhz,
            generation_rank=req.min_generation_rank,
            wants_topology=int(
                req.gang is not None and req.gang.topology is not None
            ),
        )


@dataclass
class KernelResult:
    """Numpy views of the evaluation outputs, trimmed to the real node count."""

    feasible: np.ndarray      # [N] bool
    reasons: np.ndarray       # [N] int32 (REASON_*)
    raw_scores: np.ndarray    # [N] int32 metric score, pre-normalization
    scores: np.ndarray        # [N] int32: minmax-normalized [0,100] + slice tier
    best_index: int           # -1 when nothing feasible
    # [N] int32 chips claimable right now (after the reservation/stale-freed
    # corrections).
    claimable: np.ndarray | None = None


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _norm(metric: torch.Tensor, maximum: torch.Tensor) -> torch.Tensor:
    return _floordiv(metric * 100, maximum)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def kernel_impl(
    a: dict, number, hbm_mib, clock_mhz, gen_rank, wants_topology,
    weights: Weights,
):
    """The whole evaluation for K requests at once. ``a`` maps NODE_KEYS to
    [N] or [K, N] tensors (per-request rows, e.g. ``host_ok``) and
    CHIP_KEYS to [N, C] tensors (bool for the flags, int32 for the rest).
    Request scalars are [K, 1] int32 tensors. Returns (feasible [K, N]
    bool, reasons, raw, final, claimable [K, N] int32, best [K] int32) —
    the reference's outputs with a leading request axis."""
    number, hbm_mib, clock_mhz, gen_rank, wants_topology = (
        torch.as_tensor(v, dtype=torch.int32).reshape(-1, 1)
        for v in (number, hbm_mib, clock_mhz, gen_rank, wants_topology)
    )
    # Request scalars against the [N, C] grids: [K, 1, 1].
    hbm_c = hbm_mib[:, :, None]
    clock_c = clock_mhz[:, :, None]

    def rows(x: torch.Tensor) -> torch.Tensor:  # chip-axis count -> int32
        return _i32(x.sum(dim=-1))

    healthy = a["chip_valid"] & a["chip_healthy"]            # [N, C]
    hbm_ok = healthy & (a["hbm_free_mib"] >= hbm_c)          # [K, N, C]
    clock_ok = healthy & (a["clock_mhz"] >= clock_c)         # [K, N, C]
    qual = hbm_ok & clock_ok

    count_healthy = rows(healthy)                            # [N]
    count_hbm = rows(hbm_ok)                                 # [K, N]
    count_clock = rows(clock_ok)

    # Reservation corrections: reference kernel_impl (and
    # filter_plugin.available_chips / stale_freed_chips) parity.
    zero = torch.zeros((), dtype=torch.int32, device=healthy.device)
    apparently_used = rows(healthy & a["chip_used"])
    absorbable = torch.maximum(apparently_used - a["ext_chips"], zero)
    invisible = torch.maximum(a["reserved_chips"] - absorbable, zero)
    stale_freed = torch.maximum(absorbable - a["reserved_chips"], zero)
    freed_candidates = rows(
        healthy
        & a["chip_used"]
        & (a["clock_mhz"] >= clock_c)
        & (a["hbm_total_mib"] >= hbm_c)
    )
    freed_candidates = torch.maximum(freed_candidates - a["ext_chips"], zero)
    freed = torch.minimum(
        stale_freed, torch.maximum(freed_candidates - a["reserved_chips"], zero)
    )
    count_avail = rows(qual & ~a["chip_used"])
    fits_chips = count_healthy >= number
    fits_hbm = (hbm_mib == 0) | ((count_hbm + freed) >= number)
    fits_clock = (clock_mhz == 0) | (count_clock >= number)
    fits_reserved = (count_avail + freed - invisible) >= number
    fits_gen = a["generation_rank"] >= gen_rank

    feasible = (
        a["node_valid"]
        & a["host_ok"]
        & a["fresh"]
        & fits_gen
        & fits_chips
        & fits_hbm
        & fits_clock
        & fits_reserved
    )

    # First failing predicate, in the same order the Python filter checks:
    # a reversed where-chain (torch has no select).
    reasons = torch.zeros(feasible.shape, dtype=torch.int32, device=feasible.device)
    for cond, code in reversed(
        [
            (~a["node_valid"], REASON_NO_METRICS),
            (~a["host_ok"], REASON_NODE),
            (~a["fresh"], REASON_STALE),
            (~fits_gen, REASON_GENERATION),
            (~fits_chips, REASON_CHIPS),
            (~fits_hbm, REASON_HBM),
            (~fits_clock, REASON_CLOCK),
            (~fits_reserved, REASON_RESERVED),
        ]
    ):
        reasons = torch.where(cond, code, reasons)

    # --- collection: per-request maxima over feasible nodes' qualifying chips
    cmask = feasible[:, :, None] & qual                      # [K, N, C]

    def masked_max(x: torch.Tensor) -> torch.Tensor:        # -> [K, 1, 1]
        m = torch.where(cmask, x, zero).amax(dim=(-2, -1))
        return m.clamp(min=1).reshape(-1, 1, 1)

    w = weights
    chip_scores = (
        _norm(a["hbm_bandwidth"], masked_max(a["hbm_bandwidth"])) * w.hbm_bandwidth
        + _norm(a["clock_mhz"], masked_max(a["clock_mhz"])) * w.clock
        + _norm(a["tflops"], masked_max(a["tflops"])) * w.tflops
        + _norm(a["power_w"], masked_max(a["power_w"])) * w.power
        + _norm(a["hbm_free_mib"], masked_max(a["hbm_free_mib"])) * w.hbm_free
        + _norm(a["hbm_total_mib"], masked_max(a["hbm_total_mib"])) * w.hbm_total
    )
    basic = _i32(torch.where(qual, chip_scores, zero).sum(dim=-1))

    free_sum = _i32(torch.where(a["chip_valid"], a["hbm_free_mib"], zero).sum(dim=-1))
    total_sum = _i32(torch.where(a["chip_valid"], a["hbm_total_mib"], zero).sum(dim=-1))
    safe_total = total_sum.clamp(min=1)
    actual = torch.where(
        total_sum > 0, _floordiv(free_sum * 100, safe_total), zero
    ) * w.actual
    headroom = torch.maximum(total_sum - a["claimed_hbm_mib"], zero)
    allocate = torch.where(
        total_sum > 0, _floordiv(headroom * 100, safe_total), zero
    ) * w.allocate

    raw = torch.where(feasible, basic + actual + allocate, zero)

    # --- normalize (min-max to [0,100], all-equal guard). Fillers sit
    # outside both reductions' ranges: raw goes negative under
    # most-allocated's negated weights.
    big = torch.full((), _BIG, dtype=torch.int32, device=raw.device)
    lowest = torch.where(feasible, raw, big).amin(dim=-1, keepdim=True)
    highest = torch.where(feasible, raw, -big).amax(dim=-1, keepdim=True)
    lowest = torch.where(highest == lowest, lowest - 1, lowest)
    span = torch.maximum(highest - lowest, zero + 1)
    normalized = torch.where(feasible, _floordiv((raw - lowest) * 100, span), zero)

    # Anti-fragmentation tier, added AFTER normalization.
    protect = torch.where(
        (wants_topology == 0) & ~a["in_slice"],
        SLICE_PROTECT_TIER * w.slice_protect,
        0,
    ).to(torch.int32)
    final = torch.where(feasible, normalized + protect, zero)

    # --- select: highest score, ties -> later row (argmax of the reversed
    # row takes the FIRST max, i.e. the last one of the original order).
    n = final.shape[-1]
    masked = torch.where(feasible, final, zero - 1)
    best = (n - 1 - torch.argmax(masked.flip(-1), dim=-1)).to(torch.int32)
    best = torch.where(feasible.any(dim=-1), best, zero - 1)

    claimable = torch.maximum(count_avail + freed - invisible, zero)
    return feasible, reasons, raw, final, claimable, best


def _static_dict(chips: torch.Tensor, nodes: torch.Tensor) -> dict:
    """The stacked device layout ([9, C, N] chip grids, [4, N] static node
    rows) as kernel_impl's dict of [N, C] / [N] views."""
    a = {k: chips[i].T for i, k in enumerate(CHIP_KEYS)}
    a.update({k: nodes[i] for i, k in enumerate(STATIC_NODE_KEYS)})
    for k in _BOOL_KEYS & a.keys():
        a[k] = a[k] != 0
    return a


def kernel_packed_burst(
    chips: torch.Tensor,      # [9, C, N] int32, CHIP_KEYS rows
    nodes: torch.Tensor,      # [4, N] int32, STATIC_NODE_KEYS rows
    dyn: torch.Tensor,        # [4, N] int32, DYN_KEYS rows (row 3 unused)
    host_ok_k: torch.Tensor,  # [K, N] int32 per-request admission
    reqs_k: torch.Tensor,     # [K, 5] int32 (pack_request rows)
    weights: Weights,
) -> torch.Tensor:
    """K requests against ONE fleet in one call -> [K, 6, N] int32 (rows:
    feasible, reasons, raw, final, best broadcast, claimable). The plain
    PyTorch version of the hand kernel (ops/cuda_kernel.py), on whatever
    device the tensors live on."""
    a = _static_dict(chips, nodes)
    a["fresh"] = dyn[0] != 0
    a["reserved_chips"] = dyn[1]
    a["claimed_hbm_mib"] = dyn[2]
    a["host_ok"] = host_ok_k != 0
    feasible, reasons, raw, final, claimable, best = kernel_impl(
        a, reqs_k[:, 0], reqs_k[:, 1], reqs_k[:, 2], reqs_k[:, 3], reqs_k[:, 4],
        weights=weights,
    )
    return torch.stack(
        [
            _i32(feasible),
            reasons,
            raw,
            final,
            best[:, None].expand_as(final),
            claimable,
        ],
        dim=1,
    )


def kernel_packed(chips, nodes, dyn, reqv, weights: Weights) -> torch.Tensor:
    """One request with its admission in ``dyn[3]`` -> [6, N] int32: the
    K = 1 case of :func:`kernel_packed_burst`."""
    return kernel_packed_burst(
        chips, nodes, dyn, dyn[3:4], reqv.reshape(1, 5), weights
    )[0]


def stack_static(arrays: FleetArrays) -> tuple[np.ndarray, np.ndarray]:
    """The device layout of a fleet's static arrays: chip grids as
    [9, C, N] int32 with the node axis last and contiguous (neighbouring
    CUDA threads read neighbouring addresses), static node rows as
    [4, N] int32."""
    chips = np.stack(
        [np.asarray(getattr(arrays, k), dtype=np.int32).T for k in CHIP_KEYS]
    )
    nodes = np.stack(
        [np.asarray(getattr(arrays, k), dtype=np.int32) for k in STATIC_NODE_KEYS]
    )
    return np.ascontiguousarray(chips), nodes


def pack_request(request: KernelRequest) -> np.ndarray:
    return np.array(
        [
            request.number,
            request.hbm_mib,
            request.clock_mhz,
            request.generation_rank,
            request.wants_topology,
        ],
        dtype=np.int32,
    )


def result_from_packed(names: list[str], packed: np.ndarray) -> KernelResult:
    """Unpack one request's [6, N] output, trimmed to the real fleet."""
    n = len(names)
    best = int(packed[4, 0]) if packed.shape[1] else -1
    return KernelResult(
        feasible=packed[0, :n].astype(bool),
        reasons=packed[1, :n],
        raw_scores=packed[2, :n],
        scores=packed[3, :n],
        best_index=best if 0 <= best < n else -1,
        claimable=packed[5, :n],
    )


def resolve_device(platform: str) -> torch.device:
    """The torch device a ``kernel_platform`` value selects: "auto" and
    "device" mean the CUDA card and raise when none is present — never a
    silent CPU path; "cpu" is the host."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("auto", "device"):
        raise ValueError(f"platform must be auto|cpu|device, got {platform!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"kernel_platform {platform!r} runs the fleet evaluation on a "
            "CUDA device and none is available; set kernel_platform: cpu "
            "to run its plain PyTorch version on the host"
        )
    return torch.device("cuda", torch.cuda.current_device())


class TorchFleetKernel:
    """Evaluator with device-resident fleet state — the port's
    ``FleetKernelLike`` (reference kernel.py:701-816).

    :meth:`put_static` uploads the [9, C, N] chip grids and the static node
    rows to ``device`` once per metrics version; each evaluation then
    uploads one [4, N] dynamics array, the [K, N] admission rows and the
    [K, 5] requests, makes ONE wrapper call and fetches one [K, 6, N]
    result. On a CUDA device the call launches the hand-written kernel; on
    the CPU it runs the plain version (:func:`kernel_packed_burst`).
    """

    def __init__(self, weights: Weights, device: torch.device) -> None:
        self.weights = weights
        self.device = torch.device(device)
        self._chips: torch.Tensor | None = None
        self._nodes: torch.Tensor | None = None
        self._names: list[str] = []

    @property
    def names(self) -> list[str]:
        return self._names

    def put_static(self, arrays: FleetArrays) -> None:
        """Upload the metrics-version-static arrays to the device."""
        chips, nodes = stack_static(arrays)
        self._chips = torch.from_numpy(chips).to(self.device)
        self._nodes = torch.from_numpy(nodes).to(self.device)
        self._names = list(arrays.names)

    def evaluate(self, dyn: np.ndarray, request: KernelRequest) -> KernelResult:
        """One request; its admission row is ``dyn[3]`` (K = 1 of the burst)."""
        dyn = np.asarray(dyn, dtype=np.int32)
        return self.evaluate_burst(dyn, dyn[3:4], [request])[0]

    def evaluate_burst(
        self,
        dyn: np.ndarray,            # [4, N] int32 (row 3 unused)
        host_ok_k: np.ndarray,      # [K, N] int32/bool per-pod admission
        requests: "list[KernelRequest]",
    ) -> list[KernelResult]:
        """K requests in ONE call. Padding rows (all-False host_ok) are
        infeasible everywhere. Returns one trimmed KernelResult per
        request."""
        from yoda_tpu_torch.ops.cuda_kernel import fleet_eval

        if self._chips is None:
            raise RuntimeError("put_static() must run before evaluate_burst()")
        reqs = np.stack([pack_request(r) for r in requests])
        dev = self.device
        packed = fleet_eval(
            self._chips,
            self._nodes,
            torch.from_numpy(np.ascontiguousarray(dyn, dtype=np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(host_ok_k, dtype=np.int32)).to(dev),
            torch.from_numpy(reqs).to(dev),
            self.weights,
        ).cpu().numpy()
        return [result_from_packed(self._names, packed[k]) for k in range(len(requests))]
