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

The gang path's joint evaluation is here too: the stacking helpers
(:func:`stack_joint_burst`, :func:`joint_fit_vectors`), the plain
PyTorch :func:`joint_fit_scan` (the reference's ``lax.scan``, held against
the hand-written joint-fit kernel) and :func:`kernel_joint_plan`, the
plain composition of the evaluation and the scan.

The resident state's in-place row update is here as well:
:func:`pack_row_update` and :func:`apply_row_update` (the reference's
donated XLA scatter, as ``index_copy_`` along the node axis), driven by
:meth:`TorchFleetKernel.update_rows`.

The node-sharded evaluation's per-shard phases are here too:
:func:`kernel_shard_phase`, the plain version of the hand kernel's shard
entry (``parallel/sharded.py`` combines the shards between phases), built
from the same phase functions as :func:`kernel_impl`; and the reference's
one-shot :func:`fused_filter_score`.

:class:`DeviceFleetKernel` is the reference's single-device kernel name
and signature over :class:`TorchFleetKernel`. A kernel on the host bounds
torch's intra-op pool (:func:`bound_host_pool`).

The degraded-mode rung is here too: :class:`NumpyFleetKernel`, the last
level of the batch plugin's dispatch fallback chain (which demotes only a
primary on the host: one on the card never demotes). The phase functions
and :func:`joint_fit_scan` take the array operations they use as ``xp``
(:data:`TORCH_OPS`, the default, or :data:`NUMPY_OPS`), as the
reference's take ``xp=jnp`` / ``xp=np``, so the numpy evaluator runs the
plain version's arithmetic, defined once, without a torch op.
"""

from __future__ import annotations

import contextlib
import os
import threading
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

# The int32 bounds the kernels use as fillers and key offsets.
INT32_MAX = int(np.iinfo(np.int32).max)
INT32_MIN = -(2 ** 31)

# TorchFleetKernel.update_rows calls that updated resident rows on a CUDA
# device: one host-to-device copy and the index_copy_ pair each. Bumped
# under _count_lock: the serve loop and the speculation thread both update.
row_update_launches = 0
_count_lock = threading.Lock()
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


class _TorchOps:
    """The array operations of the evaluation's phase functions and of the
    fit scan, over torch tensors on whatever device they lie: the plain
    version. :data:`NUMPY_OPS` is the same interface over numpy arrays, so
    :class:`NumpyFleetKernel` runs the same arithmetic, defined once here,
    without a torch op (the reference's ``xp=jnp`` / ``xp=np`` seam)."""

    where = staticmethod(torch.where)
    maximum = staticmethod(torch.maximum)
    minimum = staticmethod(torch.minimum)

    @staticmethod
    def const(value: int, like):
        """``value`` as a 0-d int32 on ``like``'s device."""
        return torch.full((), value, dtype=torch.int32, device=like.device)

    @staticmethod
    def zeros(shape, like):
        return torch.zeros(shape, dtype=torch.int32, device=like.device)

    @staticmethod
    def i32(x):
        return x.to(torch.int32)

    @staticmethod
    def columns(v):
        """Request scalars (ints or [K] vectors) as a [K, 1] int32 column."""
        return torch.as_tensor(v, dtype=torch.int32).reshape(-1, 1)

    @staticmethod
    def total(x):
        """Sum over the last axis in 64 bits (callers wrap it to int32)."""
        return x.sum(dim=-1)

    @staticmethod
    def amax(x, axis, keepdims: bool = False):
        return x.amax(dim=axis, keepdim=keepdims)

    @staticmethod
    def amin(x, axis, keepdims: bool = False):
        return x.amin(dim=axis, keepdim=keepdims)

    @staticmethod
    def any(x):
        return x.any(dim=-1)

    @staticmethod
    def stack(xs, axis: int):
        return torch.stack(xs, dim=axis)

    @staticmethod
    def floordiv(a, b):
        return torch.div(a, b, rounding_mode="floor")

    @staticmethod
    def copy(x):
        return x.clone()

    @staticmethod
    def first_argmax(x) -> int:
        """Index of the first maximum of a 1-D ``x``."""
        return int(torch.argmax(x))

    @staticmethod
    def last_argmax(x):
        """Per row of [K, N] ``x``: the index of its LAST maximum (int32;
        argmax of the reversed row takes the first) and that maximum."""
        n = x.shape[-1]
        row = (n - 1 - torch.argmax(x.flip(-1), dim=-1)).to(torch.int32)
        return row, x.gather(-1, row.long()[:, None])[:, 0]

    @staticmethod
    def vector(values: list, like, flags: bool = False):
        """A Python list as a 1-D int32 (or bool) on ``like``'s device."""
        dtype = torch.bool if flags else torch.int32
        return torch.tensor(values, dtype=dtype, device=like.device)


class _NumpyOps:
    """:class:`_TorchOps`' interface over numpy arrays (int32 wraps as in
    torch; sums are taken in 64 bits and wrapped as there)."""

    where = staticmethod(np.where)
    maximum = staticmethod(np.maximum)
    minimum = staticmethod(np.minimum)

    @staticmethod
    def const(value: int, like):
        return np.int32(value)

    @staticmethod
    def zeros(shape, like):
        return np.zeros(shape, dtype=np.int32)

    @staticmethod
    def i32(x):
        return np.asarray(x).astype(np.int32)

    @staticmethod
    def columns(v):
        return np.asarray(v, dtype=np.int32).reshape(-1, 1)

    @staticmethod
    def total(x):
        return x.sum(axis=-1, dtype=np.int64)

    @staticmethod
    def amax(x, axis, keepdims: bool = False):
        return x.max(axis=axis, keepdims=keepdims)

    @staticmethod
    def amin(x, axis, keepdims: bool = False):
        return x.min(axis=axis, keepdims=keepdims)

    @staticmethod
    def any(x):
        return x.any(axis=-1)

    @staticmethod
    def stack(xs, axis: int):
        return np.stack(xs, axis=axis)

    @staticmethod
    def floordiv(a, b):
        return np.floor_divide(a, b)

    @staticmethod
    def copy(x):
        return x.copy()

    @staticmethod
    def first_argmax(x) -> int:
        return int(np.argmax(x))

    @staticmethod
    def last_argmax(x):
        n = x.shape[-1]
        row = (n - 1 - np.argmax(x[..., ::-1], axis=-1)).astype(np.int32)
        return row, np.take_along_axis(x, row[:, None].astype(np.intp), -1)[:, 0]

    @staticmethod
    def vector(values: list, like, flags: bool = False):
        return np.asarray(values, dtype=bool if flags else np.int32).reshape(-1)


TORCH_OPS = _TorchOps()
NUMPY_OPS = _NumpyOps()
_i32 = TORCH_OPS.i32


def _request_columns(number, hbm_mib, clock_mhz, gen_rank, wants_topology,
                     xp=TORCH_OPS):
    """Request scalars as [K, 1] int32 columns."""
    return tuple(
        xp.columns(v) for v in (number, hbm_mib, clock_mhz, gen_rank, wants_topology)
    )


def _norm(metric, maximum, xp=TORCH_OPS):
    return xp.floordiv(metric * 100, maximum)


def _rows(x, xp=TORCH_OPS):
    """Chip-axis count -> int32."""
    return xp.i32(xp.total(x))


def _qualifying(a: dict, hbm_mib, clock_mhz):
    """(healthy [N, C], hbm_ok, clock_ok, qual [K, N, C]) for [K, 1]
    request columns."""
    healthy = a["chip_valid"] & a["chip_healthy"]
    hbm_ok = healthy & (a["hbm_free_mib"] >= hbm_mib[:, :, None])
    clock_ok = healthy & (a["clock_mhz"] >= clock_mhz[:, :, None])
    return healthy, hbm_ok, clock_ok, hbm_ok & clock_ok


def _phase_filter(a: dict, number, hbm_mib, clock_mhz, gen_rank, xp=TORCH_OPS):
    """Phase 1 of the evaluation: feasibility, the first failing reason and
    the claimable chips per (request, node), and the six maxima of the
    feasible nodes' qualifying chips (0 where there are none; the caller
    floors them at 1). Returns (feasible [K, N] bool, reasons, claimable
    [K, N] int32, qual [K, N, C] bool, maxima [K, 6] int32 in the order
    bandwidth, clock, tflops, power, free HBM, total HBM)."""
    healthy, hbm_ok, clock_ok, qual = _qualifying(a, hbm_mib, clock_mhz)
    clock_c = clock_mhz[:, :, None]
    hbm_c = hbm_mib[:, :, None]
    count_healthy = _rows(healthy, xp)                       # [N]
    count_hbm = _rows(hbm_ok, xp)                            # [K, N]
    count_clock = _rows(clock_ok, xp)

    # Reservation corrections: reference kernel_impl (and
    # filter_plugin.available_chips / stale_freed_chips) parity.
    zero = xp.const(0, count_healthy)
    apparently_used = _rows(healthy & a["chip_used"], xp)
    absorbable = xp.maximum(apparently_used - a["ext_chips"], zero)
    invisible = xp.maximum(a["reserved_chips"] - absorbable, zero)
    stale_freed = xp.maximum(absorbable - a["reserved_chips"], zero)
    freed_candidates = _rows(
        healthy
        & a["chip_used"]
        & (a["clock_mhz"] >= clock_c)
        & (a["hbm_total_mib"] >= hbm_c),
        xp,
    )
    freed_candidates = xp.maximum(freed_candidates - a["ext_chips"], zero)
    freed = xp.minimum(
        stale_freed, xp.maximum(freed_candidates - a["reserved_chips"], zero)
    )
    count_avail = _rows(qual & ~a["chip_used"], xp)
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
    reasons = xp.zeros(feasible.shape, count_healthy)
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
        reasons = xp.where(cond, xp.const(code, reasons), reasons)

    # --- collection: per-request maxima over feasible nodes' qualifying chips
    cmask = feasible[:, :, None] & qual                      # [K, N, C]
    maxima = xp.stack(
        [xp.amax(xp.where(cmask, a[key], zero), (-2, -1)) for key in _MAX_KEYS],
        -1,
    )
    claimable = xp.maximum(count_avail + freed - invisible, zero)
    return feasible, reasons, claimable, qual, maxima


# The chip rows the six cluster maxima are taken over, in the order of the
# maxima columns (bandwidth, clock, tflops, power, free HBM, total HBM).
_MAX_KEYS = (
    "hbm_bandwidth", "clock_mhz", "tflops", "power_w", "hbm_free_mib",
    "hbm_total_mib",
)


def _phase_raw(a: dict, feasible, qual, maxima, weights: Weights, xp=TORCH_OPS):
    """Phase 2: the raw score of every feasible (request, node) against the
    cluster maxima ([K, 6], each at least 1); 0 elsewhere."""
    w = weights
    zero = xp.const(0, maxima)
    m = maxima.reshape(-1, 6, 1, 1)
    chip_scores = (
        _norm(a["hbm_bandwidth"], m[:, 0], xp) * w.hbm_bandwidth
        + _norm(a["clock_mhz"], m[:, 1], xp) * w.clock
        + _norm(a["tflops"], m[:, 2], xp) * w.tflops
        + _norm(a["power_w"], m[:, 3], xp) * w.power
        + _norm(a["hbm_free_mib"], m[:, 4], xp) * w.hbm_free
        + _norm(a["hbm_total_mib"], m[:, 5], xp) * w.hbm_total
    )
    basic = _rows(xp.where(qual, chip_scores, zero), xp)

    free_sum = _rows(xp.where(a["chip_valid"], a["hbm_free_mib"], zero), xp)
    total_sum = _rows(xp.where(a["chip_valid"], a["hbm_total_mib"], zero), xp)
    safe_total = xp.maximum(total_sum, xp.const(1, total_sum))
    actual = xp.where(
        total_sum > 0, xp.floordiv(free_sum * 100, safe_total), zero
    ) * w.actual
    headroom = xp.maximum(total_sum - a["claimed_hbm_mib"], zero)
    allocate = xp.where(
        total_sum > 0, xp.floordiv(headroom * 100, safe_total), zero
    ) * w.allocate
    return xp.where(feasible, basic + actual + allocate, zero)


def _raw_bounds(feasible, raw, xp=TORCH_OPS):
    """The min-max normalization's lowest and highest raw score over the
    feasible nodes, [K, 1] each. Fillers sit outside both reductions'
    ranges: raw goes negative under most-allocated's negated weights."""
    lowest = xp.amin(xp.where(feasible, raw, xp.const(INT32_MAX, raw)), -1, True)
    highest = xp.amax(xp.where(feasible, raw, xp.const(-INT32_MAX, raw)), -1, True)
    return lowest, highest


def minmax_span(lowest, highest, xp=TORCH_OPS):
    """The all-equal guard on the fleet-wide bounds: (lowest, span)."""
    lowest = xp.where(highest == lowest, lowest - 1, lowest)
    return lowest, xp.maximum(highest - lowest, xp.const(1, lowest))


def _phase_final(a: dict, feasible, raw, lowest, span, wants_topology,
                 weights: Weights, xp=TORCH_OPS):
    """Phase 3: min-max normalization to [0, 100] against the fleet-wide
    ``lowest`` / ``span`` ([K, 1]), plus the anti-fragmentation tier,
    added AFTER normalization; 0 where infeasible."""
    zero = xp.const(0, raw)
    normalized = xp.where(feasible, xp.floordiv((raw - lowest) * 100, span), zero)
    protect = xp.where(
        (wants_topology == 0) & ~a["in_slice"],
        xp.const(SLICE_PROTECT_TIER * weights.slice_protect, raw),
        zero,
    )
    return xp.where(feasible, normalized + protect, zero)


def _best_row(feasible, final, xp=TORCH_OPS):
    """Highest score, ties -> later row, over where(feasible, final, -1):
    (row [K] int32, its score [K] int32)."""
    return xp.last_argmax(xp.where(feasible, final, xp.const(-1, final)))


def kernel_impl(
    a: dict, number, hbm_mib, clock_mhz, gen_rank, wants_topology,
    weights: Weights, xp=TORCH_OPS,
):
    """The whole evaluation for K requests at once. ``a`` maps NODE_KEYS to
    [N] or [K, N] arrays (per-request rows, e.g. ``host_ok``) and
    CHIP_KEYS to [N, C] arrays (bool for the flags, int32 for the rest):
    torch tensors, or numpy arrays with ``xp=NUMPY_OPS``. Request scalars
    are ints or [K] vectors. Returns (feasible [K, N] bool, reasons, raw,
    final, claimable [K, N] int32, best [K] int32) — the reference's
    outputs with a leading request axis. It is the three phases of
    :func:`kernel_shard_phase` over one shard, with the global values
    computed in between."""
    number, hbm_mib, clock_mhz, gen_rank, wants_topology = _request_columns(
        number, hbm_mib, clock_mhz, gen_rank, wants_topology, xp
    )
    feasible, reasons, claimable, qual, maxima = _phase_filter(
        a, number, hbm_mib, clock_mhz, gen_rank, xp
    )
    raw = _phase_raw(
        a, feasible, qual, xp.maximum(maxima, xp.const(1, maxima)), weights, xp
    )
    lowest, span = minmax_span(*_raw_bounds(feasible, raw, xp), xp)
    final = _phase_final(a, feasible, raw, lowest, span, wants_topology, weights, xp)
    best, _ = _best_row(feasible, final, xp)
    best = xp.where(xp.any(feasible), best, xp.const(-1, best))
    return feasible, reasons, raw, final, claimable, best


def kernel_shard_phase(
    chips: torch.Tensor,      # [9, C, n] int32: one shard's rows
    nodes: torch.Tensor,      # [4, n] int32
    dyn: torch.Tensor,        # [4, n] int32
    host_ok_k: torch.Tensor,  # [K, n] int32
    reqs_k: torch.Tensor,     # [K, 5] int32
    phase: int,
    globals_: "torch.Tensor | None",
    out: torch.Tensor,        # [K, 6, n] int32, the shard's output rows
    partials: torch.Tensor,   # [K, words] int32
    weights: Weights,
) -> None:
    """One phase of the node-sharded evaluation over one shard's rows — the
    plain PyTorch version of the shard entry of the hand kernel
    (ops/cuda_kernel.py ``fleet_eval_shard``), built from the same phase
    functions as :func:`kernel_impl`. Phase 1 writes ``out``'s feasible,
    reason and claimable rows and ``partials`` [K, 6], the shard's maxima
    (0 where the shard has no feasible qualifying chip). Phase 2 reads the
    cross-shard maxima ``globals_`` [K, 6] (floored at 1 here) and writes
    raw and ``partials`` [K, 3]: the shard's lowest and highest feasible
    raw score (fillers INT32_MAX and -INT32_MAX) and whether any row is
    feasible. Phase 3 reads the combined ``globals_`` [K, 2] (lowest, span:
    the all-equal guard already applied) and writes final and
    ``partials`` [K, 2]: the shard's best local row (ties to the later row,
    over where(feasible, final, -1)) and its score XOR INT32_MIN — the
    little-endian words of the kernel's 64-bit key."""
    a = _inputs_dict(chips, nodes, dyn, host_ok_k)
    number, hbm_mib, clock_mhz, gen_rank, wants_topology = _request_columns(
        *reqs_k.unbind(1)
    )
    if phase == 1:
        feasible, reasons, claimable, _qual, maxima = _phase_filter(
            a, number, hbm_mib, clock_mhz, gen_rank
        )
        out[:, 0] = _i32(feasible)
        out[:, 1] = reasons
        out[:, 5] = claimable
        partials.copy_(maxima)
    elif phase == 2:
        feasible = out[:, 0] != 0
        qual = _qualifying(a, hbm_mib, clock_mhz)[3]
        raw = _phase_raw(a, feasible, qual, globals_.clamp(min=1), weights)
        out[:, 2] = raw
        lowest, highest = _raw_bounds(feasible, raw)
        partials[:, 0] = lowest[:, 0]
        partials[:, 1] = highest[:, 0]
        partials[:, 2] = _i32(feasible.any(dim=-1))
    elif phase == 3:
        feasible = out[:, 0] != 0
        final = _phase_final(
            a, feasible, out[:, 2], globals_[:, 0:1], globals_[:, 1:2],
            wants_topology, weights,
        )
        out[:, 3] = final
        row, score = _best_row(feasible, final)
        partials[:, 0] = row
        partials[:, 1] = score ^ INT32_MIN
    else:
        raise ValueError(f"phase must be 1, 2 or 3, got {phase!r}")


def _static_dict(chips: torch.Tensor, nodes: torch.Tensor) -> dict:
    """The stacked device layout ([9, C, N] chip grids, [4, N] static node
    rows) as kernel_impl's dict of [N, C] / [N] views."""
    a = {k: chips[i].T for i, k in enumerate(CHIP_KEYS)}
    a.update({k: nodes[i] for i, k in enumerate(STATIC_NODE_KEYS)})
    for k in _BOOL_KEYS & a.keys():
        a[k] = a[k] != 0
    return a


def _inputs_dict(chips, nodes, dyn, host_ok_k) -> dict:
    """kernel_impl's dict of one call's device inputs: the static layout
    (:func:`_static_dict`), the dynamics rows and the [K, N] admission."""
    a = _static_dict(chips, nodes)
    a["fresh"] = dyn[0] != 0
    a["reserved_chips"] = dyn[1]
    a["claimed_hbm_mib"] = dyn[2]
    a["host_ok"] = host_ok_k != 0
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
    a = _inputs_dict(chips, nodes, dyn, host_ok_k)
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


def inputs_size(n: int, k: int, extra: int = 0) -> int:
    """Words of a :func:`pack_inputs` buffer for N nodes, K requests and
    ``extra`` per-request side vectors."""
    return 4 * n + k * n + 5 * k + extra * k


def pack_inputs(
    dyn: np.ndarray,        # [4, N] int32
    host_ok_k: np.ndarray,  # [K, N] int32/bool
    reqs: np.ndarray,       # [K, 5] int32
    *extra: np.ndarray,     # [K] int32 side vectors (the joint-fit inputs)
    out: np.ndarray | None = None,
) -> np.ndarray:
    """An evaluation's per-call inputs in ONE flat int32 buffer, so one
    host-to-device copy moves them: dyn, then host_ok, then reqs, then
    each ``extra`` vector, each row-major. ``out`` (e.g. a pinned tensor's
    numpy view) receives them when given. :func:`split_inputs` takes the
    buffer apart again."""
    n, k = dyn.shape[1], host_ok_k.shape[0]
    size = inputs_size(n, k, len(extra))
    buf = np.empty(size, dtype=np.int32) if out is None else out
    buf[: 4 * n] = dyn.reshape(-1)
    buf[4 * n : (4 + k) * n] = host_ok_k.reshape(-1)
    at = (4 + k) * n
    buf[at : at + 5 * k] = reqs.reshape(-1)
    for i, vec in enumerate(extra):
        buf[at + (5 + i) * k : at + (6 + i) * k] = vec
    return buf


def split_inputs(
    buf: torch.Tensor, n: int, k: int, extra: int = 0
) -> tuple[torch.Tensor, ...]:
    """Views (dyn [4, N], host_ok [K, N], reqs [K, 5], then ``extra`` [K]
    vectors) of a :func:`pack_inputs` buffer, on whatever device it
    lies."""
    at = (4 + k) * n
    return (
        buf[: 4 * n].view(4, n),
        buf[4 * n : at].view(k, n),
        buf[at : at + 5 * k].view(k, 5),
    ) + tuple(buf[at + (5 + i) * k : at + (6 + i) * k] for i in range(extra))


def results_from_packed(names: list[str], packed: np.ndarray) -> list[KernelResult]:
    """Unpack a [K, 6, N] output into one KernelResult per request, trimmed
    to the real fleet (views of ``packed``, plus one bool copy of the
    feasible rows for all K)."""
    n = len(names)
    feasible = packed[:, 0, :n].astype(bool)
    results = []
    for i in range(packed.shape[0]):
        best = int(packed[i, 4, 0]) if packed.shape[2] else -1
        results.append(
            KernelResult(
                feasible=feasible[i],
                reasons=packed[i, 1, :n],
                raw_scores=packed[i, 2, :n],
                scores=packed[i, 3, :n],
                best_index=best if 0 <= best < n else -1,
                claimable=packed[i, 5, :n],
            )
        )
    return results


def row_update_size(n_rows: int, c: int) -> int:
    """Words of a :func:`pack_row_update` buffer for ``n_rows`` rows of a
    fleet with ``c`` chip columns."""
    return n_rows * (1 + len(CHIP_KEYS) * c + len(STATIC_NODE_KEYS))


def pack_row_update(
    arrays: FleetArrays, rows: "list[int]", out: np.ndarray | None = None
) -> np.ndarray:
    """Host-side payload of an in-place static row update in ONE flat int32
    buffer (``out`` receives it when given): the R row indices, then the
    rows' chip grids as [9, C, R], then their static node values as
    [4, R] — the device layout (:func:`stack_static`) restricted to the
    rows. The reference pads the rows to a power of two for its compile
    cache; the port compiles nothing per shape and sends them as they are."""
    idx = np.asarray(rows, dtype=np.int64)
    r = len(idx)
    c = arrays.padded_shape[1]
    buf = np.empty(row_update_size(r, c), dtype=np.int32) if out is None else out
    buf[:r] = idx
    at = r
    for k in CHIP_KEYS:
        buf[at : at + c * r].reshape(c, r)[:] = np.asarray(getattr(arrays, k))[idx].T
        at += c * r
    for k in STATIC_NODE_KEYS:
        buf[at : at + r] = np.asarray(getattr(arrays, k))[idx]
        at += r
    return buf


def apply_row_update(
    chips: torch.Tensor, nodes: torch.Tensor, payload: torch.Tensor, n_rows: int
) -> None:
    """Scatter a :func:`pack_row_update` payload (on the tensors' device)
    into the resident [9, C, N] chip grids and [4, N] static node rows, in
    place, along the node axis (the last). The reference's jitted
    ``.at[idx].set`` with the old buffers donated; here ``index_copy_``
    writes into the same storage. With duplicate indices ``index_copy_`` on
    CUDA is nondeterministic in which row wins, so callers pass distinct
    rows (FleetStateCache does)."""
    r = n_rows
    c = chips.shape[1]
    idx = payload[:r].to(torch.int64)
    chips.index_copy_(
        2, idx, payload[r : r + len(CHIP_KEYS) * c * r].view(len(CHIP_KEYS), c, r)
    )
    nodes.index_copy_(
        1, idx, payload[r + len(CHIP_KEYS) * c * r :].view(len(STATIC_NODE_KEYS), r)
    )


def burst_bucket(k: int, minimum: int = 1) -> int:
    """Row count of a K-request joint stacking: the configured burst width
    while K fits, else the next power of two — the reference's compile
    bucket, kept so the stacked rows match it row for row (the card
    compiles nothing per shape)."""
    if k <= minimum:
        return max(minimum, 1)
    return 1 << max(k - 1, 1).bit_length()


def stack_joint_burst(
    host_ok_groups: "list[np.ndarray]",
    request_groups: "list[list[KernelRequest]]",
    minimum: int = 1,
) -> "tuple[np.ndarray, list[KernelRequest], list[int]]":
    """Stack G gangs' per-member rows into ONE padded burst (the cross-gang
    joint dispatch): group g's members occupy flat rows
    ``offsets[g]:offsets[g+1]`` of the returned [K, N] admission matrix and
    K-long request list, padded to :func:`burst_bucket` (padding rows carry
    all-False host_ok and are infeasible everywhere). ``host_ok_groups[g]``
    is that gang's [k_g, N] admission rows. Returns (host_ok_k, requests,
    offsets) with ``len(offsets) == G + 1``."""
    flat_req: list[KernelRequest] = []
    offsets = [0]
    for reqs in request_groups:
        flat_req.extend(reqs)
        offsets.append(len(flat_req))
    if not flat_req:
        raise ValueError("stack_joint_burst needs at least one member row")
    k = burst_bucket(len(flat_req), minimum)
    n = int(host_ok_groups[0].shape[-1])
    host_ok_k = np.zeros((k, n), dtype=np.int32)
    row = 0
    for ok_rows in host_ok_groups:
        for r in np.asarray(ok_rows, dtype=np.int32).reshape(-1, n):
            host_ok_k[row] = r
            row += 1
    pad = KernelRequest(1, 0, 0, 0, 0)
    requests = flat_req + [pad] * (k - len(flat_req))
    return host_ok_k, requests, offsets


def evaluate_joint_via_burst(
    kern,
    dyn: np.ndarray,
    host_ok_groups: "list[np.ndarray]",
    request_groups: "list[list[KernelRequest]]",
    minimum: int = 1,
) -> "list[list[KernelResult]]":
    """Evaluate G gangs' members in ONE round trip through a kernel's
    ``evaluate_burst``: the per-gang rows are stacked into one padded burst
    (:func:`stack_joint_burst`) and the flat results are regrouped per
    gang."""
    host_ok_k, requests, offsets = stack_joint_burst(
        host_ok_groups, request_groups, minimum
    )
    flat = kern.evaluate_burst(dyn, host_ok_k, requests)
    return [
        flat[offsets[g] : offsets[g + 1]] for g in range(len(request_groups))
    ]


def joint_fit_vectors(
    requests: "list[KernelRequest]", offsets: "list[int]"
) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """Per-row side inputs for :func:`joint_fit_scan`, aligned with a
    :func:`stack_joint_burst` stacking: chip demand per member row
    (``max(number, 1)``, the same floor the serve path applies), a
    group-start flag at each ``offsets[g]``, and a validity flag (padding
    rows are invalid: zero demand, never picked, and they cannot fail the
    — nonexistent — gang they pad)."""
    k = len(requests)
    chips = np.array([max(r.number, 1) for r in requests], dtype=np.int32)
    starts = np.zeros(k, dtype=np.int32)
    valid = np.zeros(k, dtype=np.int32)
    for g in range(len(offsets) - 1):
        starts[offsets[g]] = 1
    valid[: offsets[-1]] = 1
    chips *= valid
    return chips, starts, valid


def joint_fit_scan(
    feas_k,    # [K, N] feasible (bool or 0/1 int32)
    scores_k,  # [K, N] int32 final scores
    claim_k,   # [K, N] int32 claimable chips
    chips_k,   # [K] int32 (joint_fit_vectors)
    starts_k,  # [K] int32
    valid_k,   # [K] int32
    xp=TORCH_OPS,
):
    """The joint fit gate for plain gangs as a scan over the stacked member
    rows — the plain version of the hand-written joint-fit kernel
    (ops/cuda_kernel.py ``joint_fit``) and of the reference's ``lax.scan``
    (yoda_tpu/ops/kernel.py ``joint_fit_scan``). Each gang starts from the
    chips consumed by every earlier FITTING gang, each member greedily
    claims the highest-scoring node with enough claimable chips left (ties
    -> first index, as ``argmax``), and a gang with any unplaceable member
    consumes nothing. Returns ``(picks [K] int32, group_ok [K] bool,
    sim [N] int32)``: the node index each row claimed (-1 when it claimed
    nothing), the gang's running fit verdict after each row (read it at
    the gang's LAST row), and the chips consumed by all fitting gangs.
    One row at a time, int32 throughout: over torch tensors on their
    device, or over numpy arrays with ``xp=NUMPY_OPS`` (the numpy
    evaluator's scan, which runs no torch op)."""
    feas_k = feas_k != 0
    k, n = feas_k.shape
    sim = xp.zeros(n, scores_k)
    tent = xp.copy(sim)
    gok = True
    picks = [-1] * k
    gok_k = [False] * k
    chips, starts, valid = (v.tolist() for v in (chips_k, starts_k, valid_k))
    for i in range(k):
        if starts[i]:
            # Group boundary: commit the previous gang iff it fit, then
            # restart the tentative ledger from the committed state.
            if gok:
                sim = xp.copy(tent)
            gok = True
            tent = xp.copy(sim)
        if valid[i]:
            ok = feas_k[i] & ((claim_k[i] - tent) >= chips[i])
            any_ok = bool(ok.any())
            if any_ok and gok:
                pick = xp.first_argmax(xp.where(ok, scores_k[i], xp.const(-1, tent)))
                tent[pick] += chips[i]
                picks[i] = pick
            gok = gok and any_ok
        gok_k[i] = gok
    if gok:
        sim = xp.copy(tent)
    return xp.vector(picks, sim), xp.vector(gok_k, sim, flags=True), sim


def kernel_joint_plan(
    chips: torch.Tensor,
    nodes: torch.Tensor,
    dyn: torch.Tensor,
    host_ok_k: torch.Tensor,
    reqs_k: torch.Tensor,
    chips_k: torch.Tensor,
    starts_k: torch.Tensor,
    valid_k: torch.Tensor,
    weights: Weights,
):
    """Admission + score + block plan, plainly: the K-row evaluation
    (:func:`kernel_packed_burst`) feeding the joint fit scan
    (:func:`joint_fit_scan`) — the plain composition that
    :meth:`TorchFleetKernel.evaluate_joint_plan` runs as two hand kernels
    on the card. Returns ``(packed [K, 6, N], picks [K], group_ok [K]
    int32, sim [N])``."""
    packed = kernel_packed_burst(chips, nodes, dyn, host_ok_k, reqs_k, weights)
    picks, gok_k, sim = joint_fit_scan(
        packed[:, 0], packed[:, 3], packed[:, 5], chips_k, starts_k, valid_k
    )
    return packed, picks, _i32(gok_k), sim


def evaluate_joint_plan_via_burst(
    kern,
    dyn: np.ndarray,
    host_ok_groups: "list[np.ndarray]",
    request_groups: "list[list[KernelRequest]]",
    minimum: int = 1,
) -> "tuple[list[list[KernelResult]], list[bool], list[np.ndarray]]":
    """The fit-gated joint evaluation composed on the host: member rows go
    through the kernel's own ``evaluate_burst`` (one round trip) and the
    scan runs over the trimmed results in numpy (:func:`joint_fit_scan`
    with ``xp=NUMPY_OPS``), so with :class:`NumpyFleetKernel` the whole
    path runs no torch op. The reference's path for backends without a
    fused lowering (the numpy evaluator, the node-sharded kernel); the
    host composition :meth:`TorchFleetKernel.evaluate_joint_plan` is held
    against. Returns ``(results_per_gang, fit_per_gang, picks_per_gang)``."""
    host_ok_k, requests, offsets = stack_joint_burst(
        host_ok_groups, request_groups, minimum
    )
    flat = kern.evaluate_burst(dyn, host_ok_k, requests)
    chips_k, starts_k, valid_k = joint_fit_vectors(requests, offsets)
    m = offsets[-1]
    picks, gok_k, _sim = joint_fit_scan(
        *(
            np.stack([getattr(r, f) for r in flat[:m]])
            for f in ("feasible", "scores", "claimable")
        ),
        chips_k[:m], starts_k[:m], valid_k[:m],
        xp=NUMPY_OPS,
    )
    g_count = len(request_groups)
    grouped = [flat[offsets[g] : offsets[g + 1]] for g in range(g_count)]
    fits = [bool(gok_k[offsets[g + 1] - 1]) for g in range(g_count)]
    picks_g = [picks[offsets[g] : offsets[g + 1]] for g in range(g_count)]
    return grouped, fits, picks_g


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


# The host evaluation's intra-op pool. The plain version's tensors are
# small (one int32 per node and chip), so extra threads buy little, and a
# pool of one thread per core in each of several processes on one host
# (scheduler lanes, test workers) spins them against each other, and each
# process's evaluations slow down many times over (host_pool_drive.py).
# The card's work is not affected, and nothing here chooses between the
# card and the host.
HOST_THREADS_CAP = 2


def host_threads(lanes: int = 1) -> int:
    """The intra-op thread count a process evaluating on the host keeps:
    the host's cores shared among ``lanes`` processes, at most
    :data:`HOST_THREADS_CAP`."""
    share = (os.cpu_count() or 1) // max(int(lanes), 1)
    return max(1, min(HOST_THREADS_CAP, share))


def bound_host_pool(lanes: int = 1) -> None:
    """Lower torch's intra-op pool to :func:`host_threads` (never raise
    it)."""
    n = host_threads(lanes)
    if torch.get_num_threads() > n:
        torch.set_num_threads(n)


def upload(device: torch.device, size: int, fill) -> torch.Tensor:
    """A flat int32 input buffer of ``size`` words on ``device``, filled on
    the host by ``fill(numpy_view)``: one pinned host-to-device copy (a
    fresh pinned buffer per call) on a CUDA device."""
    if device.type == "cuda":
        staged = torch.empty(size, dtype=torch.int32, pin_memory=True)
        fill(staged.numpy())
        inputs = torch.empty(size, dtype=torch.int32, device=device)
        inputs.copy_(staged, non_blocking=True)
        return inputs
    buf = np.empty(size, dtype=np.int32)
    fill(buf)
    return torch.from_numpy(buf)


def download(out: torch.Tensor) -> np.ndarray:
    """``out`` on the host: one device-to-host copy into a FRESH pinned
    tensor on a CUDA device (its current stream synchronized) — results
    are views of it, and a burst's or joint pass's rows outlive later
    evaluations."""
    if out.device.type == "cuda":
        fetched = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
        fetched.copy_(out, non_blocking=True)
        torch.cuda.current_stream(out.device).synchronize()
        out = fetched
    return out.numpy()


class TorchFleetKernel:
    """Evaluator with device-resident fleet state — the port's
    ``FleetKernelLike`` (reference kernel.py:701-816).

    :meth:`put_static` uploads the [9, C, N] chip grids and the static node
    rows to ``device`` once per metrics version. Each evaluation then packs
    the [4, N] dynamics, the [K, N] admission rows and the [K, 5] requests
    into one buffer (:func:`pack_inputs`), makes ONE wrapper call and
    fetches one [K, 6, N] result. On a CUDA device that is one pinned
    host-to-device copy, the hand-written kernel's launch (one per 128
    rows) and one device-to-host copy into pinned memory; on the CPU the
    same buffer feeds the plain version (:func:`kernel_packed_burst`).
    :meth:`evaluate_joint_plan` adds the joint-fit scan to the same round
    trip: its side inputs ride the same upload, the scan reads the
    evaluation's rows where they lie, and its picks, verdicts and ledger
    come back in the same download.

    Every call runs on the calling thread's current stream, or on
    ``stream`` when one is given (a scheduler lane's kernel owns one, so
    lanes on their own threads launch and fetch without waiting on each
    other's work): a caller that owns a stream (the speculative placement
    cache) may also wrap its calls in ``torch.cuda.stream``. The result
    fetch synchronizes that stream only. Per instance, ``launches``, ``joint_fit_launches`` and
    ``row_updates`` count the CUDA work this kernel object issued, each
    bumped where that work is launched (the wrappers take this object as
    their ``counter``; their module-wide counts cover every instance), so a
    run can tell the serve path's launches from another owner's.
    """

    def __init__(
        self, weights: Weights, device: torch.device, stream=None
    ) -> None:
        self.weights = weights
        self.device = torch.device(device)
        if self.device.type == "cpu":
            bound_host_pool()
        # A torch.cuda.Stream every call of this kernel runs on; None =
        # the calling thread's current stream.
        self.stream = stream
        self._chips: torch.Tensor | None = None
        self._nodes: torch.Tensor | None = None
        self._names: list[str] = []
        self.launches = 0            # fleet_eval launches (128-row chunks)
        self.joint_fit_launches = 0
        self.row_updates = 0         # update_rows calls on the card

    @property
    def names(self) -> list[str]:
        return self._names

    def _on_stream(self):
        """The context every device call of this kernel runs in."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def put_static(self, arrays: FleetArrays) -> None:
        """Upload the metrics-version-static arrays to the device."""
        with self._on_stream():
            chips, nodes = stack_static(arrays)
            self._chips = torch.from_numpy(chips).to(self.device)
            self._nodes = torch.from_numpy(nodes).to(self.device)
            self._names = list(arrays.names)

    def update_rows(self, arrays: FleetArrays, rows: "list[int]") -> None:
        """Apply ONLY the given (already refilled, distinct) rows of
        ``arrays`` to the device-resident static state, in place: one
        pinned host-to-device copy of the rows' payload
        (:func:`pack_row_update`, a fresh pinned buffer per update, as
        :func:`upload` stages every copy) and :func:`apply_row_update` on
        the current stream — O(changed x C) bytes moved instead of the
        O(N x C) of :meth:`put_static`. The caller guarantees that names
        and buckets are unchanged since the last put_static
        (FleetStateCache re-stacks otherwise)."""
        global row_update_launches
        with self._on_stream():
            if self._chips is None:
                self.put_static(arrays)
                return
            if not rows:
                return
            r = len(rows)
            payload = upload(
                self.device,
                row_update_size(r, self._chips.shape[1]),
                lambda buf: pack_row_update(arrays, rows, out=buf),
            )
            apply_row_update(self._chips, self._nodes, payload, r)
            if self.device.type == "cuda":
                with _count_lock:
                    row_update_launches += 1
                    self.row_updates += 1

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
        with self._on_stream():
            from yoda_tpu_torch.ops.cuda_kernel import fleet_eval

            if self._chips is None:
                raise RuntimeError("put_static() must run before evaluate_burst()")
            reqs = np.stack([pack_request(r) for r in requests])
            host_ok_k = np.asarray(host_ok_k)
            n, k = dyn.shape[1], len(requests)
            inputs = upload(
                self.device,
                inputs_size(n, k),
                lambda buf: pack_inputs(dyn, host_ok_k, reqs, out=buf),
            )
            out = fleet_eval(
                self._chips, self._nodes, *split_inputs(inputs, n, k), self.weights,
                counter=self,
            )
            return results_from_packed(self._names, download(out))

    def evaluate_joint(
        self,
        dyn: np.ndarray,
        host_ok_groups: "list[np.ndarray]",
        request_groups: "list[list[KernelRequest]]",
        minimum: int = 1,
    ) -> "list[list[KernelResult]]":
        """G gangs' member rows in ONE round trip (the joint placement of
        topology gangs, whose fit gate is the host block planner): stacked
        into one padded burst and regrouped per gang
        (:func:`evaluate_joint_via_burst`)."""
        return evaluate_joint_via_burst(
            self, dyn, host_ok_groups, request_groups, minimum
        )

    def evaluate_joint_plan(
        self,
        dyn: np.ndarray,
        host_ok_groups: "list[np.ndarray]",
        request_groups: "list[list[KernelRequest]]",
        minimum: int = 1,
    ) -> "tuple[list[list[KernelResult]], list[bool], list[np.ndarray]]":
        """G plain gangs' admission + scoring + cross-gang fit gate in ONE
        round trip: one upload (dynamics, admission rows, requests and the
        :func:`joint_fit_vectors` side inputs), the fleet evaluation, the
        joint-fit scan over its rows on the same device, and one download
        of the [K, 6, N] rows, picks, verdicts and ledger. On a CUDA
        device both steps are the hand kernels (``fleet_eval`` then
        ``joint_fit`` on the same stream) or the call raises; on the CPU
        their plain versions. Only the real member rows (``offsets[-1]``)
        are evaluated: the reference's padding rows are invalid and change
        no pick, verdict or ledger. Returns ``(results_per_gang,
        fit_per_gang, picks_per_gang)``."""
        with self._on_stream():
            from yoda_tpu_torch.ops.cuda_kernel import fleet_eval, joint_fit

            if self._chips is None:
                raise RuntimeError(
                    "put_static() must run before evaluate_joint_plan()"
                )
            host_ok_k, requests, offsets = stack_joint_burst(
                host_ok_groups, request_groups, minimum
            )
            k = offsets[-1]
            host_ok_k, requests = host_ok_k[:k], requests[:k]
            side = joint_fit_vectors(requests, offsets)
            reqs = np.stack([pack_request(r) for r in requests])
            n = dyn.shape[1]
            inputs = upload(
                self.device,
                inputs_size(n, k, len(side)),
                lambda buf: pack_inputs(dyn, host_ok_k, reqs, *side, out=buf),
            )
            d_dyn, d_ok, d_reqs, *d_side = split_inputs(inputs, n, k, len(side))
            rows = k * 6 * n
            res = torch.empty(rows + 2 * k + n, dtype=torch.int32, device=self.device)
            packed = res[:rows].view(k, 6, n)
            fleet_eval(
                self._chips, self._nodes, d_dyn, d_ok, d_reqs, self.weights,
                out=packed, counter=self,
            )
            joint_fit(packed, *d_side, out=res[rows:], counter=self)
            host = download(res)
            flat = results_from_packed(self._names, host[:rows].reshape(k, 6, n))
            picks = host[rows : rows + k]
            gok = host[rows + k : rows + 2 * k].astype(bool)
            g_count = len(request_groups)
            grouped = [flat[offsets[g] : offsets[g + 1]] for g in range(g_count)]
            fits = [bool(gok[offsets[g + 1] - 1]) for g in range(g_count)]
            picks_g = [picks[offsets[g] : offsets[g + 1]] for g in range(g_count)]
            return grouped, fits, picks_g


class DeviceFleetKernel(TorchFleetKernel):
    """The reference's single-device kernel by its name and signature
    (reference ops/kernel.py:719): a :class:`TorchFleetKernel` on
    ``device``, which defaults to ``resolve_device("auto")`` — the card,
    raising without one, never a quiet host path."""

    def __init__(self, weights: Weights, device=None, stream=None) -> None:
        super().__init__(
            weights,
            resolve_device("auto") if device is None else device,
            stream,
        )


class NumpyFleetKernel:
    """Host evaluator in numpy with :class:`TorchFleetKernel`'s contract:
    the last rung of the dispatch fallback chain (plugins/yoda/batch.py
    ``YodaBatch._dispatch``, the reference's ``NumpyFleetKernel``). It
    runs the plain version's phase functions and fit scan over numpy
    arrays (``xp=NUMPY_OPS``), so its arithmetic is the one the hand
    kernels are held against, int32 result for int32 result. No torch op
    runs on its path, as in the reference, so a fault in torch cannot take
    it down with the levels above it. The chain reaches it only from a
    primary on the host."""

    def __init__(self, weights: Weights) -> None:
        self.weights = weights
        self._static: dict | None = None
        self._names: list[str] = []

    @property
    def names(self) -> list[str]:
        return self._names

    def put_static(self, arrays: FleetArrays) -> None:
        # References, not copies: the batch plugin's and the resident
        # cache's in-place row refills stay visible.
        self._static = {
            k: np.asarray(getattr(arrays, k)) for k in STATIC_NODE_KEYS + CHIP_KEYS
        }
        self._names = list(arrays.names)

    def update_rows(self, arrays: FleetArrays, rows: "list[int]") -> None:
        """No device state: put_static stored REFERENCES into ``arrays``,
        so the caller's in-place row refills are already visible. Re-sync
        only if the arrays object itself was swapped."""
        if self._static is None or self._static["chip_valid"] is not arrays.chip_valid:
            self.put_static(arrays)

    def _packed(self, dyn: np.ndarray, host_ok: np.ndarray, reqv: np.ndarray) -> np.ndarray:
        """One request -> [6, N] int32 rows, as the hand kernel packs them."""
        a = dict(self._static)
        a["fresh"] = dyn[0] != 0
        a["reserved_chips"] = np.asarray(dyn[1], dtype=np.int32)
        a["claimed_hbm_mib"] = np.asarray(dyn[2], dtype=np.int32)
        a["host_ok"] = np.asarray(host_ok) != 0
        feasible, reasons, raw, final, claimable, best = kernel_impl(
            a, *(int(v) for v in reqv), weights=self.weights, xp=NUMPY_OPS
        )
        return np.stack([
            feasible[0].astype(np.int32), reasons[0], raw[0], final[0],
            np.full_like(final[0], best[0]), claimable[0],
        ])

    def evaluate(self, dyn: np.ndarray, request: KernelRequest) -> KernelResult:
        """One request; its admission row is ``dyn[3]``."""
        return self.evaluate_burst(dyn, np.asarray(dyn)[3:4], [request])[0]

    def evaluate_burst(
        self,
        dyn: np.ndarray,
        host_ok_k: np.ndarray,
        requests: "list[KernelRequest]",
    ) -> list[KernelResult]:
        """K requests, one host loop: this path runs only in degraded mode,
        so it protects memory ([N, C] per request), not amortization."""
        if self._static is None:
            raise RuntimeError("put_static() must run before evaluate_burst()")
        dyn = np.asarray(dyn)
        packed = np.stack([
            self._packed(dyn, host_ok_k[k], pack_request(r))
            for k, r in enumerate(requests)
        ])
        return results_from_packed(self._names, packed)

    def evaluate_joint(
        self,
        dyn: np.ndarray,
        host_ok_groups: "list[np.ndarray]",
        request_groups: "list[list[KernelRequest]]",
        minimum: int = 1,
    ) -> "list[list[KernelResult]]":
        return evaluate_joint_via_burst(
            self, dyn, host_ok_groups, request_groups, minimum
        )

    def evaluate_joint_plan(
        self,
        dyn: np.ndarray,
        host_ok_groups: "list[np.ndarray]",
        request_groups: "list[list[KernelRequest]]",
        minimum: int = 1,
    ) -> "tuple[list[list[KernelResult]], list[bool], list[np.ndarray]]":
        """The fused plan's degraded-mode twin: the numpy burst loop, then
        the numpy fit scan (:func:`evaluate_joint_plan_via_burst`)."""
        return evaluate_joint_plan_via_burst(
            self, dyn, host_ok_groups, request_groups, minimum
        )


def own_dyn(arrays: FleetArrays) -> np.ndarray:
    """The arrays' own [4, N] dynamics (their fresh, reserved, claimed and
    admission rows, in DYN_KEYS order): what a one-shot evaluation reads."""
    return np.stack(
        [np.asarray(getattr(arrays, key), dtype=np.int32) for key in DYN_KEYS]
    )


def fused_filter_score(
    arrays: FleetArrays,
    request: "KernelRequest | TpuRequest",
    *,
    weights: Weights | None = None,
) -> KernelResult:
    """One-shot evaluation of one request against ``arrays`` as they stand
    (:func:`own_dyn`): the reference's ``fused_filter_score``. It uploads
    the fleet to the default device (ops.kernel.resolve_device("auto")),
    evaluates and fetches; hold a :class:`TorchFleetKernel` to evaluate many
    pods against one upload."""
    if isinstance(request, TpuRequest):
        request = KernelRequest.from_request(request)
    kern = TorchFleetKernel(weights or Weights(), resolve_device("auto"))
    kern.put_static(arrays)
    return kern.evaluate(own_dyn(arrays), request)
