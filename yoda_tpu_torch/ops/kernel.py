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

Left out until a later slice: ``NumpyFleetKernel`` (the reference's
degraded-mode rung; the port has no fallback chain, so the numpy twin of
the scan is not carried either).
"""

from __future__ import annotations

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

_BIG = np.iinfo(np.int32).max

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
    feas_k: torch.Tensor,    # [K, N] feasible (bool or 0/1 int32)
    scores_k: torch.Tensor,  # [K, N] int32 final scores
    claim_k: torch.Tensor,   # [K, N] int32 claimable chips
    chips_k: torch.Tensor,   # [K] int32 (joint_fit_vectors)
    starts_k: torch.Tensor,  # [K] int32
    valid_k: torch.Tensor,   # [K] int32
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """The joint fit gate for plain gangs as a scan over the stacked member
    rows — the plain PyTorch version of the hand-written joint-fit kernel
    (ops/cuda_kernel.py ``joint_fit``) and of the reference's ``lax.scan``
    (yoda_tpu/ops/kernel.py ``joint_fit_scan``). Each gang starts from the
    chips consumed by every earlier FITTING gang, each member greedily
    claims the highest-scoring node with enough claimable chips left (ties
    -> first index, as ``argmax``), and a gang with any unplaceable member
    consumes nothing. Returns ``(picks [K] int32, group_ok [K] bool,
    sim [N] int32)``: the node index each row claimed (-1 when it claimed
    nothing), the gang's running fit verdict after each row (read it at
    the gang's LAST row), and the chips consumed by all fitting gangs.
    Runs on the tensors' device, one row at a time; int32 throughout."""
    feas_k = feas_k != 0
    k, n = feas_k.shape
    dev = feas_k.device
    sim = torch.zeros(n, dtype=torch.int32, device=dev)
    tent = sim.clone()
    gok = True
    picks = torch.full((k,), -1, dtype=torch.int32)
    gok_k = torch.zeros(k, dtype=torch.bool)
    chips, starts, valid = (
        v.tolist() for v in (chips_k, starts_k, valid_k)
    )
    for i in range(k):
        if starts[i]:
            # Group boundary: commit the previous gang iff it fit, then
            # restart the tentative ledger from the committed state.
            if gok:
                sim = tent.clone()
            gok = True
            tent = sim.clone()
        if valid[i]:
            ok = feas_k[i] & ((claim_k[i] - tent) >= chips[i])
            any_ok = bool(ok.any())
            if any_ok and gok:
                pick = int(torch.argmax(torch.where(ok, scores_k[i], -1)))
                tent[pick] += chips[i]
                picks[i] = pick
            gok = gok and any_ok
        gok_k[i] = gok
    if gok:
        sim = tent.clone()
    return picks.to(dev), gok_k.to(dev), sim


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
    plain scan runs over the trimmed results on the CPU. The reference's
    path for backends without a fused lowering; here it is the host
    composition :meth:`TorchFleetKernel.evaluate_joint_plan` is held
    against (it never runs on the serve path). Returns
    ``(results_per_gang, fit_per_gang, picks_per_gang)``."""
    host_ok_k, requests, offsets = stack_joint_burst(
        host_ok_groups, request_groups, minimum
    )
    flat = kern.evaluate_burst(dyn, host_ok_k, requests)
    chips_k, starts_k, valid_k = joint_fit_vectors(requests, offsets)
    m = offsets[-1]
    picks, gok_k, _sim = joint_fit_scan(
        *(
            torch.from_numpy(np.stack([getattr(r, f) for r in flat[:m]]))
            for f in ("feasible", "scores", "claimable")
        ),
        *(torch.from_numpy(v[:m]) for v in (chips_k, starts_k, valid_k)),
    )
    picks, gok_k = picks.numpy(), gok_k.numpy()
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

    Every call runs on the calling thread's current stream: a caller that
    owns a stream (the speculative placement cache) wraps its calls in
    ``torch.cuda.stream``, and the result fetch synchronizes that stream
    only. Per instance, ``launches``, ``joint_fit_launches`` and
    ``row_updates`` count the CUDA work this kernel object issued, each
    bumped where that work is launched (the wrappers take this object as
    their ``counter``; their module-wide counts cover every instance), so a
    run can tell the serve path's launches from another owner's.
    """

    def __init__(self, weights: Weights, device: torch.device) -> None:
        self.weights = weights
        self.device = torch.device(device)
        self._chips: torch.Tensor | None = None
        self._nodes: torch.Tensor | None = None
        self._names: list[str] = []
        self.launches = 0            # fleet_eval launches (128-row chunks)
        self.joint_fit_launches = 0
        self.row_updates = 0         # update_rows calls on the card

    @property
    def names(self) -> list[str]:
        return self._names

    def put_static(self, arrays: FleetArrays) -> None:
        """Upload the metrics-version-static arrays to the device."""
        chips, nodes = stack_static(arrays)
        self._chips = torch.from_numpy(chips).to(self.device)
        self._nodes = torch.from_numpy(nodes).to(self.device)
        self._names = list(arrays.names)

    def update_rows(self, arrays: FleetArrays, rows: "list[int]") -> None:
        """Apply ONLY the given (already refilled, distinct) rows of
        ``arrays`` to the device-resident static state, in place: one
        pinned host-to-device copy of the rows' payload
        (:func:`pack_row_update`, a fresh pinned buffer per update, as
        :meth:`_upload` stages every copy) and :func:`apply_row_update` on
        the current stream — O(changed x C) bytes moved instead of the
        O(N x C) of :meth:`put_static`. The caller guarantees that names
        and buckets are unchanged since the last put_static
        (FleetStateCache re-stacks otherwise)."""
        global row_update_launches
        if self._chips is None:
            self.put_static(arrays)
            return
        if not rows:
            return
        r = len(rows)
        payload = self._upload(
            row_update_size(r, self._chips.shape[1]),
            lambda buf: pack_row_update(arrays, rows, out=buf),
        )
        apply_row_update(self._chips, self._nodes, payload, r)
        if self.device.type == "cuda":
            with _count_lock:
                row_update_launches += 1
                self.row_updates += 1

    def _upload(self, size: int, fill) -> torch.Tensor:
        """A flat int32 input buffer of ``size`` words on the device,
        filled on the host by ``fill(numpy_view)``: one pinned
        host-to-device copy on a CUDA device."""
        if self.device.type == "cuda":
            staged = torch.empty(size, dtype=torch.int32, pin_memory=True)
            fill(staged.numpy())
            inputs = torch.empty(size, dtype=torch.int32, device=self.device)
            inputs.copy_(staged, non_blocking=True)
            return inputs
        buf = np.empty(size, dtype=np.int32)
        fill(buf)
        return torch.from_numpy(buf)

    def _download(self, out: torch.Tensor) -> np.ndarray:
        """``out`` on the host: one device-to-host copy into a FRESH pinned
        tensor on a CUDA device — results are views of it, and a burst's
        or joint pass's rows outlive later evaluations."""
        if self.device.type == "cuda":
            fetched = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
            fetched.copy_(out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            out = fetched
        return out.numpy()

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
        host_ok_k = np.asarray(host_ok_k)
        n, k = dyn.shape[1], len(requests)
        inputs = self._upload(
            inputs_size(n, k),
            lambda buf: pack_inputs(dyn, host_ok_k, reqs, out=buf),
        )
        out = fleet_eval(
            self._chips, self._nodes, *split_inputs(inputs, n, k), self.weights,
            counter=self,
        )
        return results_from_packed(self._names, self._download(out))

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
        inputs = self._upload(
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
        host = self._download(res)
        flat = results_from_packed(self._names, host[:rows].reshape(k, 6, n))
        picks = host[rows : rows + k]
        gok = host[rows + k : rows + 2 * k].astype(bool)
        g_count = len(request_groups)
        grouped = [flat[offsets[g] : offsets[g + 1]] for g in range(g_count)]
        fits = [bool(gok[offsets[g + 1] - 1]) for g in range(g_count)]
        picks_g = [picks[offsets[g] : offsets[g + 1]] for g in range(g_count)]
        return grouped, fits, picks_g
