"""Node scoring: weighted basic + allocation-headroom + actual-free scores.

Parity with reference pkg/yoda/score/algorithm.go:17-88:

    score = BasicScore + AllocateScore + ActualScore

- **Basic** (algorithm.go:42-69): for every qualifying chip, sum six
  normalized metrics x weights {bandwidth 1, clock 1, tflops(Core) 1,
  power 1, hbm_free(FreeMemory) 2, hbm_total(TotalMemory) 1}. The reference
  normalized clock by **MaxBandwidth** (algorithm.go:61) — fixed to MaxClock
  (SURVEY.md §3.4 quirk 1). Summing over all qualifying chips (so chip-rich
  nodes score higher) is retained, documented reference behavior
  (SURVEY.md §3.4 quirk 7).
- **Allocate** (algorithm.go:75-88): headroom after subtracting HBM claimed
  by pods already on the node (their ``tpu/hbm`` x chip count; the reference
  summed the raw ``scv/memory`` label once per pod ignoring its card count),
  ratio of total, x weight 2.
- **Actual** (algorithm.go:71-73): node free/total HBM ratio x weight 2.

Division-by-zero on TPU-less/zero-HBM nodes returns 0 (the reference would
panic on TotalMemorySum == 0).

Counterpart of ``yoda_tpu/plugins/yoda/score.py``, whole: loop mode's
Score plugins. The batch path computes the same scores for every node at
once (ops/kernel.py, ``YodaBatch._preference_bonus``).
"""

from __future__ import annotations

from yoda_tpu_torch.api.requests import LabelParseError, pod_request
from yoda_tpu_torch.config import SLICE_PROTECT_TIER, Weights
from yoda_tpu_torch.api.types import (
    PodSpec,
    TpuChip,
    TpuNodeMetrics,
    preferred_affinity_score,
    untolerated_soft_taints,
)
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import NodeInfo, ScorePlugin, Status
from yoda_tpu_torch.plugins.yoda.collection import MAX_KEY, MaxValueData
from yoda_tpu_torch.plugins.yoda.filter_plugin import (
    get_affinity,
    get_request,
    qualifying_chips,
)


def chip_score(value: MaxValueData, chip: TpuChip, w: Weights) -> int:
    """Reference ``CalculateCardScore`` (algorithm.go:58-69); each metric is
    normalized to [0,100] against the cluster max, then weighted."""
    bandwidth = chip.hbm_bandwidth_gbps * 100 // value.max_hbm_bandwidth
    clock = chip.clock_mhz * 100 // value.max_clock  # fixed: was MaxBandwidth
    tflops = chip.tflops_bf16 * 100 // value.max_tflops
    power = chip.power_w * 100 // value.max_power
    hbm_free = chip.hbm_free * 100 // value.max_hbm_free
    hbm_total = chip.hbm_total * 100 // value.max_hbm_total
    return (
        bandwidth * w.hbm_bandwidth
        + clock * w.clock
        + tflops * w.tflops
        + power * w.power
        + hbm_free * w.hbm_free
        + hbm_total * w.hbm_total
    )


def basic_score(value: MaxValueData, tpu: TpuNodeMetrics, req, w: Weights) -> int:
    """Reference ``CalculateBasicScore`` (algorithm.go:42-56): sum of
    chip_score over qualifying chips."""
    return sum(chip_score(value, c, w) for c in qualifying_chips(tpu, req))


def actual_score(tpu: TpuNodeMetrics, w: Weights) -> int:
    """Reference ``CalculateActualScore`` (algorithm.go:71-73)."""
    total = tpu.hbm_total_sum
    if total == 0:
        return 0
    return (tpu.hbm_free_sum * 100 // total) * w.actual


def allocate_score(node: NodeInfo, tpu: TpuNodeMetrics, w: Weights) -> int:
    """Reference ``CalculateAllocateScore`` (algorithm.go:75-88): HBM claimed
    by pods already placed on the node, as headroom ratio."""
    total = tpu.hbm_total_sum
    if total == 0:
        return 0
    claimed = 0
    for placed in node.pods:
        try:
            r = pod_request(placed)
        except LabelParseError:
            continue  # unparseable placed pod claims nothing
        claimed += r.hbm_per_chip * r.effective_chips
    if claimed >= total:
        return 0
    return (total - claimed) * 100 // total * w.allocate


class YodaScore(ScorePlugin):
    """The reference's Score hook (pkg/yoda/scheduler.go:99-120) without the
    per-node live SCV Get (scheduler.go:108): all inputs come from the
    snapshot and CycleState. Normalization (min-max to [0,100], all-equal
    guard) is inherited from ScorePlugin.normalize — parity with
    scheduler.go:122-147."""

    name = "yoda-score"

    def __init__(self, weights: Weights | None = None) -> None:
        self.weights = weights or Weights()

    def score(self, state: CycleState, pod: PodSpec, node: NodeInfo) -> tuple[int, Status]:
        tpu = node.tpu
        if tpu is None:
            return 0, Status.ok()
        try:
            value = state.read(MAX_KEY)
        except KeyError:
            return 0, Status.error(f"no {MAX_KEY!r} data in CycleState")
        assert isinstance(value, MaxValueData)
        req = get_request(state)
        w = self.weights
        total = (
            basic_score(value, tpu, req, w)
            + allocate_score(node, tpu, w)
            + actual_score(tpu, w)
        )
        return total, Status.ok()


class PreferredAffinityScore(ScorePlugin):
    """Soft steering and avoidance (upstream NodeAffinity scoring +
    TaintToleration's scoring half + InterPodAffinity and PodTopologySpread
    scoring): preferredDuringScheduling term-weight satisfaction
    ([0,100] x weight) minus 100 x weight per untolerated PreferNoSchedule
    taint, plus the signed preferred pod-(anti-)affinity sum and the
    [0,100] spread-balance score (evaluators built by YodaPreFilter).
    Already on the final scale — ``normalize`` is the identity (same
    pattern as SliceProtectScore)."""

    name = "yoda-preferred-affinity"

    def __init__(self, weights: Weights | None = None) -> None:
        self.weights = weights or Weights()

    def score(self, state: CycleState, pod: PodSpec, node: NodeInfo) -> tuple[int, Status]:
        w = self.weights
        total = (
            preferred_affinity_score(node.node, pod) * w.preferred_affinity
            - 100 * w.taint_prefer * untolerated_soft_taints(node.node, pod)
        )
        aff = get_affinity(state)
        if aff is not None:
            if aff.inter is not None and w.pod_affinity:
                total += aff.inter.preference(node) * w.pod_affinity
            if aff.spread is not None and w.topology_spread:
                total += aff.spread.score(node) * w.topology_spread
        return total, Status.ok()

    def normalize(self, state: CycleState, pod: PodSpec, scores: dict[str, int]) -> Status:
        return Status.ok()


class SliceProtectScore(ScorePlugin):
    """Anti-fragmentation tier (net-new; mirrors the tier in ops/kernel.py):
    pods with no tpu/topology requirement strictly prefer hosts OUTSIDE
    multi-host ICI slices, keeping slices whole for topology gangs. The
    score is already tiered (0 or SLICE_PROTECT_TIER x weight > any
    normalized metric score), so ``normalize`` is the identity."""

    name = "yoda-slice-protect"

    def __init__(self, weights: Weights | None = None) -> None:
        self.weights = weights or Weights()

    def score(self, state: CycleState, pod: PodSpec, node: NodeInfo) -> tuple[int, Status]:
        tpu = node.tpu
        if tpu is None:
            return 0, Status.ok()
        req = get_request(state)
        wants_topology = req.gang is not None and req.gang.topology is not None
        if not wants_topology and not tpu.slice_id:
            return SLICE_PROTECT_TIER * self.weights.slice_protect, Status.ok()
        return 0, Status.ok()

    def normalize(self, state: CycleState, pod: PodSpec, scores: dict[str, int]) -> Status:
        return Status.ok()
