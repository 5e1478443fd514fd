"""PreScore: collect cluster-wide per-metric maxima for score normalization.

Parity with reference pkg/yoda/collection/collection.go — which ran at the
v1alpha1 "PostFilter" hook (a pre-scoring slot; modern PreScore, SURVEY.md
§3.2) and wrote cluster maxima into CycleState under key ``"Max"``
(collection.go:53-54). Differences by design:

- The reference listed ALL SCVs from the API server per pod (scheduler.go:88)
  then re-ran all three Fits predicates per SCV (collection.go:41-44). Here
  the feasible-node set is already known (Filter just computed it), so maxima
  are taken over the feasible nodes' qualifying chips straight from the
  snapshot — same resulting maxima over the same chip set, zero API reads and
  no predicate re-runs.
- Maxima initialize to 1 to keep normalization division safe — parity with
  collection.go:31-38.

Counterpart of ``yoda_tpu/plugins/yoda/collection.py``, whole: loop
mode's PreScore. The batch path takes the same maxima inside the fleet
evaluation (ops/kernel.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from yoda_tpu_torch.api.types import PodSpec, TpuChip
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import PreScorePlugin, Snapshot, Status
from yoda_tpu_torch.plugins.yoda.filter_plugin import get_request, qualifying_chips

MAX_KEY = "Max"  # key parity with reference collection.go:54


@dataclass
class MaxValueData:
    """Reference ``collection.Data``/``MaxValue`` (collection.go:10-21),
    fields renamed to the TPU metric mapping."""

    max_hbm_bandwidth: int = 1
    max_clock: int = 1
    max_tflops: int = 1
    max_hbm_free: int = 1
    max_power: int = 1
    max_hbm_total: int = 1

    def clone(self) -> "MaxValueData":
        return MaxValueData(**vars(self))

    def update(self, chip: TpuChip) -> None:
        """Reference ``ProcessMaxValueWithCard`` (collection.go:59-78)."""
        self.max_hbm_free = max(self.max_hbm_free, chip.hbm_free)
        self.max_clock = max(self.max_clock, chip.clock_mhz)
        self.max_hbm_total = max(self.max_hbm_total, chip.hbm_total)
        self.max_hbm_bandwidth = max(self.max_hbm_bandwidth, chip.hbm_bandwidth_gbps)
        self.max_tflops = max(self.max_tflops, chip.tflops_bf16)
        self.max_power = max(self.max_power, chip.power_w)


class YodaPreScore(PreScorePlugin):
    name = "yoda-prescore"

    def pre_score(
        self,
        state: CycleState,
        pod: PodSpec,
        snapshot: Snapshot,
        feasible: Sequence[str],
    ) -> Status:
        req = get_request(state)
        data = MaxValueData()
        for name in feasible:
            tpu = snapshot.get(name).tpu
            if tpu is None:
                continue
            for chip in qualifying_chips(tpu, req):
                data.update(chip)
        state.write(MAX_KEY, data)
        return Status.ok()
