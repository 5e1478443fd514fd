"""The yoda-tpu plugin set: the TPU-native re-design of the reference's
``pkg/yoda`` plugin (reference pkg/yoda/scheduler.go:43-171).

Counterpart of ``yoda_tpu/plugins/yoda/__init__.py``. The port assembles
``mode="batch"`` only: QueueSort (``sort.YodaSort``), PreFilter
(``filter_plugin.YodaPreFilter``) and the fused Filter+PreScore+Score batch
plugin (``batch.YodaBatch``); ``standalone.build_stack`` adds the gang
plugin (``gang.GangPlugin``: PreFilter admission, the Filter pin of
topology gangs, Permit), the accountant, the preemption PostFilter
(``preemption.TpuPreemption``) and the binder. The per-node loop-mode
plugins (YodaFilter, YodaPreScore, YodaScore, SliceProtectScore,
PreferredAffinityScore, ImageLocalityScore) wait for the port of loop
mode.
"""

from typing import Callable

from yoda_tpu_torch.config import Weights
from yoda_tpu_torch.plugins.yoda.batch import YodaBatch
from yoda_tpu_torch.plugins.yoda.filter_plugin import YodaPreFilter
from yoda_tpu_torch.plugins.yoda.gang import GangPlugin
from yoda_tpu_torch.plugins.yoda.preemption import TpuPreemption
from yoda_tpu_torch.plugins.yoda.sort import YodaSort


def default_plugins(
    *,
    weights: Weights | None = None,
    reserved_fn: Callable[[str], int] | None = None,
    max_metrics_age_s: float = 0.0,
    kernel_platform: str = "auto",
    kernel_backend: str = "xla",
    batch_requests: int = 1,
    pending_fn: Callable | None = None,
    reserved_map_fn: Callable | None = None,
    reserved_delta_fn: Callable | None = None,
) -> list:
    """Assemble the standard plugin set for ``mode="batch"``: the fused
    evaluation fast path (one device computation per pod or burst).
    ``pending_fn`` (GangPlugin.pending_placements) feeds in-flight gang
    members' claims to admission and to the burst gate;
    ``reserved_delta_fn`` (ChipAccountant.reserved_changes_since) keeps the
    resident dynamics row current in O(changed)."""
    return [
        YodaSort(),
        YodaPreFilter(pending_fn=pending_fn),
        YodaBatch(
            reserved_fn,
            weights=weights,
            max_metrics_age_s=max_metrics_age_s,
            platform=kernel_platform,
            kernel_backend=kernel_backend,
            batch_requests=batch_requests,
            pending_fn=pending_fn,
            reserved_map_fn=reserved_map_fn,
            reserved_delta_fn=reserved_delta_fn,
        ),
    ]


__all__ = [
    "GangPlugin", "TpuPreemption", "YodaBatch", "YodaPreFilter", "YodaSort",
    "default_plugins",
]
