"""The yoda-tpu plugin set: the TPU-native re-design of the reference's
``pkg/yoda`` plugin (reference pkg/yoda/scheduler.go:43-171).

Counterpart of ``yoda_tpu/plugins/yoda/__init__.py``. This slice of the port
assembles ``mode="batch"`` only: QueueSort (``sort.YodaSort``), PreFilter
(``filter_plugin.YodaPreFilter``) and the fused Filter+PreScore+Score batch
plugin (``batch.YodaBatch``). The per-node loop-mode plugins
(YodaFilter, YodaPreScore, YodaScore, SliceProtectScore,
PreferredAffinityScore, ImageLocalityScore) wait for the port of loop
mode, and the gang and preemption plugins for theirs.
"""

from typing import Callable

from yoda_tpu_torch.config import Weights
from yoda_tpu_torch.plugins.yoda.batch import YodaBatch
from yoda_tpu_torch.plugins.yoda.filter_plugin import YodaPreFilter
from yoda_tpu_torch.plugins.yoda.sort import YodaSort


def default_plugins(
    *,
    weights: Weights | None = None,
    reserved_fn: Callable[[str], int] | None = None,
    max_metrics_age_s: float = 0.0,
    kernel_platform: str = "auto",
    kernel_backend: str = "xla",
    batch_requests: int = 1,
    reserved_map_fn: Callable | None = None,
) -> list:
    """Assemble the standard plugin set for ``mode="batch"``: the fused
    evaluation fast path (one device computation per pod or burst)."""
    return [
        YodaSort(),
        YodaPreFilter(),
        YodaBatch(
            reserved_fn,
            weights=weights,
            max_metrics_age_s=max_metrics_age_s,
            platform=kernel_platform,
            kernel_backend=kernel_backend,
            batch_requests=batch_requests,
            reserved_map_fn=reserved_map_fn,
        ),
    ]


__all__ = ["YodaBatch", "YodaPreFilter", "YodaSort", "default_plugins"]
