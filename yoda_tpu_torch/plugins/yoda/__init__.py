"""The yoda-tpu plugin set: the TPU-native re-design of the reference's
``pkg/yoda`` plugin (reference pkg/yoda/scheduler.go:43-171).

Counterpart of ``yoda_tpu/plugins/yoda/__init__.py``. Extension-point
mapping (reference -> here):

    Less (QueueSort)            -> sort.YodaSort
    Filter                      -> filter_plugin.YodaPreFilter + YodaFilter
    PostFilter (v1alpha1 = pre- -> collection.YodaPreScore
      scoring data collection)
    Score + NormalizeScore      -> score.YodaScore
    (absent in reference)       -> accounting.ChipAccountant (Reserve),
                                   gang.GangPlugin (PreFilter+Permit),
                                   topology. / preemption. (PostFilter)

``mode="batch"`` assembles the fused Filter+PreScore+Score batch plugin
(``batch.YodaBatch``: one evaluation on the card per pod or burst, on one
device or row-sharded over a mesh with ``mesh_devices``); ``mode="loop"``
the per-node plugins (YodaFilter, YodaPreScore, YodaScore,
SliceProtectScore, PreferredAffinityScore, ImageLocalityScore), which run
on the host. ``standalone.build_stack`` adds the gang plugin, the
accountant, the preemption PostFilter and the binder.
"""

from typing import Callable

from yoda_tpu_torch.plugins.yoda.sort import YodaSort
from yoda_tpu_torch.plugins.yoda.filter_plugin import (
    YodaFilter,
    YodaPreFilter,
    REQUEST_KEY,
    get_request,
)
from yoda_tpu_torch.plugins.yoda.collection import MaxValueData, YodaPreScore, MAX_KEY
from yoda_tpu_torch.plugins.yoda.score import (
    PreferredAffinityScore,
    SliceProtectScore,
    YodaScore,
    Weights,
)
from yoda_tpu_torch.plugins.yoda.image_locality import ImageLocalityScore
from yoda_tpu_torch.plugins.yoda.batch import YodaBatch
from yoda_tpu_torch.plugins.yoda.gang import GangPlugin
from yoda_tpu_torch.plugins.yoda.preemption import TpuPreemption


def default_plugins(
    *,
    mode: str = "batch",
    weights: Weights | None = None,
    reserved_fn: Callable[[str], int] | None = None,
    max_metrics_age_s: float = 0.0,
    kernel_platform: str = "auto",
    mesh_devices: int | None = None,
    kernel_backend: str = "xla",
    batch_requests: int = 1,
    pending_fn: Callable | None = None,
    reserved_map_fn: Callable | None = None,
    reserved_delta_fn: Callable | None = None,
) -> list:
    """Assemble the standard plugin set.

    ``mode="batch"``: the fused evaluation fast path (one device
    computation per pod or burst; ``mesh_devices`` row-shards it).
    ``mode="loop"``: the per-node reference-semantics path, on the host.
    Both need YodaPreFilter (label parsing) and YodaSort; batch subsumes
    Filter+PreScore+Score. ``pending_fn`` (GangPlugin.pending_placements)
    feeds in-flight gang members' claims to admission and to the burst
    gate; ``reserved_delta_fn`` (ChipAccountant.reserved_changes_since)
    keeps the resident dynamics row current in O(changed).
    """
    base: list = [
        YodaSort(),
        YodaPreFilter(
            pending_fn=pending_fn,
            image_locality_weight=(weights or Weights()).image_locality,
            write_image_spread=(mode == "loop"),
        ),
    ]
    if mode == "batch":
        base.append(
            YodaBatch(
                reserved_fn,
                weights=weights,
                max_metrics_age_s=max_metrics_age_s,
                platform=kernel_platform,
                mesh_devices=mesh_devices,
                kernel_backend=kernel_backend,
                batch_requests=batch_requests,
                pending_fn=pending_fn,
                reserved_map_fn=reserved_map_fn,
                reserved_delta_fn=reserved_delta_fn,
            )
        )
    elif mode == "loop":
        base.extend(
            [
                YodaFilter(reserved_fn, max_metrics_age_s=max_metrics_age_s),
                YodaPreScore(),
                YodaScore(weights),
                SliceProtectScore(weights),
                PreferredAffinityScore(weights),
                ImageLocalityScore(weights),
            ]
        )
    else:
        raise ValueError(f"unknown plugin mode {mode!r}")
    return base


__all__ = [
    "GangPlugin",
    "TpuPreemption",
    "YodaBatch",
    "default_plugins",
    "YodaSort",
    "YodaFilter",
    "YodaPreFilter",
    "YodaPreScore",
    "YodaScore",
    "SliceProtectScore",
    "PreferredAffinityScore",
    "ImageLocalityScore",
    "MaxValueData",
    "Weights",
    "REQUEST_KEY",
    "MAX_KEY",
    "get_request",
]
