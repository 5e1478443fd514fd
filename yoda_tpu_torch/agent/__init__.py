"""Node metrics agents: publishers of per-node TpuNodeMetrics CRs.

Counterpart of ``yoda_tpu/agent``, whole. On each node an agent reads TPU
hardware state and writes the node's CR. Two implementations:

- ``FakeTpuAgent``: synthetic fleets for tests and the chip smoke run,
  with simulated HBM consumption.
- ``native``: ctypes bindings over the C++ host metrics reader
  (``native/tpuinfo.cc``, built at first use into ``build/native/``) for
  real nodes, publishing through ``NativeTpuAgent``.
- ``runtime``: live runtime hardware reads (device identity, coords, HBM
  counters where exposed) overlaid onto the native inventory
  (``--runtime-probe``); this package reads no TPU runtime, so its default
  device source finds none.
- ``tpu_metrics``: typed gRPC client for the libtpu runtime-metrics
  service (``--libtpu-metrics``) — per-chip HBM occupancy read from
  whichever process owns the chips, no runtime init required.
"""

from yoda_tpu_torch.agent.fake_publisher import CHIP_SPECS, ChipSpec, FakeTpuAgent
from yoda_tpu_torch.agent.native import (
    NativeTpuAgent,
    collect_host_metrics,
    collection_source,
    load_library,
)
from yoda_tpu_torch.agent.runtime import (
    RuntimeReading,
    metrics_from_runtime,
    read_runtime,
)
from yoda_tpu_torch.agent.tpu_metrics import (
    LibtpuHbm,
    LibtpuMetricsUnavailable,
    query_hbm,
)

__all__ = [
    "CHIP_SPECS",
    "ChipSpec",
    "FakeTpuAgent",
    "LibtpuHbm",
    "LibtpuMetricsUnavailable",
    "NativeTpuAgent",
    "RuntimeReading",
    "collect_host_metrics",
    "collection_source",
    "load_library",
    "metrics_from_runtime",
    "query_hbm",
    "read_runtime",
]
