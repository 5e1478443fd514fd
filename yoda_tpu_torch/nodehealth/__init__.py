"""Node failure domains: the per-node health ladder and gang-whole repair.

See :mod:`yoda_tpu_torch.nodehealth.monitor` for the design discussion.
"""

from yoda_tpu_torch.nodehealth.monitor import (
    NodeHealthMonitor,
    NodeState,
    RepairReport,
)

__all__ = ["NodeHealthMonitor", "NodeState", "RepairReport"]
