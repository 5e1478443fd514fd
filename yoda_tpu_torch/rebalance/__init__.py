"""Goodput-driven rebalancing: background ICI defragmentation, priority
preemption, and elastic gang resize (see rebalance/rebalancer.py).

Counterpart of ``yoda_tpu/rebalance``."""

from yoda_tpu_torch.rebalance.rebalancer import (
    RebalanceReport,
    Rebalancer,
    priority_weight,
)
from yoda_tpu_torch.rebalance.score import (
    FleetOccupancy,
    HostOccupancy,
    fragmentation_score,
)

__all__ = [
    "FleetOccupancy",
    "HostOccupancy",
    "RebalanceReport",
    "Rebalancer",
    "fragmentation_score",
    "priority_weight",
]
