"""Scheduling framework: extension points, cycle state, queue, runtime and
loop (counterpart of yoda_tpu/framework, with the reference's exports)."""

from yoda_tpu_torch.framework.interfaces import (
    Code,
    Status,
    NodeInfo,
    Snapshot,
    QueueSortPlugin,
    PreFilterPlugin,
    FilterPlugin,
    PostFilterPlugin,
    PreScorePlugin,
    ScorePlugin,
    BatchFilterScorePlugin,
    ReservePlugin,
    PermitPlugin,
    BindPlugin,
    MAX_NODE_SCORE,
)
from yoda_tpu_torch.framework.cyclestate import CycleState, StateData
from yoda_tpu_torch.framework.queue import SchedulingQueue, QueuedPodInfo
from yoda_tpu_torch.framework.runtime import BindExecutor, Framework, WaitingPod
from yoda_tpu_torch.framework.scheduler import ScheduleResult, Scheduler, SchedulerStats

__all__ = [
    "Code",
    "Status",
    "NodeInfo",
    "Snapshot",
    "QueueSortPlugin",
    "PreFilterPlugin",
    "FilterPlugin",
    "PostFilterPlugin",
    "PreScorePlugin",
    "ScorePlugin",
    "BatchFilterScorePlugin",
    "ReservePlugin",
    "PermitPlugin",
    "BindPlugin",
    "MAX_NODE_SCORE",
    "CycleState",
    "StateData",
    "SchedulingQueue",
    "QueuedPodInfo",
    "BindExecutor",
    "Framework",
    "WaitingPod",
    "Scheduler",
    "ScheduleResult",
    "SchedulerStats",
]
