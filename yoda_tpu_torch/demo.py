"""In-memory fleet demo for ``python -m yoda_tpu_torch.cli --demo``: builds
a mixed synthetic fleet, schedules a workload mix, and prints the decisions
— the interactive analog of the reference's manual smoke test
(readme.md:22-25).

Counterpart of ``yoda_tpu/demo.py``, with the same fleet and workload. The
reference pins its demo's compute to the CPU; this one runs the fleet
evaluation where ``platform`` says (a ``kernel_platform`` value): on the
card by default ("auto", which raises without one), on the host with
"cpu".
"""

from __future__ import annotations

from yoda_tpu_torch import standalone
from yoda_tpu_torch.agent import FakeTpuAgent
from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.config import SchedulerConfig


def run_demo(verbosity: int = 3, platform: str = "auto") -> int:
    stack = standalone.build_stack(
        config=SchedulerConfig(kernel_platform=platform)
    )
    try:
        agent = FakeTpuAgent(stack.cluster)
        agent.add_host("v5e-pool-a", generation="v5e", chips=8)
        agent.add_host("v5e-pool-b", generation="v5e", chips=8)
        agent.add_slice("v5p-slice", generation="v5p", host_topology=(2, 2, 1))
        agent.publish_all()

        workload = [
            PodSpec("inference-0", labels={"tpu/chips": "1", "tpu/hbm": "4Gi"}),
            PodSpec("inference-1", labels={"tpu/chips": "1", "tpu/hbm": "4Gi"}),
            PodSpec("train-big", labels={"tpu/chips": "4", "tpu/hbm": "64Gi",
                                         "tpu/generation": "v5p",
                                         "tpu/priority": "10"}),
            PodSpec("batch-job", labels={"tpu/chips": "8", "tpu/priority": "-1"}),
            PodSpec("impossible", labels={"tpu/chips": "64"}),
        ]
        for pod in workload:
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=10)

        print(f"{'POD':16s} {'NODE':14s} {'PHASE':9s}")
        for pod in stack.cluster.list_pods():
            print(
                f"{pod.name:16s} {pod.node_name or '<unschedulable>':14s} "
                f"{pod.phase:9s}"
            )
        if verbosity >= 3:
            print("\nscheduling attempts:")
            for r in stack.scheduler.stats.results:
                msg = f" ({r.message})" if r.message else ""
                print(
                    f"  {r.pod_key:24s} -> {r.outcome}{msg} "
                    f"[{r.latency_s*1e3:.2f} ms]"
                )
        lat = sorted(stack.scheduler.stats.latencies())
        if lat:
            print(f"\n{stack.scheduler.stats.binds} bound, "
                  f"p50 {lat[len(lat)//2]*1e3:.2f} ms, max {lat[-1]*1e3:.2f} ms")
    finally:
        stack.close()
    return 0
