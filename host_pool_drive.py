"""Six processes at once, each running the body of
``tests/test_scale.py::TestIncrementalAtScale`` on one package: 16,384
hosts of 8 chips, then 8 rounds of a one-host value refresh and a 4-chip
pod, on the host (the reference's JAX on the CPU; the port's
``kernel_platform: cpu``).

It measures what a CPU shared by several scheduler or test processes
does to each package's host evaluation: each child prints the 8 rounds'
milliseconds (what the test bounds at 1,600) and its whole wall time.

    python3 host_pool_drive.py [--procs 6] [--packages yoda_tpu,yoda_tpu_torch]

Prints one JSON object per package with each child's numbers (and its
torch intra-op pool), then their minimum and maximum.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

N_HOSTS = 16384
ROUNDS = 8


def child(pkg: str) -> dict:
    t_start = time.monotonic()
    if pkg == "yoda_tpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from yoda_tpu.agent import FakeTpuAgent
        from yoda_tpu.api.types import PodSpec
        from yoda_tpu.standalone import build_stack

        stack = build_stack()
    else:
        from yoda_tpu_torch.agent import FakeTpuAgent
        from yoda_tpu_torch.api.types import PodSpec
        from yoda_tpu_torch.config import SchedulerConfig
        from yoda_tpu_torch.standalone import build_stack

        stack = build_stack(config=SchedulerConfig(kernel_platform="cpu"))
    import torch

    agent = FakeTpuAgent(stack.cluster)
    for i in range(N_HOSTS):
        agent.add_host(f"h{i:05d}", chips=8)
    agent.publish_all()
    stack.cluster.create_pod(PodSpec("warm", labels={"tpu/chips": "1"}))
    stack.scheduler.run_until_idle(max_wall_s=300)
    stack.cluster.delete_pod("default/warm")
    stack.scheduler.run_until_idle(max_wall_s=30)
    t0 = time.monotonic()
    for k in range(ROUNDS):
        agent.set_chip_health(f"h{k:05d}", chip_index=0, healthy=False)
        agent.refresh(f"h{k:05d}")
        stack.cluster.create_pod(
            PodSpec(f"p{k}", labels={"tpu/chips": "4", "tpu/hbm": "2Gi"})
        )
        stack.scheduler.run_until_idle(max_wall_s=60)
    rounds_ms = (time.monotonic() - t0) * 1e3
    bound = [p for p in stack.cluster.list_pods() if p.node_name]
    assert len(bound) == ROUNDS, len(bound)
    return {
        "rounds_ms": round(rounds_ms, 1),
        "total_s": round(time.monotonic() - t_start, 2),
        "torch_threads": torch.get_num_threads(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--packages", default="yoda_tpu,yoda_tpu_torch")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for pkg in args.packages.split(","):
        procs = [
            subprocess.Popen(
                [sys.executable, __file__, "--child", pkg],
                stdout=subprocess.PIPE, env=env, text=True,
            )
            for _ in range(args.procs)
        ]
        rows = []
        for p in procs:
            out, _ = p.communicate(timeout=1200)
            if p.returncode != 0:
                raise SystemExit(f"{pkg} child exited {p.returncode}")
            rows.append(json.loads(out.strip().splitlines()[-1]))
        ms = [r["rounds_ms"] for r in rows]
        print(json.dumps({
            "package": pkg, "procs": args.procs,
            "rounds_ms_min": min(ms), "rounds_ms_max": max(ms),
            "children": rows,
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
