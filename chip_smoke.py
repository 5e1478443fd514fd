"""Smoke test of the PyTorch/H100 port (yoda_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. Device: the card's name and power limit (nvidia-smi), then the build of
   the hand-written CUDA kernel from yoda_tpu_torch/csrc/fleet_eval.cu.
2. Kernel against its plain PyTorch version on the card: seeded fleets of
   8 chips per node at the main path's shapes and beyond, default and
   most-allocated weights; all six output rows must be exactly equal
   (int32, tolerance 0). Per shape: the kernel's time (median of CUDA-event
   timings after warm-up), the plain version's, and the bound (the bytes
   the function must move over the card's 3.35 TB/s).
3. The main path: the port's build_stack(mode="batch") over its FakeCluster,
   a 5,000-node fleet published by its FakeTpuAgent (512 v5p 2x2x1 slices
   = 2,048 hosts x 4 chips, plus 2,952 v5e hosts x 8 chips), then (a) 64
   singleton pods at batch_requests 1 and (b) 256 at batch_requests 16,
   with mixed tpu/chips, tpu/hbm, tpu/clock and tpu/generation labels.
   Every pod must bind without over-committing a host, every evaluation
   must have launched the hand kernel (launches == dispatch_count, which
   counts burst dispatches too), with no dispatch error, and the same pod
   script through kernel_platform "cpu" (the plain version) must bind
   every pod to the same node.
4. One line {"kernels": [...]} with the kernel's launches on the main
   path, its largest difference from the plain version and its times.

The last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12       # H100 SXM non-tensor-core 32-bit rate
OPS_PER_CHIP_ELEMENT = 60     # integer ops per (chip, request) pair, both passes

KERNEL_SHAPES = [  # (real nodes, padded nodes, requests K)
    (37, 64, 1),
    (256, 256, 8),
    (5000, 8192, 1),
    (5000, 8192, 16),
    (65536, 65536, 16),
]
MAIN_PATH_SHAPE = (5000, 8192, 16)
CHIPS = 8
REQUEST_TABLE = np.array(
    [[1, 0, 0, 0, 0], [2, 8192, 0, 0, 0], [4, 4096, 900, 5, 1], [8, 15360, 990, 6, 0]],
    dtype=np.int32,
)


def fail(phase: str, err: BaseException | str) -> None:
    print(f"FAILED in {phase}: {err}", file=sys.stderr)
    sys.exit(1)


def random_fleet(n_real: int, n_pad: int, seed: int):
    """Seeded stacked fleet in the device layout: chips [9, C, N], static
    nodes [4, N], dynamics [4, N] (rows >= n_real are padding)."""
    rng = np.random.default_rng(seed)
    valid = np.zeros(n_pad, dtype=np.int32)
    valid[:n_real] = 1
    grid = (CHIPS, n_pad)
    total = np.full(grid, 16 * 1024, dtype=np.int32)
    free = (total - rng.integers(0, 16 * 1024, size=grid)).astype(np.int32)
    chips = np.stack(
        [
            np.broadcast_to(valid, grid),
            valid * (rng.random(grid) > 0.1),
            free < total,
            free,
            total,
            rng.integers(700, 1000, size=grid),
            rng.integers(400, 900, size=grid),
            rng.integers(100, 300, size=grid),
            rng.integers(100, 200, size=grid),
        ]
    ).astype(np.int32) * valid
    nodes = np.stack(
        [
            valid,
            rng.random(n_pad) > 0.5,
            rng.integers(2, 7, size=n_pad),
            rng.integers(0, 3, size=n_pad),
        ]
    ).astype(np.int32)
    dyn = np.stack(
        [
            valid * (rng.random(n_pad) > 0.05),
            rng.integers(0, 4, size=n_pad),
            rng.integers(0, 64 * 1024, size=n_pad),
            np.zeros(n_pad),
        ]
    ).astype(np.int32)
    return chips, nodes, dyn


def bound_ms(n: int, k: int, c: int = CHIPS) -> float:
    """Least time for the evaluation: each input read once, each output
    written once, over the memory rate (the operations' time is far
    smaller)."""
    in_bytes = (9 * c * n + 4 * n + 4 * n + k * n + 5 * k) * 4
    out_bytes = 6 * k * n * 4
    ops_s = OPS_PER_CHIP_ELEMENT * c * n * k / INT32_OPS_PER_S
    return max((in_bytes + out_bytes) / MEM_BYTES_PER_S, ops_s) * 1e3


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi}")
    from yoda_tpu_torch.ops import cuda_kernel

    t0 = time.monotonic()
    lib = cuda_kernel.build()
    print(f"built {lib.name} in {time.monotonic() - t0:.2f} s")
    return kind, smi


def phase_kernel() -> tuple[list[dict], dict]:
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.ops.cuda_kernel import fleet_eval
    from yoda_tpu_torch.ops.kernel import kernel_packed_burst

    dev = torch.device("cuda", 0)
    weight_sets = {
        "least-allocated": SchedulerConfig().effective_weights(),
        "most-allocated": SchedulerConfig(
            scoring_strategy="most-allocated"
        ).effective_weights(),
    }
    rows = []
    for n_real, n_pad, k in KERNEL_SHAPES:
        chips, nodes, dyn = random_fleet(n_real, n_pad, seed=n_pad + k)
        rng = np.random.default_rng(k)
        host_ok = (rng.random((k, n_pad)) > 0.2).astype(np.int32)
        if k > 1:
            host_ok[-1] = 0  # an all-False padding row
        reqs = REQUEST_TABLE[np.arange(k) % len(REQUEST_TABLE)]
        args = [
            torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (chips, nodes, dyn, host_ok, reqs)
        ]
        for wname, w in weight_sets.items():
            got = fleet_eval(*args, w)
            want = kernel_packed_burst(*args, w)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            if not torch.equal(got, want):
                bad = (got != want).nonzero()[:5].tolist()
                raise AssertionError(
                    f"kernel != plain at nodes={n_real} K={k} {wname}: "
                    f"max |diff| {err}, first [k, row, node] {bad}"
                )
            if k > 1 and int(got[-1, 0].sum()) != 0:
                raise AssertionError("padding row came out feasible")
            row = dict(
                nodes=n_real, padded=n_pad, k=k, weights=wname, max_abs_err=err,
                tolerance=0, bound_ms=bound_ms(n_pad, k),
            )
            if wname == "least-allocated":
                row["ms"] = cuda_ms(lambda: fleet_eval(*args, w))
                row["plain_ms"] = cuda_ms(
                    lambda: kernel_packed_burst(*args, w), iters=10
                )
            rows.append(row)
            print("kernel", json.dumps(row))
    main = next(
        r for r in rows
        if (r["nodes"], r["padded"], r["k"]) == MAIN_PATH_SHAPE and "ms" in r
    )
    return rows, main


def fleet_and_pods(seed: int):
    """The 5,000-node fleet recipe and the 320-pod script."""
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(64 + 256):
        labels = {}
        gen = rng.choice(["", "v5e", "v5p"], p=[0.5, 0.3, 0.2])
        if gen:
            labels["tpu/generation"] = str(gen)
        chips = int(rng.choice([1, 2, 4] if gen == "v5p" else [1, 2, 4, 8]))
        labels["tpu/chips"] = str(chips)
        if rng.random() < 0.6:
            top = 64 if gen == "v5p" else 12
            labels["tpu/hbm"] = f"{int(rng.integers(1, top))}Gi"
        if rng.random() < 0.25:
            labels["tpu/clock"] = "1000" if gen == "v5p" else "900"
        pods.append((f"pod-{i:03d}", labels))
    return pods[:64], pods[64:]


def run_main_path(platform: str, pods_a, pods_b) -> dict:
    """Both runs of the main path on one kernel_platform; returns the
    bindings, counters and latencies."""
    from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.standalone import build_stack

    out = {}
    for run, pods, burst in (("a", pods_a, 1), ("b", pods_b, 16)):
        stack = build_stack(
            config=SchedulerConfig(kernel_platform=platform, batch_requests=burst)
        )
        agent = FakeTpuAgent(stack.cluster)
        for s in range(512):
            agent.add_slice(f"v5p-{s:03d}", generation="v5p", host_topology=(2, 2, 1))
        for h in range(2952):
            agent.add_host(f"v5e-{h:04d}", generation="v5e", chips=8)
        agent.publish_all()
        n_nodes = len(stack.informer.snapshot())
        for name, labels in pods:
            stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
        # Wall time inside the evaluation (uploads, kernel, result fetch),
        # against the whole run: the share of the cycle the device path
        # can move.
        kern = stack.batch._kern
        eval_s = [0.0]

        def timed(*args, _inner=kern.evaluate_burst):
            t = time.monotonic()
            try:
                return _inner(*args)
            finally:
                eval_s[0] += time.monotonic() - t

        kern.evaluate_burst = timed
        cuda_kernel.launches = 0
        t0 = time.monotonic()
        stack.scheduler.run_until_idle(max_wall_s=600)
        if platform != "cpu":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = cuda_kernel.launches
        bound = {
            name: stack.cluster.get_pod(f"default/{name}").node_name
            for name, _ in pods
        }
        lat = sorted(
            r.latency_s for r in stack.scheduler.stats.results if r.outcome == "bound"
        )
        capacity = {
            t.name: sum(c.healthy for c in t.chips)
            for t in stack.cluster.list_tpu_metrics()
        }
        over = [
            h for h, cap in capacity.items()
            if stack.accountant.chips_in_use(h) > cap
        ]
        b = stack.batch
        out[run] = dict(
            platform=platform, nodes=n_nodes, pods=len(pods), burst=burst,
            bound=sum(v is not None for v in bound.values()), bindings=bound,
            overcommitted=over, launches=launches,
            dispatch_count=b.dispatch_count, burst_dispatches=b.burst_dispatches,
            burst_served=b.burst_served, dispatch_errors=b.dispatch_errors,
            wall_s=wall, eval_s=eval_s[0],
            pods_per_s=len(lat) / wall if wall else 0.0,
            p50_ms=1e3 * lat[len(lat) // 2] if lat else None,
            p99_ms=1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else None,
        )
    return out


def phase_main_path() -> dict:
    pods_a, pods_b = fleet_and_pods(seed=0)
    gpu = run_main_path("auto", pods_a, pods_b)
    cpu = run_main_path("cpu", pods_a, pods_b)
    for run in ("a", "b"):
        g, c = gpu[run], cpu[run]
        summary = {k: v for k, v in g.items() if k not in ("bindings",)}
        print(f"main path ({run}) cuda:", json.dumps(summary))
        print(
            f"main path ({run}) cpu plain: bound {c['bound']}/{c['pods']}, "
            f"pods/s {c['pods_per_s']:.1f}, p50 {c['p50_ms']:.2f} ms, "
            f"p99 {c['p99_ms']:.2f} ms, evaluation {c['eval_s']:.3f} s of "
            f"{c['wall_s']:.3f} s"
        )
        if g["nodes"] != 5000:
            raise AssertionError(f"fleet has {g['nodes']} nodes, not 5000")
        if g["bound"] != g["pods"]:
            raise AssertionError(f"run {run}: {g['bound']}/{g['pods']} pods bound")
        if g["overcommitted"]:
            raise AssertionError(f"run {run}: over-committed {g['overcommitted']}")
        if g["dispatch_errors"]:
            raise AssertionError(f"run {run}: {g['dispatch_errors']} dispatch errors")
        if not 0 < g["launches"] == g["dispatch_count"]:
            raise AssertionError(
                f"run {run}: {g['launches']} kernel launches for "
                f"{g['dispatch_count']} dispatches"
            )
        if c["launches"]:
            raise AssertionError(f"run {run}: the CPU run launched the kernel")
        if g["bindings"] != c["bindings"]:
            diff = [p for p in g["bindings"] if g["bindings"][p] != c["bindings"][p]]
            raise AssertionError(
                f"run {run}: {len(diff)} pods bound differently on cuda vs "
                f"cpu, e.g. {diff[:3]}"
            )
    if not gpu["b"]["burst_dispatches"]:
        raise AssertionError("run b made no burst dispatch")
    return gpu


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    try:
        kind, smi = phase_device()
    except Exception as e:  # noqa: BLE001 — report the failing phase
        fail("device/build", e)
    try:
        rows, main_row = phase_kernel()
    except Exception as e:  # noqa: BLE001
        fail("kernel vs plain", e)
    try:
        gpu = phase_main_path()
    except Exception as e:  # noqa: BLE001
        fail("main path", e)
    kernels = {
        "kernels": [
            {
                "name": "fleet_eval",
                "route": "cuda",
                "source": "yoda_tpu_torch/csrc/fleet_eval.cu",
                "replaces": (
                    "yoda_tpu/ops/pallas_kernel.py:268 (_pallas_eval) + "
                    "yoda_tpu/ops/pallas_kernel.py:299 (_pallas_eval_burst)"
                ),
                "launches": gpu["a"]["launches"] + gpu["b"]["launches"],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main_row["ms"],
                "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": "bytes",
                "library_ms": None,
            }
        ]
    }
    print(json.dumps(kernels))
    print(smi)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": kind,
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
