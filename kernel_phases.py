"""Where the fleet-evaluation kernel's device time goes, phase by phase.

    python3 kernel_phases.py

Needs one CUDA card and nvcc. Builds a copy of
yoda_tpu_torch/csrc/fleet_eval.cu into build/kernels/ with one read of the
card's %globaltimer by thread 0 of every block at the kernel's start and
after each block or grid barrier (the shipped kernel has none), launches it
at the main path's shapes and at 65,536 nodes, checks its output against
the plain PyTorch version (exactly equal), and prints per phase the median
over 5 launches of how far that phase moved the latest block's end (from
the earliest block's start), in us, beside an nvidia-smi sample of SM clock
and power. The instrumentation is 14 global stores per block per launch.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import CHIPS, REQUEST_TABLE, random_fleet, smi_sample
from yoda_tpu_torch.config import SchedulerConfig
from yoda_tpu_torch.ops import cuda_kernel
from yoda_tpu_torch.ops.kernel import kernel_packed_burst

SHAPES = [(5000, 8192, 1), (5000, 8192, 16), (65536, 65536, 16)]
# Boundaries, in kernel order, after the trace point at the kernel's start.
PHASES = [
    "stage", "filter", "partials + sync 1", "reduce maxima", "divisors",
    "score", "partials + sync 2", "reduce raw lo/hi", "span", "finalize",
    "partials + sync 3", "reduce best", "best row",
]
SLOTS = 16


def traced_source() -> str:
    """fleet_eval.cu with a trace pointer in Args and a %globaltimer store
    after the kernel's start and after every block or grid barrier."""
    src = cuda_kernel.SOURCE.read_text()

    def sub(old: str, new: str) -> None:
        nonlocal src
        if old not in src:
            raise RuntimeError(f"fleet_eval.cu changed: {old!r} not found")
        src = src.replace(old, new, 1)

    sub("  Weights w;\n};\n", "  Weights w;\n  unsigned long long* trace;\n};\n")
    sub(
        "namespace cg = cooperative_groups;\n",
        "namespace cg = cooperative_groups;\n"
        "#define TRACE(i) if (a.trace && threadIdx.x == 0) { unsigned long long t_; "
        'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
        f"a.trace[blockIdx.x * {SLOTS} + (i)] = t_; }}\n"
        "static unsigned long long* g_trace = nullptr;\n"
        'extern "C" void fleet_eval_set_trace(unsigned long long* p) { g_trace = p; }\n',
    )
    sub("  void* params[] = {&a};", "  a.trace = g_trace;\n  void* params[] = {&a};")
    start = src.index("__global__ void __launch_bounds__")
    end = src.index("#undef FOR_EACH_TILE")
    body = src[start:end].replace(
        "  cg::grid_group grid = cg::this_grid();\n",
        "  cg::grid_group grid = cg::this_grid();\n  TRACE(0);\n",
    )
    count = [0]

    def mark(m: re.Match) -> str:
        count[0] += 1
        return f"{m.group(0)}  TRACE({count[0]});\n"

    body = re.sub(r"^  (__syncthreads\(\)|grid\.sync\(\));\n", mark, body, flags=re.M)
    last = body.rstrip().rfind("}")
    body = f"{body[:last]}  TRACE({count[0] + 1});\n{body[last:]}"
    if count[0] + 1 != len(PHASES):
        raise RuntimeError(f"{count[0] + 1} trace points for {len(PHASES)} phases")
    return src[:start] + body + src[end:]


def build() -> ctypes.CDLL:
    cuda_kernel.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = cuda_kernel.BUILD_DIR / "fleet_eval_traced.cu"
    lib = cuda_kernel.BUILD_DIR / "libfleet_eval_traced.so"
    source.write_text(traced_source())
    subprocess.run(
        [cuda_kernel._nvcc(), *cuda_kernel.NVCC_FLAGS, "-o", str(lib), str(source)],
        check=True, capture_output=True, text=True,
    )
    so = ctypes.CDLL(str(lib))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    so.fleet_eval_launch.argtypes = (
        [ptr] * 7 + [ctypes.c_longlong] + [i32] * 3 + [ptr, i32, ptr]
    )
    so.fleet_eval_launch.restype = i32
    so.fleet_eval_plan.argtypes = [i32, i32, i32, ptr]
    so.fleet_eval_set_trace.argtypes = [ptr]
    return so


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: kernel_phases.py needs one NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    so = build()
    dev = torch.device("cuda", 0)
    weights = SchedulerConfig().effective_weights()
    row = cuda_kernel._host_weights(weights)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n_real, n, k in SHAPES:
        chips, nodes, dyn = random_fleet(n_real, n, seed=n + k)
        host_ok = (np.random.default_rng(k).random((k, n)) > 0.2).astype(np.int32)
        reqs = REQUEST_TABLE[np.arange(k) % len(REQUEST_TABLE)]
        args = [
            torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (chips, nodes, dyn, host_ok, reqs)
        ]
        plan = (ctypes.c_int * 5)()
        if so.fleet_eval_plan(n, CHIPS, k, plan):
            raise RuntimeError("fleet_eval_plan failed")
        grid = plan[0]
        words = cuda_kernel.SCRATCH_WORDS * k * -(-n // cuda_kernel.TILE_NODES)
        out = torch.empty((k, 6, n), dtype=torch.int32, device=dev)
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        trace = torch.zeros(grid * SLOTS, dtype=torch.int64, device=dev)
        spans, totals = [], []
        for i in range(8):
            so.fleet_eval_set_trace(ctypes.c_void_p(trace.data_ptr()) if i >= 3 else None)
            rc = so.fleet_eval_launch(
                *(t.data_ptr() for t in args), out.data_ptr(), scratch.data_ptr(),
                words, n, CHIPS, k, ctypes.addressof(row), 0, stream,
            )
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            torch.cuda.synchronize()
            if i >= 3:
                t = trace.view(grid, SLOTS)[:, : len(PHASES) + 1].cpu().numpy()
                ends = t.max(axis=0) - t[:, 0].min()
                spans.append(np.diff(ends) / 1e3)
                totals.append(ends[-1] / 1e3)
        so.fleet_eval_set_trace(None)
        if not torch.equal(out, kernel_packed_burst(*args, weights)):
            raise AssertionError(f"traced kernel != plain at nodes={n} K={k}")
        med = np.median(np.array(spans), axis=0)
        print(json.dumps({
            "nodes": n, "k": k, "grid": grid, "threads": plan[1],
            "total_us": float(np.median(totals)),
            "phases_us": {p: round(float(v), 2) for p, v in zip(PHASES, med)},
            "smi": smi_sample(),
        }))


if __name__ == "__main__":
    main()
