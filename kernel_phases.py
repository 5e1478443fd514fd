"""Where the hand kernels' device time goes, phase by phase.

    python3 kernel_phases.py

Needs one CUDA card and nvcc. Two parts:

- fleet_eval: builds a copy of yoda_tpu_torch/csrc/fleet_eval.cu into
  build/kernels/ with one read of the card's %globaltimer by thread 0 of
  every block at the kernel's start and after each block or grid barrier
  (the shipped kernel has none), launches it at the main path's shapes, at
  65,536 nodes and at 8,192 nodes x 64 chips (the wide instantiation,
  K = 16), checks its output against the plain PyTorch version
  (exactly equal), and prints per phase the median over 5 launches of how
  far that phase moved the latest block's end (from the earliest block's
  start), in us, beside an nvidia-smi sample of SM clock and power. The
  instrumentation is 14 global stores per block per launch.
- joint_fit: builds a copy of yoda_tpu_torch/csrc/joint_fit.cu in which
  thread 0 of every block of the cluster reads its SM's clock64 at six
  marks of each valid row (row start, row's stages arrived and scanned,
  warp reduced, pairs sent, exchange arrived, merged and claimed) and sums
  the cycles between marks in registers, written once at the end (7 global
  stores per block). It runs through the wrapper at the joint shapes of
  chip_smoke.py, checks the result against the plain scan (exactly equal),
  and prints per phase the cycles per row (median over blocks, and the
  largest block's) and us per row at the SM clock nvidia-smi reads.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import (
    CHIPS, REQUEST_TABLE, identical_rows_case, joint_case, random_fleet, smi_sample,
)
from yoda_tpu_torch.config import SchedulerConfig
from yoda_tpu_torch.ops import cuda_kernel
from yoda_tpu_torch.ops.kernel import joint_fit_scan, kernel_packed_burst

# (real nodes, padded nodes, K, chips): the main path's shapes, 65,536
# nodes, and the wide instantiation at 64 chips a node.
SHAPES = [
    (5000, 8192, 1, CHIPS), (5000, 8192, 16, CHIPS), (65536, 65536, 16, CHIPS),
    (5000, 8192, 16, 64),
]
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


JOINT_SHAPES = [(64, 8192), (256, 8192), (64, 65536), (16, 262144)]
JOINT_PHASES = [
    "start + side inputs", "stage wait + scan", "warp reduce", "send", "exchange wait",
    "merge + claim",
]


def traced_joint_source() -> str:
    """joint_fit.cu with a trace pointer in Args and per-row clock64 sums
    kept by thread 0 of every block."""
    src = cuda_kernel.JOINT_SOURCE.read_text()

    def sub(old: str, new: str, count: int = 1) -> None:
        nonlocal src
        if src.count(old) != count:
            raise RuntimeError(f"joint_fit.cu changed: {old!r} found {src.count(old)} times")
        src = src.replace(old, new)

    def after(anchor: str, mark: int) -> None:
        sub(anchor, f"{anchor}      TRACE({mark});\n")

    sub("4 nodes a group\n};", "4 nodes a group\n  long long* trace;\n};")
    sub("namespace {\n", "namespace {\n"
        "#define TRACE(p) if (a.trace && threadIdx.x == 0) { const long long t_ = clock64(); "
        "acc_[p] += t_ - last_; last_ = t_; }\n"
        "long long* g_trace = nullptr;\n")
    sub("    bool gok = true;  // uniform",
        "    long long acc_[8] = {};\n    long long last_ = clock64();\n"
        "    bool gok = true;  // uniform")
    after("        continue;\n      }\n", 0)
    after("        release_stage(st);\n      }\n", 1)
    after("      int any = __any_sync(kFull, cur.ok);\n", 2)
    sub("      bar_wait(bar, (v >> 1) & 1);\n",
        "      TRACE(3);\n      bar_wait(bar, (v >> 1) & 1);\n      TRACE(4);\n")
    after("      ++v;\n", 5)
    sub("    for_own([&](int l) {\n      const int32_t final_word",
        "    if (a.trace && threadIdx.x == 0) {\n"
        f"      for (int p_ = 0; p_ < {len(JOINT_PHASES)}; ++p_) "
        "a.trace[blockIdx.x * 8 + p_] = acc_[p_];\n"
        "      a.trace[blockIdx.x * 8 + 7] = v;\n    }\n"
        "    for_own([&](int l) {\n      const int32_t final_word")
    sub("    const Args a{", "    Args a{")
    sub("    cudaLaunchConfig_t cfg = {};\n    cudaLaunchAttribute attr[1];\n"
        "    attr[0].id = cudaLaunchAttributeClusterDimension;\n    attr[0].val.clusterDim.x = p.blocks;\n"
        "    attr[0].val.clusterDim.y = 1;\n    attr[0].val.clusterDim.z = 1;\n    cfg.gridDim",
        "    a.trace = g_trace;\n"
        "    cudaLaunchConfig_t cfg = {};\n    cudaLaunchAttribute attr[1];\n"
        "    attr[0].id = cudaLaunchAttributeClusterDimension;\n    attr[0].val.clusterDim.x = p.blocks;\n"
        "    attr[0].val.clusterDim.y = 1;\n    attr[0].val.clusterDim.z = 1;\n    cfg.gridDim")
    return src + '\nextern "C" void joint_fit_set_trace(long long* p) { g_trace = p; }\n'


def joint_main() -> None:
    """Per-phase cycles of joint_fit's row loop at the joint shapes."""
    cuda_kernel.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = cuda_kernel.BUILD_DIR / "joint_fit_traced.cu"
    lib = cuda_kernel.BUILD_DIR / "libjoint_fit_traced.so"
    source.write_text(traced_joint_source())
    subprocess.run(
        [cuda_kernel._nvcc(), *cuda_kernel.NVCC_FLAGS, "-o", str(lib), str(source)],
        check=True, capture_output=True, text=True,
    )
    so = ctypes.CDLL(str(lib))
    cuda_kernel._declare(so, cuda_kernel.JOINT_SOURCE)
    so.joint_fit_set_trace.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    shipped = cuda_kernel._libs.get(cuda_kernel.JOINT_SOURCE)
    cuda_kernel._libs[cuda_kernel.JOINT_SOURCE] = so
    cuda_kernel._joint_plans.clear()
    cases = [(f"{k}x{n}", joint_case(k, n, seed=k * 7 + n)) for k, n in JOINT_SHAPES]
    cases.append(("identical rows 128x8192", identical_rows_case()))
    try:
        for name, case in cases:
            packed, chips, starts, valid = (torch.from_numpy(x).to(dev) for x in case)
            n = packed.shape[2]
            plan = cuda_kernel.joint_fit_plan(n, dev)
            trace = torch.zeros(plan["blocks"] * 8, dtype=torch.int64, device=dev)
            got = cuda_kernel.joint_fit(packed, chips, starts, valid)  # warm-up
            so.joint_fit_set_trace(ctypes.c_void_p(trace.data_ptr()))
            got = cuda_kernel.joint_fit(packed, chips, starts, valid)
            torch.cuda.synchronize()
            so.joint_fit_set_trace(None)
            want = joint_fit_scan(packed[:, 0], packed[:, 3], packed[:, 5], chips, starts, valid)
            if not all(torch.equal(g, w.to(torch.int32)) for g, w in zip(got, want)):
                raise AssertionError(f"traced joint_fit != plain on {name}")
            t = trace.view(plan["blocks"], 8).cpu().numpy()
            rows = int(t[0, 7])
            per_row = t[:, : len(JOINT_PHASES)] / max(rows, 1)
            smi = smi_sample()
            mhz = float(smi.split()[0])
            med = np.median(per_row, axis=0)
            print("joint_fit", json.dumps({
                "case": name, "rows": rows, "blocks": plan["blocks"],
                "threads": plan["threads"], "stages": plan["stages"],
                "shared_ledgers": plan["shared_ledgers"],
                "cycles_per_row": {p: round(float(v), 1) for p, v in zip(JOINT_PHASES, med)},
                "max_block_cycles_per_row": {
                    p: round(float(v), 1) for p, v in zip(JOINT_PHASES, per_row.max(axis=0))
                },
                "us_per_row": round(float(med.sum()) / mhz, 4),
                "smi": smi,
            }))
    finally:
        if shipped is None:
            cuda_kernel._libs.pop(cuda_kernel.JOINT_SOURCE, None)
        else:
            cuda_kernel._libs[cuda_kernel.JOINT_SOURCE] = shipped
        cuda_kernel._joint_plans.clear()


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: kernel_phases.py needs one NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    so = build()
    dev = torch.device("cuda", 0)
    weights = SchedulerConfig().effective_weights()
    row = cuda_kernel._host_weights(weights)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n_real, n, k, c in SHAPES:
        chips, nodes, dyn = random_fleet(n_real, n, seed=n + k, chips=c)
        host_ok = (np.random.default_rng(k).random((k, n)) > 0.2).astype(np.int32)
        reqs = REQUEST_TABLE[np.arange(k) % len(REQUEST_TABLE)]
        args = [
            torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (chips, nodes, dyn, host_ok, reqs)
        ]
        plan = (ctypes.c_int * 5)()
        if so.fleet_eval_plan(n, c, k, plan):
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
                words, n, c, k, ctypes.addressof(row), 0, stream,
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
            raise AssertionError(f"traced kernel != plain at nodes={n} C={c} K={k}")
        med = np.median(np.array(spans), axis=0)
        print(json.dumps({
            "nodes": n, "chips": c, "k": k, "grid": grid, "threads": plan[1],
            "total_us": float(np.median(totals)),
            "phases_us": {p: round(float(v), 2) for p, v in zip(PHASES, med)},
            "smi": smi_sample(),
        }))
    joint_main()


if __name__ == "__main__":
    main()
