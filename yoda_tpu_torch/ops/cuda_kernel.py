"""The hand-written CUDA fleet-evaluation kernel and its wrapper.

Counterpart of ``yoda_tpu/ops/pallas_kernel.py``: one kernel family,
``yoda_tpu_torch/csrc/fleet_eval.cu``, replaces both Pallas TPU kernels of
the reference (``_pallas_eval`` for one request, ``_pallas_eval_burst`` for
K) and their host epilogue; K = 1 serves the single request. The source's
header says what bounds it on an H100 and how the design answers that.

The source is compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC -Xptxas -v`` into
a shared library with a plain C interface under ``build/kernels/`` (named
by the source's hash, so an edit rebuilds; ptxas's register and
shared-memory report goes to the ``.log`` beside it) and loaded with
``ctypes``. The wrapper :func:`fleet_eval` makes one cooperative launch of
it on PyTorch's current stream for CUDA tensors and runs the plain PyTorch
version (``ops.kernel.kernel_packed_burst``) only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises (a failed build, a
refused cooperative launch, a CUDA error): there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from yoda_tpu_torch.config import SLICE_PROTECT_TIER, Weights
from yoda_tpu_torch.ops.kernel import CHIP_KEYS, STATIC_NODE_KEYS, kernel_packed_burst

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fleet_eval.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Nodes per tile in fleet_eval.cu (kTileNodes): the launch's grid never has
# more blocks than tiles, which bounds the scratch it needs.
TILE_NODES = 64
SCRATCH_WORDS = 11  # int32 scratch words per (block, request)
MAX_CHIPS = 32      # chips per node (kMaxChips: one bit each in a mask)
MAX_REQUESTS = 128  # requests per call (kMaxRequests)

# CUDA kernel launches: fleet_eval_launch enqueues exactly one cooperative
# launch per wrapper call. Plain-version calls on CPU tensors do not count.
launches = 0

_lib: "ctypes.CDLL | None" = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the fleet evaluation "
            "kernel is built from source at first use on the CUDA device"
        )
    return str(path)


def build() -> Path:
    """Compile the kernel source (if this version is not built yet) and
    return the shared library's path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libfleet_eval-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {SOURCE.name} (rc {proc.returncode}):\n"
            f"{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a torn file
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.fleet_eval_launch.argtypes = (
                [ptr] * 7 + [ctypes.c_longlong] + [i32] * 3 + [ptr, i32, ptr]
            )
            lib.fleet_eval_launch.restype = i32
            lib.fleet_eval_plan.argtypes = [i32, i32, i32, ptr]
            lib.fleet_eval_plan.restype = i32
            lib.fleet_eval_error_string.argtypes = [i32]
            lib.fleet_eval_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _raise_for(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"fleet_eval {what} failed: CUDA error {rc} "
            f"({lib.fleet_eval_error_string(rc).decode()})"
        )


def launch_plan(n: int, c: int, k: int, device: torch.device) -> dict:
    """The launch fleet_eval makes for n nodes x c chips x k requests on
    ``device``: grid blocks, threads per block, tiles each block walks,
    tiles it stages in shared memory, dynamic shared-memory bytes."""
    lib = _load()
    plan = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        _raise_for(lib, lib.fleet_eval_plan(n, c, k, plan), "plan")
    return dict(zip(("grid", "threads", "walk", "resident", "smem_bytes"), plan))


_weights: dict[Weights, ctypes.Array] = {}


def _host_weights(w: Weights) -> ctypes.Array:
    """The kernel's weight row for ``w`` (built once per Weights value)."""
    row = _weights.get(w)
    if row is None:
        row = _weights[w] = (ctypes.c_int32 * 9)(
            w.hbm_bandwidth, w.clock, w.tflops, w.power, w.hbm_free,
            w.hbm_total, w.actual, w.allocate, SLICE_PROTECT_TIER * w.slice_protect,
        )
    return row


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if (
        t.device == device and t.dtype == torch.int32 and t.shape == shape
        and t.is_contiguous()
    ):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the fleet on {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fleet_eval(
    chips: torch.Tensor,      # [9, C, N] int32, CHIP_KEYS rows
    nodes: torch.Tensor,      # [4, N] int32, STATIC_NODE_KEYS rows
    dyn: torch.Tensor,        # [4, N] int32 (fresh, reserved, claimed, -)
    host_ok_k: torch.Tensor,  # [K, N] int32 per-request admission
    reqs_k: torch.Tensor,     # [K, 5] int32 request rows
    weights: Weights,
) -> torch.Tensor:
    """The fleet evaluation of K requests -> [K, 6, N] int32 (rows
    feasible, reasons, raw, final, best, claimable): the hand kernel for
    CUDA tensors, the plain version for CPU tensors."""
    global launches
    if chips.device.type == "cpu":
        return kernel_packed_burst(chips, nodes, dyn, host_ok_k, reqs_k, weights)
    if chips.device.type != "cuda":
        raise ValueError(f"no fleet evaluation for device {chips.device}")
    _, c, n = chips.shape
    k = reqs_k.shape[0]
    device = chips.device
    _check("chips", chips, (len(CHIP_KEYS), c, n), device)
    _check("nodes", nodes, (len(STATIC_NODE_KEYS), n), device)
    _check("dyn", dyn, (4, n), device)
    _check("host_ok_k", host_ok_k, (k, n), device)
    _check("reqs_k", reqs_k, (k, 5), device)
    if c > MAX_CHIPS or k > MAX_REQUESTS:
        raise ValueError(
            f"the CUDA fleet evaluation takes at most {MAX_CHIPS} chips per "
            f"node and {MAX_REQUESTS} requests, got {c} and {k}"
        )
    # The output, then the partials of the three grid-wide reductions (every
    # scratch word the kernel reads it first writes in the same launch).
    scratch_words = SCRATCH_WORDS * k * -(-n // TILE_NODES)
    buf = torch.empty((k * 6 * n + scratch_words,), dtype=torch.int32, device=device)
    lib = _load()
    rc = lib.fleet_eval_launch(
        chips.data_ptr(), nodes.data_ptr(), dyn.data_ptr(),
        host_ok_k.data_ptr(), reqs_k.data_ptr(), buf.data_ptr(),
        buf.data_ptr() + 4 * k * 6 * n, scratch_words, n, c, k,
        ctypes.addressof(_host_weights(weights)), device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_for(lib, rc, "launch")
    launches += 1
    return buf[: k * 6 * n].view(k, 6, n)
