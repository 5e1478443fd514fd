"""The hand-written CUDA kernels of the port and their wrappers.

- ``fleet_eval`` (``yoda_tpu_torch/csrc/fleet_eval.cu``), counterpart of
  ``yoda_tpu/ops/pallas_kernel.py``: one kernel family replaces both Pallas
  TPU kernels of the reference (``_pallas_eval`` for one request,
  ``_pallas_eval_burst`` for K) and their host epilogue; K = 1 serves the
  single request. A call of more than 128 requests launches it once per
  128-row chunk, back to back on the same stream into one output: every
  request row is evaluated independently, so the chunks are exact.
- ``joint_fit`` (``yoda_tpu_torch/csrc/joint_fit.cu``), counterpart of the
  reference's ``lax.scan`` ``joint_fit_scan`` inside ``kernel_joint_plan``
  (yoda_tpu/ops/kernel.py): the gang path's cross-gang fit gate, run over
  ``fleet_eval``'s output where it lies on the device. One launch of one
  thread-block cluster (up to 16 blocks, each holding a node slice's
  ledgers in shared memory, its rows fed ahead by bulk asynchronous
  copies, one exchange of arg-max keys across the cluster per row);
  :func:`joint_fit_plan` reports its shape.
- ``fleet_eval_shard`` (the shard entry of ``fleet_eval.cu``), counterpart
  of the reference's node-sharded evaluation
  (``yoda_tpu/parallel/sharded.py``: ``kernel_impl`` under row-sharded
  ``NamedSharding``): one of the evaluation's three phases over one
  shard's rows, reading the values the caller combined across shards
  after the earlier phases and writing the shard's own partials.
  ``parallel.sharded`` drives it, three launches per shard per 128
  requests.

Each source's header says what bounds it on an H100 and how the design
answers that. Each is compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC -Xptxas -v`` into
a shared library with a plain C interface under ``build/kernels/`` (named
by the source's hash, so an edit rebuilds; ptxas's register and
shared-memory report goes to the ``.log`` beside it) and loaded with
``ctypes``; :func:`build_all` starts every build at once. The wrappers
launch on PyTorch's current stream for CUDA tensors and run the plain
PyTorch versions (``ops.kernel.kernel_packed_burst``,
``ops.kernel.joint_fit_scan``) only for tensors on the CPU. For a CUDA
tensor they launch the kernel or raise (a failed build, a refused launch,
a CUDA error): there is no fallback.

Two threads may launch at once, each on its own stream (the serve loop on
the default stream, the speculative placement cache on its private one).
chip_smoke.py's run (h) measures on an H100 the two pairs the port makes:
``fleet_eval`` at K = 1 on the private stream beside the serve thread's
``fleet_eval`` at K = 16 and beside its ``joint_fit`` cluster. Each result
is held against the plain version and the overlap in time is reported; the
wrappers take no launch lock on the strength of that run. Only the launch
counters are guarded: the module-wide ones below and, where a wrapper is
given a ``counter`` (the :class:`~yoda_tpu_torch.ops.kernel.TorchFleetKernel`
that launched), that owner's, both bumped where the kernel launches.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from yoda_tpu_torch.config import SLICE_PROTECT_TIER, Weights
from yoda_tpu_torch.ops.kernel import (
    CHIP_KEYS,
    INT32_MAX,
    STATIC_NODE_KEYS,
    joint_fit_scan,
    kernel_packed_burst,
    kernel_shard_phase,
)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fleet_eval.cu"
JOINT_SOURCE = SOURCE.with_name("joint_fit.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Nodes per tile in fleet_eval.cu (kTileNodes): the launch's grid never has
# more blocks than tiles, which bounds the scratch it needs.
TILE_NODES = 64
SCRATCH_WORDS = 11  # int32 scratch words per (block, request)
MAX_REQUESTS = 128  # requests per launch (kMaxRequests); calls chunk by it

# CUDA kernel launches, one count per kernel: fleet_eval adds one per
# cooperative launch (one per 128-request chunk), joint_fit one per launch.
# Plain-version calls on CPU tensors do not count. Bumped under _count_lock:
# the serve loop and the speculation thread launch concurrently.
launches = 0
joint_fit_launches = 0
shard_launches = 0  # fleet_eval_shard: one per phase per 128-request chunk
_count_lock = threading.Lock()

_libs: "dict[Path, ctypes.CDLL]" = {}
# One build guard per source: the first caller of a source not loaded yet
# claims its build and runs nvcc OUTSIDE _lib_lock; later callers of the
# same source wait on the claim's future, and a launch of a source already
# loaded never waits on another source's cold build.
_builds: "dict[Path, concurrent.futures.Future]" = {}
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


def _library(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def _start_build(source: Path) -> "tuple[Path, subprocess.Popen | None, Path]":
    lib = _library(source)
    if lib.exists():
        return lib, None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )
    return lib, proc, tmp


def _finish_build(source: Path, lib: Path, proc, tmp: Path) -> Path:
    if proc is None:
        return lib
    _out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {source.name} (rc {proc.returncode}):\n{err}"
        )
    lib.with_suffix(".log").write_text(err)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a torn file
    return lib


def build(source: Path = SOURCE) -> Path:
    """Compile one kernel source (if this version is not built yet) and
    return the shared library's path."""
    return _finish_build(source, *_start_build(source))


def build_all() -> "dict[str, Path]":
    """Compile every kernel source at once (one nvcc per source, all
    started together); kernel name -> shared library path."""
    started = [(src, _start_build(src)) for src in (SOURCE, JOINT_SOURCE)]
    return {src.stem: _finish_build(src, *parts) for src, parts in started}


def _declare(lib: ctypes.CDLL, source: Path) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if source == SOURCE:
        lib.fleet_eval_launch.argtypes = (
            [ptr] * 7 + [ctypes.c_longlong] + [i32] * 3 + [ptr, i32, ptr]
        )
        lib.fleet_eval_launch.restype = i32
        lib.fleet_eval_plan.argtypes = [i32, i32, i32, ptr]
        lib.fleet_eval_plan.restype = i32
        lib.fleet_eval_shard_launch.argtypes = (
            [ptr] * 5 + [i32] + [ptr] * 3 + [i32] * 3 + [ptr, i32, ptr]
        )
        lib.fleet_eval_shard_launch.restype = i32
    else:
        lib.joint_fit_launch.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
        lib.joint_fit_launch.restype = i32
        lib.joint_fit_plan.argtypes = [i32, i32, ptr]
        lib.joint_fit_plan.restype = i32
    err = getattr(lib, f"{source.stem}_error_string")
    err.argtypes = [i32]
    err.restype = ctypes.c_char_p


def _load(source: Path = SOURCE) -> ctypes.CDLL:
    with _lib_lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        claim = _builds.get(source)
        owner = claim is None
        if owner:
            claim = _builds[source] = concurrent.futures.Future()
    if not owner:
        return claim.result()
    try:
        lib = ctypes.CDLL(str(build(source)))
        _declare(lib, source)
    except BaseException as e:
        with _lib_lock:
            _builds.pop(source, None)
        claim.set_exception(e)
        raise
    with _lib_lock:
        _libs[source] = lib
        _builds.pop(source, None)
    claim.set_result(lib)
    return lib


def _raise_for(lib: ctypes.CDLL, rc: int, what: str, name: str = "fleet_eval") -> None:
    if rc != 0:
        err = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} {what} failed: CUDA error {rc} ({err})")


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
    out: "torch.Tensor | None" = None,  # [K, 6, N] int32 to write into
    counter=None,  # an owner whose ``launches`` also counts this call's
) -> torch.Tensor:
    """The fleet evaluation of K requests -> [K, 6, N] int32 (rows
    feasible, reasons, raw, final, best, claimable), into ``out`` when
    given (e.g. a view of a larger buffer that one download fetches): the
    hand kernel for CUDA tensors — one launch per 128 requests, each added
    to ``launches`` and to ``counter.launches`` — and the plain version for
    CPU tensors."""
    global launches
    if chips.device.type == "cpu":
        packed = kernel_packed_burst(chips, nodes, dyn, host_ok_k, reqs_k, weights)
        if out is None:
            return packed
        out.copy_(packed)
        return out
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
    # The partials of the three grid-wide reductions, shared by the chunks
    # (every scratch word a launch reads it first writes in that launch,
    # and the chunks run one after the other on one stream); in the same
    # allocation as the output when the caller gives none.
    chunk = min(k, MAX_REQUESTS)
    scratch_words = SCRATCH_WORDS * chunk * -(-n // TILE_NODES)
    if out is None:
        buf = torch.empty((k * 6 * n + scratch_words,), dtype=torch.int32, device=device)
        out = buf[: k * 6 * n].view(k, 6, n)
        scratch_ptr = buf.data_ptr() + 4 * k * 6 * n
    else:
        _check("out", out, (k, 6, n), device)
        scratch = torch.empty((scratch_words,), dtype=torch.int32, device=device)
        scratch_ptr = scratch.data_ptr()
    lib = _load()
    stream = torch.cuda.current_stream(device).cuda_stream
    weight_row = ctypes.addressof(_host_weights(weights))
    for lo in range(0, k, MAX_REQUESTS):
        kc = min(MAX_REQUESTS, k - lo)
        rc = lib.fleet_eval_launch(
            chips.data_ptr(), nodes.data_ptr(), dyn.data_ptr(),
            host_ok_k.data_ptr() + 4 * lo * n, reqs_k.data_ptr() + 4 * lo * 5,
            out.data_ptr() + 4 * lo * 6 * n, scratch_ptr, scratch_words, n, c, kc,
            weight_row, device.index, stream,
        )
        _raise_for(lib, rc, "launch")
        with _count_lock:
            launches += 1
            if counter is not None:
                counter.launches += 1
    return out


# Per phase of the shard entry: int32 words per request of the globals it
# reads and of the partials it writes, and the partials' identities (what
# the wrapper fills them with before the launch).
SHARD_GLOBAL_WORDS = {1: 0, 2: 6, 3: 2}
SHARD_PARTIAL_WORDS = {1: 6, 2: 3, 3: 2}
SHARD_PARTIAL_IDENTITY = {1: (0,) * 6, 2: (INT32_MAX, -INT32_MAX, 0), 3: (0, 0)}


_identities: "dict[tuple[torch.device, int], torch.Tensor]" = {}


def _shard_identity(device: torch.device, phase: int) -> torch.Tensor:
    """The phase's partial identities as a [pw] int32 tensor on ``device``
    (made once per device and phase)."""
    key = (device, phase)
    ident = _identities.get(key)
    if ident is None:
        ident = _identities[key] = torch.tensor(
            SHARD_PARTIAL_IDENTITY[phase], dtype=torch.int32, device=device
        )
    return ident


def fleet_eval_shard(
    chips: torch.Tensor,      # [9, C, n] int32: the shard's rows
    nodes: torch.Tensor,      # [4, n] int32
    dyn: torch.Tensor,        # [4, n] int32
    host_ok_k: torch.Tensor,  # [K, n] int32
    reqs_k: torch.Tensor,     # [K, 5] int32
    phase: int,               # 1, 2 or 3
    globals_: "torch.Tensor | None",  # [K, SHARD_GLOBAL_WORDS[phase]] int32
    out: torch.Tensor,        # [K, 6, n] int32, the shard's output rows
    partials: torch.Tensor,   # [K, SHARD_PARTIAL_WORDS[phase]] int32
    weights: Weights,
    counter=None,  # an owner whose ``shard_launches`` also counts this call's
) -> None:
    """One phase of the node-sharded fleet evaluation over one shard: the
    shard entry of ``fleet_eval.cu`` for CUDA tensors — ``partials`` filled
    with the phase's identities, then one launch per 128 requests, each
    added to ``shard_launches`` and to ``counter.shard_launches`` — and
    its plain version (ops.kernel.kernel_shard_phase) for CPU tensors.
    Phase 1 writes ``out``'s feasible, reason and claimable rows and the
    shard's six maxima; phase 2, given the combined maxima, raw and the
    shard's (lowest, highest, any); phase 3, given the combined (lowest,
    span), final and the shard's best key as (local row, score ^
    INT32_MIN). The best row itself is the caller's combine."""
    global shard_launches
    if phase not in SHARD_PARTIAL_WORDS:
        raise ValueError(f"phase must be 1, 2 or 3, got {phase!r}")
    if chips.device.type == "cpu":
        kernel_shard_phase(
            chips, nodes, dyn, host_ok_k, reqs_k, phase, globals_, out, partials,
            weights,
        )
        return
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
    _check("out", out, (k, 6, n), device)
    pw, gw = SHARD_PARTIAL_WORDS[phase], SHARD_GLOBAL_WORDS[phase]
    _check("partials", partials, (k, pw), device)
    if gw:
        if globals_ is None:
            raise ValueError(f"phase {phase} reads the combined values of phase {phase - 1}")
        _check("globals", globals_, (k, gw), device)
    partials.copy_(_shard_identity(device, phase).expand(k, pw))
    lib = _load()
    stream = torch.cuda.current_stream(device).cuda_stream
    weight_row = ctypes.addressof(_host_weights(weights))
    gptr = globals_.data_ptr() if gw else 0
    for lo in range(0, k, MAX_REQUESTS):
        kc = min(MAX_REQUESTS, k - lo)
        rc = lib.fleet_eval_shard_launch(
            chips.data_ptr(), nodes.data_ptr(), dyn.data_ptr(),
            host_ok_k.data_ptr() + 4 * lo * n, reqs_k.data_ptr() + 4 * lo * 5, phase,
            (gptr + 4 * lo * gw) if gw else None, out.data_ptr() + 4 * lo * 6 * n,
            partials.data_ptr() + 4 * lo * pw, n, c, kc, weight_row, device.index,
            stream,
        )
        _raise_for(lib, rc, "shard launch")
        with _count_lock:
            shard_launches += 1
            if counter is not None:
                counter.shard_launches += 1


JOINT_PLAN_FIELDS = (
    "blocks", "threads", "stages", "smem_bytes", "shared_ledgers", "slice",
    "chunk", "chunks",
)
_joint_plans: "dict[tuple[int, int], tuple[int, ...]]" = {}


def joint_fit_plan(n: int, device: torch.device) -> dict:
    """The launch joint_fit makes for ``n`` nodes on ``device``: blocks of
    its one cluster (16 where the card admits such a cluster, else 8; fewer
    for small fleets), threads per block (consumer warps and one producer
    warp), ring stages, dynamic shared-memory bytes per block, whether the
    tent/sim ledgers live in shared memory (else tent takes a global
    scratch and sim the output), nodes per block's slice, words of a row
    slice per ring stage and stages per row. Raises when the card admits
    no cluster of the plan."""
    key = (n, device.index)
    plan = _joint_plans.get(key)
    if plan is None:
        lib = _load(JOINT_SOURCE)
        row = (ctypes.c_int * len(JOINT_PLAN_FIELDS))()
        _raise_for(lib, lib.joint_fit_plan(n, device.index, row), "plan", "joint_fit")
        plan = _joint_plans[key] = tuple(row)
    return dict(zip(JOINT_PLAN_FIELDS, plan))


def joint_fit(
    packed: torch.Tensor,    # [K, 6, N] int32 fleet_eval output
    chips_k: torch.Tensor,   # [K] int32 chip demand per row
    starts_k: torch.Tensor,  # [K] int32 group-start flags
    valid_k: torch.Tensor,   # [K] int32 real-row flags
    out: "torch.Tensor | None" = None,  # [2K + N] int32 to write into
    counter=None,  # an owner whose ``joint_fit_launches`` also counts it
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """The joint fit scan over the rows of one fleet evaluation ->
    (picks [K], group_ok [K], sim [N]) int32 views of ``out`` (a fresh
    [2K + N] buffer when not given): the hand kernel for CUDA tensors,
    launched on the current stream after whatever wrote ``packed`` and
    counted in ``joint_fit_launches`` and ``counter.joint_fit_launches``,
    and the plain version (ops.kernel.joint_fit_scan) for CPU tensors."""
    global joint_fit_launches
    k, _, n = packed.shape
    device = packed.device
    if out is None:
        out = torch.empty((2 * k + n,), dtype=torch.int32, device=device)
    picks, gok, sim = out[:k], out[k : 2 * k], out[2 * k :]
    if device.type == "cpu":
        got = joint_fit_scan(
            packed[:, 0], packed[:, 3], packed[:, 5], chips_k, starts_k, valid_k
        )
        for dst, src in zip((picks, gok, sim), got):
            dst.copy_(src)
        return picks, gok, sim
    if device.type != "cuda":
        raise ValueError(f"no joint fit for device {device}")
    _check("packed", packed, (k, 6, n), device)
    for name, t in (("chips_k", chips_k), ("starts_k", starts_k), ("valid_k", valid_k)):
        _check(name, t, (k,), device)
    _check("out", out, (2 * k + n,), device)
    plan = joint_fit_plan(n, device)
    tent = (
        None if plan["shared_ledgers"]
        else torch.empty((n,), dtype=torch.int32, device=device)
    )
    lib = _load(JOINT_SOURCE)
    rc = lib.joint_fit_launch(
        packed.data_ptr(), chips_k.data_ptr(), starts_k.data_ptr(),
        valid_k.data_ptr(), picks.data_ptr(), gok.data_ptr(), sim.data_ptr(),
        None if tent is None else tent.data_ptr(), n, k, device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_for(lib, rc, "launch", "joint_fit")
    with _count_lock:
        joint_fit_launches += 1
        if counter is not None:
            counter.joint_fit_launches += 1
    return picks, gok, sim
