"""Native node agent: publishes this host's TpuNodeMetrics CR from the
C++ metrics reader (native/tpuinfo.cc, built as libyoda_tpuinfo.so).

The real-cluster counterpart of the fake publisher — the role the external
SCV sniffer DaemonSet played for the reference (reference readme.md:9-15;
SURVEY.md §1-L5). The ctypes binding keeps the agent free of any Python TPU
runtime dependency: one dlopen, one struct, one call per refresh interval.

Free-HBM attribution: the library over-reports free HBM (= total) when no
runtime counter exists; the agent then subtracts the label-declared HBM of
pods bound to this node (the same greedy whole-chip model as the fake
publisher), so published metrics converge to the accountant's view between
scheduler restarts.

Counterpart of ``yoda_tpu/agent/native.py``, whole: the same ctypes
structs over the same C ABI (``yoda_tpuinfo_collect``,
``yoda_tpuinfo_source`` and the ``yoda_tpuinfo_max_chips`` guard that
refuses a library built with another chip limit), the runtime and libtpu
overlays, and bound-pod HBM attribution. The library comes from the
repo's own source and nothing else: :func:`load_library` takes an
explicit path, else ``$YODA_TPUINFO_SO``, else builds
``native/tpuinfo.cc`` at first use with ``g++`` and ``native/Makefile``'s
flags into ``build/native/libyoda_tpuinfo.so`` (rebuilt when the source
is newer; never written into ``native/``), else an installed
``/usr/local/lib/yoda_tpu/libyoda_tpuinfo.so``. With no library and no
compiler it returns None, as the reference does.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from yoda_tpu_torch.api.types import HEALTHY, TpuChip, TpuNodeMetrics

MAX_CHIPS = 16


class _Chip(ctypes.Structure):
    _fields_ = [
        ("index", ctypes.c_int32),
        ("healthy", ctypes.c_int32),
        ("hbm_free", ctypes.c_int64),
        ("hbm_total", ctypes.c_int64),
        ("clock_mhz", ctypes.c_int32),
        ("hbm_bandwidth_gbps", ctypes.c_int32),
        ("tflops_bf16", ctypes.c_int32),
        ("power_w", ctypes.c_int32),
    ]


class _Host(ctypes.Structure):
    _fields_ = [
        ("generation", ctypes.c_char * 8),
        ("accel_type", ctypes.c_char * 32),
        ("slice_id", ctypes.c_char * 64),
        ("coords", ctypes.c_int32 * 3),
        ("chip_count", ctypes.c_int32),
        ("chips", _Chip * MAX_CHIPS),
    ]


REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "tpuinfo.cc"
BUILD_DIR = REPO / "build" / "native"
LIB_NAME = "libyoda_tpuinfo.so"
# native/Makefile's CXXFLAGS and its link step.
CXXFLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")
INSTALLED = Path("/usr/local/lib/yoda_tpu") / LIB_NAME


def build_library() -> "Path | None":
    """``build/native/libyoda_tpuinfo.so`` compiled from the repo's
    ``native/tpuinfo.cc`` with ``g++`` (``$CXX`` when set) and the
    Makefile's flags; rebuilt when the source is newer than the library.
    None when the source or a compiler is absent, or the build fails."""
    if not SOURCE.exists():
        return None
    lib = BUILD_DIR / LIB_NAME
    if lib.exists() and lib.stat().st_mtime >= SOURCE.stat().st_mtime:
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # One temporary file per build: concurrent first uses (threads or
    # processes) each compile and the last rename wins, never a torn file.
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


def load_library(path: str | os.PathLike | None = None):
    """dlopen libyoda_tpuinfo.so; None if it is not built/installed
    (callers fall back to the fake publisher). ``path``, else
    ``$YODA_TPUINFO_SO``, is the only candidate when given; otherwise the
    repo's own build (:func:`build_library`), then the installed copy."""
    explicit = path or os.environ.get("YODA_TPUINFO_SO")
    if explicit:
        candidates = [Path(explicit)]
    else:
        built = build_library()
        candidates = ([built] if built is not None else []) + [INSTALLED]
    for c in candidates:
        if c.exists():
            lib = ctypes.CDLL(str(c))
            lib.yoda_tpuinfo_collect.argtypes = [ctypes.POINTER(_Host)]
            lib.yoda_tpuinfo_collect.restype = ctypes.c_int
            lib.yoda_tpuinfo_source.restype = ctypes.c_char_p
            # ABI guard: the library fills a caller-allocated _Host; a chip
            # array bound drifting between the .so and this binding would be
            # silent heap corruption in the node agent. A build so old it
            # lacks the probe symbol is itself a mismatch.
            probe = getattr(lib, "yoda_tpuinfo_max_chips", None)
            if probe is None:
                raise RuntimeError(
                    f"libyoda_tpuinfo ABI mismatch: {c} predates the "
                    "yoda_tpuinfo_max_chips probe; rebuild it from native/"
                )
            probe.restype = ctypes.c_int
            lib_max = probe()
            if lib_max != MAX_CHIPS:
                raise RuntimeError(
                    f"libyoda_tpuinfo ABI mismatch: library max_chips="
                    f"{lib_max}, binding expects {MAX_CHIPS} ({c})"
                )
            return lib
    return None


def collect_host_metrics(
    node_name: str,
    *,
    lib=None,
    now_fn=time.time,
) -> TpuNodeMetrics | None:
    """One native collection -> a TpuNodeMetrics CR (None: no TPU found or
    library unavailable)."""
    lib = lib or load_library()
    if lib is None:
        return None
    host = _Host()
    if lib.yoda_tpuinfo_collect(ctypes.byref(host)) <= 0:
        return None
    return TpuNodeMetrics(
        name=node_name,
        generation=host.generation.decode(),
        accel_type=host.accel_type.decode(),
        slice_id=host.slice_id.decode(),
        topology_coords=tuple(host.coords),
        last_updated_unix=now_fn(),
        chips=[
            TpuChip(
                index=c.index,
                health=HEALTHY if c.healthy else "Unhealthy",
                hbm_free=c.hbm_free,
                hbm_total=c.hbm_total,
                clock_mhz=c.clock_mhz,
                hbm_bandwidth_gbps=c.hbm_bandwidth_gbps,
                tflops_bf16=c.tflops_bf16,
                power_w=c.power_w,
            )
            for c in host.chips[: host.chip_count]
        ],
    )


def collection_source(lib=None) -> str:
    """Which collection path fired on the last collect:
    "env" | "device-files" | "none"."""
    lib = lib or load_library()
    return lib.yoda_tpuinfo_source().decode() if lib else "unavailable"


class NativeTpuAgent:
    """Per-node publisher loop body: collect via the native library, overlay
    live-runtime hardware counters (agent/runtime.py) when enabled, attribute
    bound pods' HBM, publish the CR. ``run_once`` is what the DaemonSet's
    interval loop calls (deploy/yoda-tpu-agent.yaml --interval-s)."""

    def __init__(
        self,
        cluster,
        node_name: str,
        *,
        lib=None,
        now_fn=time.time,
        runtime_devices_fn=None,
        libtpu_query_fn=None,
    ):
        self.cluster = cluster  # needs put_tpu_metrics / list_pods
        self.node_name = node_name
        self.lib = lib or load_library()
        self.now_fn = now_fn
        # None = runtime probing disabled (--runtime-probe wires
        # agent.runtime.probe_devices, tests inject fakes).
        self.runtime_devices_fn = runtime_devices_fn
        # None = libtpu metrics service disabled (--libtpu-metrics wires
        # agent.tpu_metrics.query_hbm against --libtpu-metrics-addr).
        self.libtpu_query_fn = libtpu_query_fn

    def run_once(self) -> TpuNodeMetrics | None:
        from yoda_tpu_torch.agent import runtime as rt

        tpu = collect_host_metrics(self.node_name, lib=self.lib, now_fn=self.now_fn)
        if tpu is not None:
            tpu.source = collection_source(self.lib)
        reading = (
            rt.read_runtime(self.runtime_devices_fn)
            if self.runtime_devices_fn is not None
            else None
        )
        if reading is not None:
            if tpu is None:
                # No native inventory (no device files / env spec): the
                # live runtime alone is authoritative.
                tpu = rt.metrics_from_runtime(
                    self.node_name, reading, now_fn=self.now_fn
                )
            else:
                rt.overlay_runtime(tpu, reading)
        if tpu is None:
            return None
        # Chips with REAL memory counters already reflect actual usage —
        # attributing label-declared HBM on top would double-count it. The
        # check is per chip: a runtime that covers only some chips (fewer
        # devices than native inventory, or memory_stats absent on some)
        # must not exempt the uncovered ones from attribution.
        real_idx = (
            {rc.index for rc in reading.chips if rc.hbm_total is not None}
            if reading is not None
            else set()
        )
        if self.libtpu_query_fn is not None:
            from yoda_tpu_torch.agent.tpu_metrics import LibtpuMetricsUnavailable

            try:
                hbm = self.libtpu_query_fn()
            except LibtpuMetricsUnavailable:
                hbm = None  # fall back to PJRT/spec values already in place
            if hbm is not None:
                real_idx |= rt.overlay_libtpu(tpu, hbm)
        attributed = any(c.index not in real_idx for c in tpu.chips)
        if attributed:
            self._attribute_bound_pods(tpu, skip=real_idx)
        tpu.external_used_chips = self._external_used(
            tpu, claims_attributed=attributed
        )
        self.cluster.put_tpu_metrics(tpu)
        return tpu

    def _external_used(self, tpu: TpuNodeMetrics, *, claims_attributed: bool) -> int:
        """Hardware-read used chips NOT attributable to any Running pod on
        this node: an external tenant / foreign process. The scheduler
        treats these as occupied-by-nobody — they absorb no accountant
        reservation and earn no stale-freed credit (api/types.py
        ``external_used_chips``).

        Attribution rules, all in the conservative direction (an
        under-counted claim inflates ``external`` and at worst withholds a
        chip; an over-counted claim hides a real external tenant and
        overcommits the node):

        - only RUNNING pods count — a Pending pod has not attached the
          TPU, so its chips cannot be behind this scrape's counters;
        - only pods that actually express a TPU attachment count
          (``wants_tpu`` labels or a ``google.com/tpu`` resource limit) —
          the same rule the scheduler's accountant applies
          (plugins/yoda/accounting.py: "Foreign non-TPU pods hold no
          chips"). Counting every Running pod would let kube-proxy,
          log collectors, and this agent itself absorb the external
          tenant's chips one-for-one;
        - ``claims_attributed=True`` (partial libtpu coverage: bound pods
          were already label-charged onto the UNCOVERED chips by
          ``_attribute_bound_pods``) absorbs nothing — the same claim must
          not both occupy an uncovered chip and explain a covered chip's
          hardware usage (it would hide a real external tenant). The cost
          when the pod actually runs on a covered chip is one chip of
          double-withholding — undercommit, never overcommit."""
        from yoda_tpu_torch.api.requests import LabelParseError, pod_request

        hw_used = sum(
            1 for c in tpu.chips if c.hw_read and c.hbm_free < c.hbm_total
        )
        if hw_used == 0:
            return 0
        if claims_attributed:
            return hw_used
        running_claims = 0
        for pod in self.cluster.list_pods():
            if pod.node_name != self.node_name or pod.phase != "Running":
                continue
            try:
                req = pod_request(pod)
            except LabelParseError:
                # Malformed labels with a real device-plugin limit still
                # attach chips (accounting.py parity).
                if pod.tpu_resource_limit > 0:
                    running_claims += pod.tpu_resource_limit
                continue
            if req.wants_tpu:
                # pod_request folds google.com/tpu limits into chips, so
                # wants_tpu covers resource-limit pods too (requests.py).
                running_claims += req.effective_chips
        return max(hw_used - running_claims, 0)

    def _attribute_bound_pods(self, tpu: TpuNodeMetrics, skip=frozenset()) -> None:
        """HBM attribution via the one shared occupancy model
        (agent/fake_publisher.py ``charge_bound_pods``), over the chips
        whose free HBM is NOT hardware-read (``skip`` = chip indices with
        real counters)."""
        from yoda_tpu_torch.agent.fake_publisher import charge_bound_pods

        chips = [c for c in tpu.chips if c.index not in skip]
        if not chips:
            return
        free = [c.hbm_free for c in chips]
        charge_bound_pods(free, self.cluster.list_pods(), self.node_name)
        for chip, f in zip(chips, free):
            chip.hbm_free = f
