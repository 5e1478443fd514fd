"""Smoke test of the PyTorch/H100 port (yoda_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. Device: the card's name and power limit (nvidia-smi), then the build of
   the hand-written CUDA kernels from yoda_tpu_torch/csrc/fleet_eval.cu and
   joint_fit.cu, one nvcc each, started together (with ptxas's register
   and shared-memory report).
2. Kernels against their plain PyTorch versions on the card, tolerance 0
   (everything is int32):
   - fleet_eval: seeded fleets of 8 chips per node from 1 node to 262,144
     (smaller than one tile, ragged tiles, the main path's shapes, blocks
     walking several tiles) and K = 144 / 256 requests (launched as 128-row
     chunks), and past one 32-bit chip mask (the wide instantiation):
     8,192 x 64 chips at K = 1, 16 and 144 and 1,024 x 128 at K = 16;
     default and most-allocated weights; all six output rows must be
     equal. Per shape: the launch plan, the wrapper's time (median of
     CUDA-event timings around each call after warm-up), the plain
     version's, the bound (the bytes the function must move over the
     card's 3.35 TB/s, or its integer operations over the card's 32-bit
     rate where those take longer) and an nvidia-smi sample of SM clock
     and power. At the main path's shapes, 65,536 nodes and the wide
     shapes also the kernel's device time per call and the CUDA launches
     per call from a torch.profiler window (one per 128-row chunk per
     call: the kernel's events equal to the calls and to the wrapper's own
     launch count over the window, no other device event; a window in
     which the tracer lost kernel events is reopened, up to three, and
     printed), and at the main path's shapes the host round trip of
     TorchFleetKernel.evaluate_burst (pack, upload, launch, fetch), back
     to back and after 5 ms of sleep or of host work between calls.
   - joint_fit: seeded [K, 6, N] rows with heavy score ties, padding rows
     and gangs that fail at their first row, part-way and after a fit, at
     (K, N) = (1, 1), (3, 37), (16, 5000), (64, 8192), (256, 8192),
     (64, 65,536), (16, 262,144) (past the shared-memory ledgers: tent in
     a global scratch) and (64, 8191) (every row misaligned for the bulk
     copies); plus run (c)'s plain gangs as the scan sees them (8 gangs x
     16 identical rows, each taking a whole 8-chip host: every pick the
     next-best host) and equal top scores on both sides of every slice
     edge. Picks, group verdicts and the ledger must be equal. Per shape:
     the cluster plan (blocks, threads, ring stages, shared bytes, shared
     ledgers), the times as above, the device time and launches per call
     from the profiler, us per row, the bound, and beside them the device
     ms of the one-block design that this one replaced, as PERF.md records
     it from an earlier run (not measured here). The scan is a dependent chain of K cluster-wide arg-maxes, so
     the bytes bound is far below what any sequential design reaches.
3. The main path: the port's build_stack over its FakeCluster, a
   5,000-node fleet published by its FakeTpuAgent (512 v5p 2x2x1 slices =
   2,048 hosts x 4 chips, each a v5p-32, plus 2,952 v5e hosts x 8 chips),
   in four runs:
   (a) 64 singleton pods at batch_requests 1 and (b) 256 at
       batch_requests 16, with mixed tpu/chips, tpu/hbm, tpu/clock and
       tpu/generation labels;
   (c) gangs at batch_requests 16, created in two seeded interleaved
       waves: first 8 plain gangs of 16 v5e members x 8 chips and 4
       coscheduling-alias gangs of 4 x 4 chips with 32 singletons (their
       joint pass is plain gangs only, so its fit gate is the joint-fit
       kernel, over 144 rows), then 16 topology gangs (2x2x1, 4 v5p
       members x 4 chips: one whole v5p-32 each) and 4 multislice gangs
       (2 x 2x2x1, 8 members) with 32 more singletons (a joint pass with
       topology gangs takes the host block planner, as in the reference);
       240 gang members and 304 pods;
   (d) contention at the joint fit gate: Node objects labelled
       pool=contended on 52 v5e hosts and 4 plain gangs of 16 v5e members
       x 8 chips selecting that pool, co-queued: three fit (48 hosts), the
       fourth must park whole at the gate with nothing bound or reserved
       (it has no lower-priority victim, so preemption evicts nothing).
   Preemption is on in every run, as build_stack builds it by default.
   Each run: every pod binds (in (d) all but the parked gang) without
   over-committing a host, every gang is all-or-nothing, topology members
   land one per host on one slice and multislice members on two, every
   evaluation launched the hand kernels (fleet_eval calls ==
   dispatch_count, its launches == the 128-row chunks those calls needed,
   joint_fit launches == fused_plan_dispatches), no dispatch error, no
   Permit waiter left (no run waits on a real permit timeout), and the
   same script through kernel_platform "cpu" (the plain versions) binds
   every pod to the same node and launches nothing. Printed per run:
   pods/s, per-pod p50/p99, gang completion p50/p99 (first member's cycle
   start to the last member's bind, on the scheduler's clock), evaluation
   ms per call, and for (c)/(d) the joint_fit device ms on the inputs the
   run gave it (and us per row; per recorded launch where the tracer lost
   kernel records, with every profiler window it opened).
   Then: TorchFleetKernel.update_rows against a fresh put_static; run (e),
   256 singletons under agent churn (docstring of run_churn); run (f),
   preemption at full width (BASELINE config 5): every host has a Node
   object, 64 v5e hosts are pool=mixed-e and 4 v5p-32 slices pool=mixed-p;
   wave 1 (priority 1) fills both with 256 pods of 2 chips and 16 of 4,
   the agent republishes the bound hosts, and wave 2 (batch_requests 16)
   brings 2 plain gangs of 16 x 8 chips (priority 100) and 8 singletons of
   8 chips (priority 50) on mixed-e and 2 topology gangs 2x2x1 (priority
   100) on mixed-p. Its bindings, evicted pods, evictions, nominations,
   re-stacks and delta syncs must equal the CPU run's, every wave-2 pod
   binds (gangs whole, topology gangs on one slice), no host is over its
   healthy chips, and it prints wave 2's pods/s, p50/p99, gang p50/p99
   and PostFilter ms per call. Then run (g), inter-pod affinity, topology
   spread, volumes and budgets on the same fleet: every host has a Node
   object with its hostname and one of four zones (each v5p slice wholly in
   one, the v5e hosts in four blocks of 738), and wave 1 (batch_requests
   16) brings, in this order, 24 volume pods (16 claims labelled for a
   zone and bound to CSI PVs whose nodeAffinity names it, two zone-2 hosts
   with local SSD and an attach limit of 1 that zone 2's volume pods
   prefer; 4 WaitForFirstConsumer claims with their selected node; 4 pods
   sharing a ReadWriteOnce claim that a Running pod mounts), 64 plain
   singletons in run (b)'s mix, 48 llm-serve replicas (v5e, 4 chips,
   required anti-affinity over hostname, a DoNotSchedule zone spread with
   maxSkew 1 and matchLabelKeys pod-template-hash), 48 kv-cache pods with
   preferred affinity (weight 100) to them, 4 team-b pods with required
   zone affinity to them through a namespaceSelector, and gangs ft-a (8 x
   4 chips, self anti-affinity over hostname) and ft-b (8 x 8 chips, self
   affinity over zone). Wave 2: 32 tainted v5e hosts of pool mixed-g
   filled at priority 1, half of the pods under a budget that allows no
   disruption, the agent republishing every bound host, a priority-100
   gang of 16 x 8 chips on the pool (it may evict only the unprotected
   half) and a priority-50 singleton of 8 chips (its eviction is refused).
   Its bindings, evictions, refused evictions, nominations and counters
   must equal the CPU run's, and every placement must hold (replicas on
   distinct hosts with zone skew <= 1, ft-a on 8 hosts, ft-b in one zone,
   volume pods where their claims allow, no attach limit exceeded, no
   protected pod evicted). Printed: both waves' pods/s and p50/p99, gang
   p50/p99, host ms per call of the evaluator builds, of the admission row
   with an AffinityData and of the preference bonus, PostFilter ms,
   fleet_eval's device ms at K = 1 on an input of the run, and the parts
   build_stack did not build (Stack.not_built). Then a fleet of 40-chip
   and 8-chip hosts (the wide kernel on the main path) at K = 1 and 16
   must bind as on the CPU. Last, run (h), the background path on the
   5,000-node fleet (``run_background``, ``BACKGROUND_FULL``; the tests
   run ``BACKGROUND_SMALL``):
   (h1) 256 v5e singletons of 1, 2, 4 and 8 chips at K = 1 in 16 waves of
       16, one ``speculate_once`` before each: the speculative cache's
       private TorchFleetKernel evaluates on its own CUDA stream and the
       serve path binds hot shapes from its plans. Printed: hits, misses,
       invalidations, ms per speculate_once, ms per consumed plan's bind,
       pods/s and p50/p99, the private kernel's launches, and fleet_eval
       at K = 1 on the private stream alone and while a second thread
       launches what the serve path launches on the default stream
       (fleet_eval at K = 16, joint_fit on 64 x 8,192 rows): device ms
       and overlap in time from a profiler window of each, both threads'
       results held against the plain version;
   (h2) 64 v5e hosts filled at priority 1, 1x1x1 topology gangs on 4 v5p
       slices with each slice's diagonal deleted, an elastic gang (min 4,
       max 16, size 8) and a parked priority-100 gang of 16 x 8 chips in
       a stack with preemption off: ``resync`` and ``run_once`` until a
       pass changes nothing (preemption, resize and repack moves);
   (h3) a stack rebuilt over (h2)'s cluster with a half-bound gang left
       by the dead leader (adopted, completes), then a ghost binding, a
       dropped deletion and a leaked claim for the drift pass;
   (h4) ``run_forever`` on a second thread (1 s passes, 50 ms speculation
       ticks) while the main thread serves 256 singletons and four plain
       gangs (two joint passes of two gangs) at K = 16 over about 8 s,
       with at least one rebalance pass begun inside that window:
       invariants only (capacity, accounting, whole gangs, every consumed
       plan's node admits its pod, both threads launched fleet_eval and
       the serve thread joint_fit, counted per kernel object from zero
       just before the window, no error logged).
   (h1)-(h3) must equal the same script on kernel_platform "cpu" in
   bindings, plans, counters and reports; that CPU run goes on in a
   second process (two threads), started once the kernels are built, so
   it overlaps the card's phases. (h4) runs on the card only, twice: as
   above and with the speculative cache off (``spec_enabled=False``),
   each printing the burst rows that failed the serve-time check and
   the serve path's dispatches and launches per pod.
   Then run (i), the node health path on the same fleet
   (``run_nodehealth``, ``NODEHEALTH_FULL``; the tests run
   ``NODEHEALTH_SMALL``), every host with a Node object: an elastic gang
   (16 x 8 chips, min 8) on a 16-host pool, two plain gangs of 16 x 8 on
   a 32-host pool, then 16 topology gangs (2x1x1 x 4 chips, each on a
   v5p slice of its own), 6 more plain gangs of 16 x 8 and 128
   singletons, at K = 16 with ``bind_workers`` 0 (unbinds in order). One
   fake wall clock drives the agent's stamps and the monitor's ladder,
   and a stepped scheduling clock the queue, so both platforms take the
   same decisions; the monitor is driven by ``run_once``:
   (i1) 64 heartbeats holding gang members and singletons stop and the
       clock passes ``node_suspect_after_s``: 64 rows fenced (a probe
       dispatch right after counts the admission rows patched, with no
       re-stack and no row update); 256 singletons served at K = 16,
       none on a fenced host; 32 heartbeats resume (a flap: no repair);
       the other 32 pass ``node_down_after_s``, and one pass patches the
       topology and plain gangs, shrinks the elastic gang and requeues the
       singletons;
   (i2) ``kill_node`` under a topology gang (its claims released at event
       time) and ``set_node_ready(False)`` under a plain gang, repaired;
   (i3) a drain under a topology gang that the rebalancer's pass migrates,
       and a drain with deadline 0 that the next pass evacuates;
   (i4) 18 hosts under the two pool gangs go silent past the down
       threshold: both requeue whole and park; the heartbeats resume, the
       fence opens, and both gangs bind in one fused joint pass (the
       ``joint_fit`` launch).
   Bindings after each part, node states, fence sets and every pass's
   RepairReport must equal the CPU run (in the rerun process above); no
   pod may bind on a host while fenced, no host over its chips, no gang
   split, no claim leaked, and on the card every ``fleet_eval`` and
   ``joint_fit`` call of the run equals its plain version on the same
   inputs. Printed: ms per pass, each repair's ``durations_ms``, host ms
   from a pass to each repaired gang's last re-bind, the counters across
   each fence flip and the launches by part.
4. One line {"kernels": [...]} with each kernel's launches over every run
   above (runs (h)'s and (i)'s also by part, and the speculation thread's
   apart), its largest difference from the plain version and its times
   ("not measured" where the profiler saw no device activity). Before it,
   one line of each phase's wall seconds.

The last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
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
    (1, 1, 1),              # smaller than one 64-node tile
    (37, 37, 1),
    (37, 64, 1),
    (37, 37, 16),
    (256, 256, 8),
    (5000, 5000, 16),       # not a multiple of the tile
    (5000, 8192, 1),
    (5000, 8192, 16),
    (65536, 65536, 16),
    (262144, 262144, 4),    # more tiles than the grid: blocks walk several
]
# fleet_eval past one launch's 128 requests: chunked, still exact.
CHUNKED_SHAPES = [(5000, 8192, 144), (5000, 8192, 256)]
# Past 32 chips a node (one 33-chip host pads every node to 64): the wide
# instantiation, (real nodes, padded nodes, K, chips). 8,192 x 64 stages its
# tiles at K = 1 and 16 and reads global memory at K = 144 (two 128-row
# chunks); 1,024 x 128 reads global memory.
WIDE_SHAPES = [
    (5000, 8192, 1, 64), (5000, 8192, 16, 64), (5000, 8192, 144, 64),
    (1000, 1024, 16, 128),
]
MAIN_PATH_SHAPE = (5000, 8192, 16)
JOINT_SHAPES = [
    (1, 1), (3, 37), (16, 5000), (64, 8192), (256, 8192), (64, 65536),
    (16, 262144),  # past the shared-memory ledgers
    (64, 8191),    # rows misaligned for the bulk copies
]
JOINT_MAIN_SHAPE = (64, 8192)  # run (d)'s joint pass
# The one-block design that joint_fit.cu's cluster design replaced: its
# device ms per call as PERF.md records them from the run that measured it
# (H100 80GB HBM3 at 700 W). Not measured here: printed beside this run's
# times on the per-shape lines only, never in the kernels line.
ONE_BLOCK_DEVICE_MS = {
    (1, 1): 0.0022, (3, 37): 0.0041, (16, 5000): 0.0416, (64, 8192): 0.2207,
    (256, 8192): 0.8783, (64, 65536): 2.3456, "run c": 0.403, "run d": 0.047,
}
# Shapes whose device time the profiler reads: the main path's two and a
# fleet of 65,536 nodes.
PROFILED_SHAPES = [(5000, 8192, 1), (5000, 8192, 16), (65536, 65536, 16)]
CHIPS = 8
REQUEST_TABLE = np.array(
    [[1, 0, 0, 0, 0], [2, 8192, 0, 0, 0], [4, 4096, 900, 5, 1], [8, 15360, 990, 6, 0]],
    dtype=np.int32,
)


def not_measured(value):
    return "not measured" if value is None else value


def fail(phase: str, err: BaseException | str) -> None:
    print(f"FAILED in {phase}: {err}", file=sys.stderr)
    sys.exit(1)


def random_fleet(n_real: int, n_pad: int, seed: int, chips: int = CHIPS):
    """Seeded stacked fleet in the device layout: chips [9, C, N], static
    nodes [4, N], dynamics [4, N] (rows >= n_real are padding)."""
    rng = np.random.default_rng(seed)
    valid = np.zeros(n_pad, dtype=np.int32)
    valid[:n_real] = 1
    grid = (chips, n_pad)
    total = np.full(grid, 16 * 1024, dtype=np.int32)
    free = (total - rng.integers(0, 16 * 1024, size=grid)).astype(np.int32)
    chip_rows = np.stack(
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
    return chip_rows, nodes, dyn


def bound(n: int, k: int, c: int = CHIPS) -> tuple[float, str]:
    """Least time for the evaluation in ms, and what sets it: each input
    read once and each output written once over the memory rate, against
    the integer operations per (chip, request) pair over the card's 32-bit
    rate (bytes at 8 chips; operations at 64 chips and K = 144)."""
    in_bytes = (9 * c * n + 4 * n + 4 * n + k * n + 5 * k) * 4
    out_bytes = 6 * k * n * 4
    bytes_s = (in_bytes + out_bytes) / MEM_BYTES_PER_S
    ops_s = OPS_PER_CHIP_ELEMENT * c * n * k / INT32_OPS_PER_S
    return max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations"


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


def profiled_ms(
    fn, counter, calls: int = 20, kernel: str = "fleet_eval", windows: int = 3,
    short_ok: bool = False, per_call: int = 1,
) -> tuple[float | None, float | None, list[dict]]:
    """Device time of ``kernel`` per call (summed over the call's
    ``per_call`` launches: 128-row chunks) and its CUDA launches per call,
    from a torch.profiler window over ``calls`` calls of ``fn``, and what
    each window opened saw; (None, None, windows) when the profiler records
    no device activity. ``counter()`` reads the wrapper's own launch count.

    Each window is held against two counts besides its kernel events: the
    wrapper's own launches over it, which must equal ``calls`` x
    ``per_call``, and the launch calls (cudaLaunch*) that the tracer
    recorded on the host. It raises on any device event but ``kernel``'s (a
    memset, another kernel) and on more kernel events or launch calls than
    that. The first window with exactly that many kernel events gives the
    times; a short
    one is reopened, up to ``windows`` windows, and when none is exact it
    raises. With ``short_ok``, for inputs on which the tracer was seen to
    lose kernel records (on an H100 80GB HBM3, 1 or all 20 of them on the
    gang runs' inputs, while both counts said 20), the fullest short window
    whose host launch calls equal ``calls`` gives the device time per
    recorded launch instead, and the launches per call are those launch
    calls per call. Each window opens 50 ms before its first call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen, fullest = [], None
    expected = calls * per_call
    for _ in range(windows):
        before = counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernel_us, events, launch_calls, others = 0.0, 0, 0, {}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                if evt.key.startswith("cudaLaunch"):
                    launch_calls += evt.count
                continue
            if evt.key.startswith("Memcpy"):
                continue
            if kernel not in evt.key:
                others[evt.key] = evt.count
                continue
            events += evt.count
            total = getattr(evt, "self_device_time_total", None)
            if total is None:
                total = evt.self_cuda_time_total
            kernel_us += total
        window = dict(kernel_events=events, wrapper_launches=counter() - before,
                      host_launch_calls=launch_calls)
        seen.append(window)
        if (others or max(events, launch_calls) > expected
                or window["wrapper_launches"] != expected):
            raise AssertionError(
                f"{kernel}: not {per_call} launch(es) per call in {calls} calls: "
                f"{window}, other device events {others}"
            )
        if events == expected:
            return kernel_us / calls / 1e3, events / calls, seen
        if events and launch_calls == expected and (fullest is None or events > fullest[1]):
            fullest = (kernel_us, events, launch_calls)
    if short_ok and fullest is not None:
        kernel_us, events, launch_calls = fullest
        return kernel_us / events / 1e3, launch_calls / calls, seen
    if any(window["kernel_events"] for window in seen):
        raise AssertionError(f"{kernel}: no profiler window held {calls} launches: {seen}")
    return None, None, seen


def smi_sample() -> str:
    """The card's SM clock, power draw and power limit, now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi}")
    from yoda_tpu_torch.ops import cuda_kernel

    t0 = time.monotonic()
    libs = cuda_kernel.build_all()
    print(f"built {', '.join(lib.name for lib in libs.values())} in "
          f"{time.monotonic() - t0:.2f} s (in parallel)")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "bytes stack" in line or "error" in line:
                    print(f"  ptxas {lib.stem}: {line.strip()}")
    return kind, smi


def round_trip_ms(chips, nodes, dyn, host_ok, reqs, calls: int = 30) -> dict:
    """Host wall time of TorchFleetKernel.evaluate_burst calls on the card
    (pack and upload the per-call inputs, launch, fetch, unpack), median ms
    per call: back to back ("hot"), after 5 ms of sleep ("after_sleep",
    host and card idle) and after 5 ms of host Python work that touches
    8 MB ("after_work", as a scheduling cycle does). "pack_hot" and
    "pack_after_sleep" time the host-only packing step (pack_inputs) alone
    the same ways, to tell a slower host from a slower card."""
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.ops.arrays import FleetArrays
    from yoda_tpu_torch.ops.kernel import CHIP_KEYS, STATIC_NODE_KEYS, KernelRequest
    from yoda_tpu_torch.ops.kernel import TorchFleetKernel, pack_inputs, pack_request

    n_real = int(nodes[0].sum())
    fields = {key: chips[i].T for i, key in enumerate(CHIP_KEYS)}
    fields.update({key: nodes[i] for i, key in enumerate(STATIC_NODE_KEYS)})
    fields.update(
        names=[f"n{i}" for i in range(n_real)], fresh=dyn[0],
        reserved_chips=dyn[1], claimed_hbm_mib=dyn[2], host_ok=host_ok[0],
        last_updated=np.zeros(dyn.shape[1]),
    )
    kern = TorchFleetKernel(
        SchedulerConfig().effective_weights(), torch.device("cuda", 0)
    )
    kern.put_static(FleetArrays.from_numpy(fields))
    requests = [KernelRequest(*map(int, r)) for r in reqs]

    def work() -> None:
        end = time.perf_counter() + 0.005
        while time.perf_counter() < end:
            junk = bytearray(8 << 20)
            junk[:: 4096] = b"x" * len(junk[:: 4096])

    def evaluate() -> None:
        kern.evaluate_burst(dyn, host_ok, requests)

    def pack() -> None:
        pack_inputs(dyn, host_ok, np.stack([pack_request(r) for r in requests]))

    def sleep() -> None:
        time.sleep(0.005)

    out = {}
    for name, fn, gap in (
        ("hot", evaluate, None), ("after_sleep", evaluate, sleep),
        ("after_work", evaluate, work), ("pack_hot", pack, None),
        ("pack_after_sleep", pack, sleep),
    ):
        for _ in range(3):
            fn()
        times = []
        for _ in range(calls):
            if gap:
                gap()
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        out[name] = 1e3 * statistics.median(times)
    return out


def joint_case(k: int, n: int, seed: int):
    """Seeded joint-fit inputs: [K, 6, N] rows whose rows 0, 3, 5 are
    feasible / score / claimable, with heavy score ties (scores 0..3),
    gangs of 1-6 rows, the last K // 8 rows padding, and demands (up to 40
    chips against 0..8 claimable) that fail gangs at their first row,
    part-way and after an earlier gang fit."""
    from yoda_tpu_torch.ops.kernel import KernelRequest, joint_fit_vectors

    rng = np.random.default_rng(seed)
    packed = rng.integers(-9, 9, size=(k, 6, n)).astype(np.int32)
    packed[:, 0] = rng.random((k, n)) > 0.4
    packed[:, 3] = rng.integers(0, 4, size=(k, n))
    packed[:, 5] = rng.integers(0, 9, size=(k, n))
    m = k - k // 8
    offsets = [0]
    while offsets[-1] < m:
        offsets.append(min(m, offsets[-1] + int(rng.integers(1, 7))))
    requests = [
        KernelRequest(int(rng.choice([1, 2, 4, 8, 40])), 0, 0, 0, 0)
        for _ in range(m)
    ] + [KernelRequest(1, 0, 0, 0, 0)] * (k - m)
    return (packed, *joint_fit_vectors(requests, offsets))


def identical_rows_case(n_hosts: int = 5000, n: int = 8192, gangs: int = 8,
                        size: int = 16, seed: int = 31):
    """Run (c)'s plain gangs as the scan sees them: ``gangs`` gangs of
    ``size`` rows with the same feasibility and scores, each row demanding
    a whole 8-chip host on 8-chip hosts (claimable 8), with score ties."""
    from yoda_tpu_torch.ops.kernel import KernelRequest, joint_fit_vectors

    rng = np.random.default_rng(seed)
    packed = np.zeros((gangs * size, 6, n), dtype=np.int32)
    feas = np.zeros(n, dtype=np.int32)
    feas[:n_hosts] = rng.random(n_hosts) > 0.1
    packed[:, 0] = feas
    packed[:, 3] = rng.integers(0, 40, size=n)
    packed[:, 5] = 8 * (np.arange(n) < n_hosts)
    requests = [KernelRequest(8, 0, 0, 0, 0)] * (gangs * size)
    return (packed, *joint_fit_vectors(requests, list(range(0, gangs * size + 1, size))))


def slice_edge_case(k: int, n: int, slice_words: int, seed: int = 41):
    """Equal top scores on both sides of every slice edge e (nodes e - 1
    and e), e - 1 infeasible for the first gang's rows, one-chip demands
    on one-chip nodes."""
    from yoda_tpu_torch.ops.kernel import KernelRequest, joint_fit_vectors

    rng = np.random.default_rng(seed)
    packed = np.zeros((k, 6, n), dtype=np.int32)
    packed[:, 0] = rng.random((k, n)) > 0.05
    packed[:, 3] = rng.integers(0, 50, size=(k, n))
    packed[:, 5] = 1
    for e in range(slice_words, n, slice_words):
        packed[:, 3, e - 1] = packed[:, 3, e] = 1000
        packed[:, 0, e] = 1
        packed[: k // 2, 0, e - 1] = 0
    requests = [KernelRequest(1, 0, 0, 0, 0)] * k
    return (packed, *joint_fit_vectors(requests, [0, k // 2, k]))


def joint_bound_ms(k: int, n: int) -> float:
    """Least time for the scan: rows 0, 3 and 5 of [K, 6, N] read once, the
    three [K] side inputs read once, picks and verdicts [K] and the ledger
    [N] written once, over the memory rate (a few integer operations per
    element: the operations' time is far smaller)."""
    return (3 * k * n + 3 * k + 2 * k + n) * 4 / MEM_BYTES_PER_S * 1e3


def phase_joint_fit() -> list[dict]:
    """joint_fit against its plain version at the JOINT_SHAPES, on the
    identical-rows case and on ties across slice edges."""
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops.cuda_kernel import joint_fit, joint_fit_plan
    from yoda_tpu_torch.ops.kernel import joint_fit_scan

    dev = torch.device("cuda", 0)
    cases = [((k, n), joint_case(k, n, seed=k * 7 + n)) for k, n in JOINT_SHAPES]
    cases.append(("identical rows", identical_rows_case()))
    edge_slice = joint_fit_plan(8192, dev)["slice"]
    cases.append(("slice-edge ties", slice_edge_case(64, 8192, edge_slice)))
    rows = []
    for name, case in cases:
        packed, chips, starts, valid = (torch.from_numpy(x).to(dev) for x in case)
        k, _, n = packed.shape
        got = joint_fit(packed, chips, starts, valid)

        def plain():
            return joint_fit_scan(
                packed[:, 0], packed[:, 3], packed[:, 5], chips, starts, valid
            )

        want = plain()
        torch.cuda.synchronize()
        err = max(
            int((g.long() - w.long()).abs().max()) if g.numel() else 0
            for g, w in zip(got, want)
        )
        if err or not all(torch.equal(g, w.to(torch.int32)) for g, w in zip(got, want)):
            raise AssertionError(f"joint_fit != plain on {name} (K={k} N={n}): max |diff| {err}")
        if name == "identical rows":
            feas, scores = case[0][0, 0], case[0][0, 3]
            order = sorted(np.flatnonzero(feas), key=lambda j: (-int(scores[j]), j))
            if got[0].cpu().tolist() != order[:k]:
                raise AssertionError("identical rows: a pick is not the next-best host")
        plan = joint_fit_plan(n, dev)
        if n == 65536 and not plan["shared_ledgers"]:
            raise AssertionError(f"ledgers in global memory at 65,536 nodes: {plan}")
        row = dict(
            case=name if isinstance(name, str) else "seeded", k=k, n=n,
            max_abs_err=err, tolerance=0, plan=plan,
            taken=int((got[0] >= 0).sum()), gangs_fit=int(got[1].sum()),
            bound_ms=joint_bound_ms(k, n),
            ms=cuda_ms(lambda: joint_fit(packed, chips, starts, valid)),
            plain_ms=cuda_ms(plain, warmup=1, iters=3),
        )
        row["device_ms"], row["launches_per_call"], row["profiler_windows"] = profiled_ms(
            lambda: joint_fit(packed, chips, starts, valid),
            lambda: cuda_kernel.joint_fit_launches, kernel="joint_fit",
        )
        if row["device_ms"] is not None:
            row["us_per_row"] = 1e3 * row["device_ms"] / k
        if name in ONE_BLOCK_DEVICE_MS:
            row["one_block_device_ms_earlier_run"] = ONE_BLOCK_DEVICE_MS[name]
        row["smi"] = smi_sample()
        rows.append(row)
        print("joint_fit", json.dumps(row))
    return rows


def phase_kernel() -> tuple[list[dict], dict]:
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops.cuda_kernel import fleet_eval, launch_plan
    from yoda_tpu_torch.ops.kernel import kernel_packed_burst

    dev = torch.device("cuda", 0)
    weight_sets = {
        "least-allocated": SchedulerConfig().effective_weights(),
        "most-allocated": SchedulerConfig(
            scoring_strategy="most-allocated"
        ).effective_weights(),
    }
    rows = []
    cases = [(*s, CHIPS) for s in KERNEL_SHAPES + CHUNKED_SHAPES] + WIDE_SHAPES
    for n_real, n_pad, k, c in cases:
        chips, nodes, dyn = random_fleet(n_real, n_pad, seed=n_pad + k + c, chips=c)
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
                    f"kernel != plain at nodes={n_real} C={c} K={k} {wname}: "
                    f"max |diff| {err}, first [k, row, node] {bad}"
                )
            if k > 1 and int(got[-1, 0].sum()) != 0:
                raise AssertionError("padding row came out feasible")
            row = dict(
                nodes=n_real, padded=n_pad, k=k, chips=c, weights=wname,
                max_abs_err=err, tolerance=0,
            )
            row["bound_ms"], row["bound_by"] = bound(n_pad, k, c)
            wide = c > CHIPS
            if wname == "least-allocated" and not wide and (n_real, n_pad, k) in CHUNKED_SHAPES:
                row["ms"] = cuda_ms(lambda: fleet_eval(*args, w))
                row["smi"] = smi_sample()
            elif wname == "least-allocated":
                row["plan"] = launch_plan(n_pad, c, min(k, cuda_kernel.MAX_REQUESTS), dev)
                row["ms"] = cuda_ms(lambda: fleet_eval(*args, w))
                row["plain_ms"] = cuda_ms(
                    lambda: kernel_packed_burst(*args, w), iters=3 if wide else 10
                )
                if wide or (n_real, n_pad, k) in PROFILED_SHAPES:
                    (row["device_ms"], row["launches_per_call"],
                     row["profiler_windows"]) = profiled_ms(
                        lambda: fleet_eval(*args, w), lambda: cuda_kernel.launches,
                        per_call=-(-k // cuda_kernel.MAX_REQUESTS),
                    )
                    row["profiled"] = True
                    if n_pad == 8192 and not wide:
                        row["round_trips_ms"] = round_trip_ms(
                            chips, nodes, dyn, host_ok, reqs
                        )
                        row["round_trip_ms"] = row["round_trips_ms"]["hot"]
                row["smi"] = smi_sample()
            rows.append(row)
            print("kernel", json.dumps(row))
    main = [r for r in rows if r.get("profiled")]
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
    """Runs (a) and (b) of the main path on one kernel_platform; returns
    the bindings, counters and latencies."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.ops import cuda_kernel

    out = {}
    for run, pods, burst in (("a", pods_a, 1), ("b", pods_b, 16)):
        stack, _agent = build_fleet(platform, burst)
        n_nodes = len(stack.informer.snapshot())
        for name, labels in pods:
            stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
        # Wall time inside the evaluation (uploads, kernel, result fetch),
        # against the whole run: the share of the cycle the device path
        # can move.
        kern = stack.batch._kern
        eval_s: list[float] = []

        def timed(*args, _inner=kern.evaluate_burst):
            t = time.monotonic()
            try:
                return _inner(*args)
            finally:
                eval_s.append(time.monotonic() - t)

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
            **resident_counts(b),
            wall_s=wall, eval_s=sum(eval_s),
            eval_ms_per_call=1e3 * sum(eval_s) / max(len(eval_s), 1),
            eval_ms_median=1e3 * statistics.median(eval_s) if eval_s else None,
            pods_per_s=len(lat) / wall if wall else 0.0,
            p50_ms=1e3 * lat[len(lat) // 2] if lat else None,
            p99_ms=1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else None,
        )
    return out


def build_fleet(
    platform: str,
    burst: int,
    pools: "dict[str, str] | None" = None,
    *,
    node_fn=None,
    slices: int = 512,
    v5e_hosts: int = 2952,
    clock=None,
    now_fn=None,
    **knobs,
):
    """The 5,000-node fleet's stack and its agent: 512 v5p 2x2x1 slices and
    2,952 v5e hosts, published by the port's FakeTpuAgent. With ``pools``
    every host gets a Node object, labelled pool=<its pool> where ``pools``
    names it; with ``node_fn`` every host gets ``node_fn(name)``. Smaller
    fleets for the card tests through ``slices`` and ``v5e_hosts``; the
    stack's scheduling clock through ``clock``, the agent's wall clock
    through ``now_fn``; other SchedulerConfig knobs through ``knobs``."""
    from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
    from yoda_tpu_torch.api.types import K8sNode
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.standalone import build_stack

    stack = build_stack(
        config=SchedulerConfig(kernel_platform=platform, batch_requests=burst, **knobs),
        **({} if clock is None else {"clock": clock}),
    )
    agent = FakeTpuAgent(stack.cluster, **({} if now_fn is None else {"now_fn": now_fn}))
    hosts = []
    for s in range(slices):
        hosts += agent.add_slice(f"v5p-{s:03d}", generation="v5p", host_topology=(2, 2, 1))
    for h in range(v5e_hosts):
        agent.add_host(f"v5e-{h:04d}", generation="v5e", chips=8)
        hosts.append(f"v5e-{h:04d}")
    if pools is not None:
        node_fn = lambda name: K8sNode(  # noqa: E731
            name, labels={"pool": pools[name]} if name in pools else {}
        )
    if node_fn is not None:
        for name in hosts:
            stack.cluster.put_node(node_fn(name))
    agent.publish_all()
    return stack, agent


def resident_counts(b) -> dict:
    """The resident fleet state's counters on a run's batch plugin. A run
    with one re-stack (the boot) reports that re-stack's wall ms, the
    fleet's first lowering and upload."""
    r = b._resident
    if r is None:
        raise AssertionError("the stack did not ride the resident fleet state")
    return dict(
        restacks=b.restacks, delta_syncs=r.delta_syncs, rows_applied=r.rows_applied,
        sets_retained=b.sets_retained, burst_invalidated=b.burst_invalidated,
        admission_reuse=b.admission_reuse, admission_patched=b.admission_patched,
        admission_rebuilds=b.admission_rebuilds,
        first_restack_ms=r.last_restack_ms if r.restacks == 1 else None,
    )


def gang_script(seed: int):
    """Run (c)'s two waves of (name, labels, node selector) and the gang
    each gang member belongs to (name -> (kind, size))."""
    rng = np.random.default_rng(seed)
    singles = fleet_and_pods(seed)[0]  # 64 singletons drawn as for run (a)
    gangs: dict[str, tuple[str, int]] = {}

    def members(name, kind, labels, size):
        gangs[name] = (kind, size)
        return [(f"{name}-{i:02d}", dict(labels), None) for i in range(size)]

    wave1, wave2 = [], []
    for g in range(8):
        wave1 += members(f"plain{g}", "plain", {
            "tpu/gang": f"plain{g}", "tpu/gang-size": "16", "tpu/chips": "8",
            "tpu/generation": "v5e"}, 16)
    for g in range(4):
        wave1 += members(f"cosched{g}", "cosched", {
            "pod-group.scheduling.sigs.k8s.io/name": f"cosched{g}",
            "pod-group.scheduling.sigs.k8s.io/min-available": "4",
            "tpu/chips": "4"}, 4)
    for g in range(16):
        wave2 += members(f"topo{g}", "topology", {
            "tpu/gang": f"topo{g}", "tpu/topology": "2x2x1", "tpu/chips": "4",
            "tpu/generation": "v5p"}, 4)
    for g in range(4):
        wave2 += members(f"multi{g}", "multislice", {
            "tpu/gang": f"multi{g}", "tpu/topology": "2x2x1",
            "tpu/multislice": "2", "tpu/chips": "4"}, 8)
    wave1 += [(f"s{n}", labels, None) for n, labels in singles[:32]]
    wave2 += [(f"s{n}", labels, None) for n, labels in singles[32:]]
    waves = [[w[i] for i in rng.permutation(len(w))] for w in (wave1, wave2)]
    return waves, gangs


def contended_script():
    """Run (d): 4 plain v5e gangs of 16 x 8 chips selecting pool=contended."""
    gangs, pods = {}, []
    for g in range(4):
        name = f"cont{g}"
        gangs[name] = ("plain", 16)
        labels = {"tpu/gang": name, "tpu/gang-size": "16", "tpu/chips": "8",
                  "tpu/generation": "v5e"}
        pods += [(f"{name}-{i:02d}", dict(labels), {"pool": "contended"})
                 for i in range(16)]
    return [pods], gangs


def run_gang_path(platform: str, run: str) -> dict:
    """Run (c) or (d) on one kernel_platform; the bindings, counters and
    latencies."""
    from yoda_tpu_torch.api.types import K8sNode, PodSpec
    from yoda_tpu_torch.ops import cuda_kernel

    stack, _agent = build_fleet(platform, 16)
    if run == "c":
        waves, gangs = gang_script(seed=1)
    else:
        waves, gangs = contended_script()
        for h in range(52):
            stack.cluster.put_node(
                K8sNode(f"v5e-{h * 37:04d}", labels={"pool": "contended"})
            )
    kern = stack.batch._kern
    eval_s: list[float] = []
    fleet_calls: list[int] = []
    joint_inputs: list[tuple] = []

    def timed(inner):
        def call(*args, **kw):
            t = time.monotonic()
            try:
                return inner(*args, **kw)
            finally:
                eval_s.append(time.monotonic() - t)
        return call

    kern.evaluate_burst = timed(kern.evaluate_burst)
    kern.evaluate_joint_plan = timed(kern.evaluate_joint_plan)
    real_fleet_eval, real_joint_fit = cuda_kernel.fleet_eval, cuda_kernel.joint_fit

    def counted_fleet_eval(*args, **kw):
        fleet_calls.append(args[4].shape[0])
        return real_fleet_eval(*args, **kw)

    def kept_joint_fit(packed, *side, **kw):
        if packed.is_cuda:
            joint_inputs.append(tuple(t.clone() for t in (packed, *side)))
        return real_joint_fit(packed, *side, **kw)

    cuda_kernel.fleet_eval, cuda_kernel.joint_fit = counted_fleet_eval, kept_joint_fit
    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    t0 = time.monotonic()
    try:
        for wave in waves:
            for name, labels, selector in wave:
                stack.cluster.create_pod(
                    PodSpec(name, labels=labels, node_selector=selector or {})
                )
            stack.scheduler.run_until_idle(max_wall_s=600)
        if platform != "cpu":
            torch.cuda.synchronize()
    finally:
        cuda_kernel.fleet_eval, cuda_kernel.joint_fit = real_fleet_eval, real_joint_fit
    wall = time.monotonic() - t0
    launches, joint_launches = cuda_kernel.launches, cuda_kernel.joint_fit_launches
    pods = [name for wave in waves for name, _, _ in wave]
    bound = bindings_of(stack, pods)
    lat, completion = bind_latencies(
        stack.scheduler.stats.results,
        {name: labels for wave in waves for name, labels, _ in wave}, bound,
    )
    capacity = {
        t.name: sum(c.healthy for c in t.chips) for t in stack.cluster.list_tpu_metrics()
    }
    slice_of = {t.name: t.slice_id for t in stack.cluster.list_tpu_metrics()}
    b = stack.batch
    verdicts = {}
    for g, (kind, size) in gangs.items():
        nodes = [bound[n] for n in pods if n.startswith(f"{g}-")]
        verdicts[g] = dict(
            kind=kind, bound=sum(x is not None for x in nodes), size=size,
            hosts=len({x for x in nodes if x}),
            slices=len({slice_of[x] for x in nodes if x}),
            reserved=sum(
                stack.accountant.chips_in_use(x) for x in {x for x in nodes if x}
            ),
        )
    return dict(
        platform=platform, run=run, pods=len(pods),
        bound=sum(v is not None for v in bound.values()), bindings=bound,
        verdicts=verdicts,
        overcommitted=[h for h, c in capacity.items() if stack.accountant.chips_in_use(h) > c],
        launches=launches, fleet_calls=len(fleet_calls),
        chunks=sum(-(-k // cuda_kernel.MAX_REQUESTS) for k in fleet_calls),
        max_rows=max(fleet_calls, default=0), joint_fit_launches=joint_launches,
        waiting=len(stack.framework.waiting_pods()),
        **{c: getattr(b, c) for c in GANG_COUNTERS},
        **resident_counts(b),
        wall_s=wall, eval_s=sum(eval_s),
        eval_ms_per_call=1e3 * sum(eval_s) / max(len(eval_s), 1),
        pods_per_s=len(lat) / wall if wall else 0.0,
        p50_ms=pct_ms(lat, 0.5), p99_ms=pct_ms(lat, 0.99),
        gang_p50_ms=pct_ms(completion, 0.5), gang_p99_ms=pct_ms(completion, 0.99),
        joint_inputs=joint_inputs,
    )


GANG_COUNTERS = (
    "dispatch_count", "burst_dispatches", "burst_served", "gang_burst_dispatches",
    "gang_burst_served", "joint_dispatches", "joint_gangs", "joint_parked",
    "fused_plan_dispatches", "plan_served", "dispatch_errors",
)


def pct_ms(sorted_s: list[float], q: float) -> float | None:
    """The q-quantile (nearest rank below) of sorted seconds, in ms."""
    if not sorted_s:
        return None
    return 1e3 * sorted_s[min(len(sorted_s) - 1, int(q * len(sorted_s)))]


def bindings_of(stack, pods: list[str]) -> dict:
    """Each pod's node, None while pending, "evicted" once preemption took
    it."""
    out = {}
    for name in pods:
        pod = stack.cluster.get_pod(f"default/{name}")
        out[name] = "evicted" if pod is None else pod.node_name
    return out


def bind_latencies(results, labels_of: dict, bound: dict) -> tuple[list, list]:
    """Sorted per-pod latencies and per-gang completion times, seconds on
    the scheduler's clock, of the pods in ``labels_of``: a pod's first cycle
    start to its bind — its own "bound" cycle, or for a gang member the end
    of the cycle whose Permit released the gang (the last member's)."""
    from yoda_tpu_torch.api.requests import gang_name_of

    first: dict[str, float] = {}
    span: dict[str, tuple[float, float]] = {}
    bound_at: dict[str, float] = {}
    for r in results:
        name = r.pod_key.split("/", 1)[1]
        if name not in labels_of:
            continue
        first.setdefault(name, r.completed_at - r.latency_s)
        g = gang_name_of(labels_of[name])
        if g is not None and bound[name] not in (None, "evicted"):
            lo, hi = span.get(g, (float("inf"), 0.0))
            span[g] = (min(lo, first[name]), max(hi, r.completed_at))
        elif r.outcome == "bound":
            bound_at[name] = r.completed_at
    for name, labels in labels_of.items():
        g = gang_name_of(labels)
        if g in span and bound[name] not in (None, "evicted"):
            bound_at[name] = span[g][1]
    lat = sorted(bound_at[n] - first[n] for n in bound_at)
    completion = sorted(hi - lo for lo, hi in span.values())
    return lat, completion


def joint_device_ms(inputs: list[tuple]) -> tuple[float | None, list[dict]]:
    """joint_fit's device time per call on the inputs a run gave it, from a
    profiler window of 20 calls per input (after the run's counts were
    read: these launches are not the main path's), and the windows the
    profiler opened."""
    from yoda_tpu_torch.ops import cuda_kernel

    total, seen = 0.0, []
    for args in inputs:
        ms, _per_call, windows = profiled_ms(
            lambda: cuda_kernel.joint_fit(*args), lambda: cuda_kernel.joint_fit_launches,
            kernel="joint_fit", short_ok=True,
        )
        seen += windows
        if ms is None:
            return None, seen
        total += ms
    return (total / len(inputs) if inputs else None), seen


def check_gang_run(g: dict, c: dict) -> None:
    run = g["run"]
    if g["bindings"] != c["bindings"]:
        diff = [p for p in g["bindings"] if g["bindings"][p] != c["bindings"][p]]
        raise AssertionError(
            f"run {run}: {len(diff)} pods bound differently on cuda vs cpu, "
            f"e.g. {diff[:3]}"
        )
    if g["overcommitted"]:
        raise AssertionError(f"run {run}: over-committed {g['overcommitted']}")
    if g["dispatch_errors"]:
        raise AssertionError(f"run {run}: {g['dispatch_errors']} dispatch errors")
    if g["waiting"]:
        raise AssertionError(f"run {run}: {g['waiting']} pods left at Permit")
    for name, v in g["verdicts"].items():
        if v["bound"] not in (0, v["size"]):
            raise AssertionError(f"run {run}: gang {name} split: {v}")
        if v["bound"] and v["kind"] in ("topology", "multislice"):
            want_slices = 1 if v["kind"] == "topology" else 2
            if v["hosts"] != v["size"] or v["slices"] != want_slices:
                raise AssertionError(f"run {run}: gang {name} misplaced: {v}")
    if not 0 < g["fleet_calls"] == g["dispatch_count"]:
        raise AssertionError(
            f"run {run}: {g['fleet_calls']} fleet_eval calls for "
            f"{g['dispatch_count']} dispatches"
        )
    if g["launches"] != g["chunks"]:
        raise AssertionError(
            f"run {run}: {g['launches']} fleet_eval launches for {g['chunks']} chunks"
        )
    if not 0 < g["joint_fit_launches"] == g["fused_plan_dispatches"]:
        raise AssertionError(
            f"run {run}: {g['joint_fit_launches']} joint_fit launches for "
            f"{g['fused_plan_dispatches']} fused dispatches"
        )
    if c["launches"] or c["joint_fit_launches"]:
        raise AssertionError(f"run {run}: the CPU run launched a kernel")
    bound_pods = sum(v is not None for v in g["bindings"].values())
    if run == "c" and bound_pods != g["pods"]:
        raise AssertionError(f"run c: {bound_pods}/{g['pods']} pods bound")
    if run == "d":
        parked = [n for n, v in g["verdicts"].items() if v["bound"] == 0]
        if len(parked) != 1 or g["joint_parked"] < 1 or bound_pods != 48:
            raise AssertionError(
                f"run d: parked {parked}, joint_parked {g['joint_parked']}, "
                f"{bound_pods} bound (want one gang parked, 48 bound)"
            )
        if g["verdicts"][parked[0]]["reserved"]:
            raise AssertionError("run d: the parked gang holds reservations")


def phase_gang_path(smi: str) -> dict:
    out = {}
    for run in ("c", "d"):
        g = run_gang_path("auto", run)
        inputs = g.pop("joint_inputs")
        g["joint_fit_device_ms"], g["joint_fit_profiler_windows"] = joint_device_ms(inputs)
        g["joint_fit_rows"] = [int(args[0].shape[0]) for args in inputs]
        if g["joint_fit_device_ms"] is not None and inputs:
            g["joint_fit_us_per_row"] = (
                1e3 * g["joint_fit_device_ms"] * len(inputs) / sum(g["joint_fit_rows"])
            )
        g["joint_fit_one_block_device_ms_earlier_run"] = ONE_BLOCK_DEVICE_MS[f"run {run}"]
        c = run_gang_path("cpu", run)
        c.pop("joint_inputs")
        summary = {
            k: v for k, v in g.items() if k not in ("bindings", "verdicts")
        }
        print(f"gang path ({run}) cuda [{smi}]:", json.dumps(summary))
        print(
            f"gang path ({run}) cpu plain: bound {c['bound']}/{c['pods']}, "
            f"pods/s {c['pods_per_s']:.1f}, p50 {c['p50_ms']:.2f} ms, "
            f"p99 {c['p99_ms']:.2f} ms, gang p50 {c['gang_p50_ms']:.2f} ms, "
            f"gang p99 {c['gang_p99_ms']:.2f} ms, evaluation {c['eval_s']:.3f} s "
            f"of {c['wall_s']:.3f} s"
        )
        check_gang_run(g, c)
        out[run] = g
    return out


def phase_main_path(smi: str) -> dict:
    pods_a, pods_b = fleet_and_pods(seed=0)
    gpu = run_main_path("auto", pods_a, pods_b)
    cpu = run_main_path("cpu", pods_a, pods_b)
    for run in ("a", "b"):
        g, c = gpu[run], cpu[run]
        summary = {k: v for k, v in g.items() if k not in ("bindings",)}
        print(f"main path ({run}) cuda [{smi}]:", json.dumps(summary))
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


UPDATE_FLEETS = [(5000, 8192), (65536, 65536)]  # (real nodes, padded nodes)
UPDATE_ROWS = [1, 3, 64, 2048]
UPDATE_MAIN_SHAPE = (8192, 64)  # (padded nodes, rows) in the kernels line


def fleet_arrays(chips, nodes, dyn):
    """A FleetArrays host mirror of a :func:`random_fleet` in the device
    layout."""
    from yoda_tpu_torch.ops.arrays import FleetArrays
    from yoda_tpu_torch.ops.kernel import CHIP_KEYS, STATIC_NODE_KEYS

    n_real = int(nodes[0].sum())
    fields = {key: chips[i].T for i, key in enumerate(CHIP_KEYS)}
    fields.update({key: nodes[i] for i, key in enumerate(STATIC_NODE_KEYS)})
    fields.update(
        names=[f"n{i}" for i in range(n_real)], fresh=dyn[0],
        reserved_chips=dyn[1], claimed_hbm_mib=dyn[2], host_ok=dyn[0],
        last_updated=np.zeros(dyn.shape[1]),
    )
    return FleetArrays.from_numpy(fields)


def update_rows_case(n_real: int, r: int, seed: int) -> list[int]:
    """``r`` distinct rows in a ragged (unsorted) order, row 0 and the last
    real row among them when ``r`` allows."""
    rng = np.random.default_rng(seed)
    ends = [0, n_real - 1][:r]
    middle = rng.choice(np.arange(1, n_real - 1), size=r - len(ends), replace=False)
    rows = [int(x) for x in middle] + ends
    return [rows[i] for i in rng.permutation(len(rows))]


def update_bound_ms(r: int, c: int = CHIPS) -> float:
    """Least time for a row update: the rows' payload read once and the
    rows written once, 2 x R x (9 C + 4) int32 words, over the memory
    rate."""
    return 2 * r * (9 * c + 4) * 4 / MEM_BYTES_PER_S * 1e3


def update_rows_check(n_real: int, n_pad: int, r: int, dev: torch.device):
    """One case of the row-update phase: a seeded fleet uploaded whole,
    ``r`` rows (update_rows_case) refilled on the host from another seed
    and applied with TorchFleetKernel.update_rows, then held against a
    fresh put_static of the refilled fleet, tolerance 0. Returns (the
    updated kernel, the fresh one, the refilled arrays, the rows, the
    largest absolute difference between the two)."""
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.ops.kernel import CHIP_KEYS, STATIC_NODE_KEYS, TorchFleetKernel

    weights = SchedulerConfig().effective_weights()
    arrays = fleet_arrays(*random_fleet(n_real, n_pad, seed=n_pad))
    new = fleet_arrays(*random_fleet(n_real, n_pad, seed=n_pad + 1))
    rows = update_rows_case(n_real, r, seed=n_pad + r)
    kern = TorchFleetKernel(weights, dev)
    kern.put_static(arrays)
    before = kern._chips.clone()
    for key in CHIP_KEYS + STATIC_NODE_KEYS:
        getattr(arrays, key)[rows] = getattr(new, key)[rows]
    kern.update_rows(arrays, rows)
    fresh = TorchFleetKernel(weights, dev)
    fresh.put_static(arrays)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    err = max(
        int((kern._chips - fresh._chips).abs().max()),
        int((kern._nodes - fresh._nodes).abs().max()),
    )
    if err:
        raise AssertionError(f"update_rows != put_static at {n_pad} nodes, {r} rows: {err}")
    changed = (kern._chips != before).any(dim=0).any(dim=0).nonzero().flatten()
    if not set(changed.tolist()) <= set(rows):
        raise AssertionError(f"update_rows wrote outside its rows at {n_pad} nodes, {r} rows")
    return kern, fresh, arrays, rows, err


def phase_update_rows() -> list[dict]:
    """TorchFleetKernel.update_rows against a fresh put_static at every
    fleet and row set (update_rows_check), with the times of both and of
    the index_copy_ pair alone on a payload already on the card."""
    from yoda_tpu_torch.ops.kernel import apply_row_update, pack_row_update

    dev = torch.device("cuda", 0)
    out = []
    for n_real, n_pad in UPDATE_FLEETS:
        for r in UPDATE_ROWS:
            kern, fresh, arrays, rows, err = update_rows_check(n_real, n_pad, r, dev)
            payload = torch.from_numpy(pack_row_update(arrays, rows)).to(dev)
            row = dict(
                nodes=n_real, padded=n_pad, rows=r, max_abs_err=err, tolerance=0,
                ms=cuda_ms(lambda: kern.update_rows(arrays, rows)),
                put_static_ms=cuda_ms(lambda: fresh.put_static(arrays), iters=10),
                library_ms=cuda_ms(
                    lambda: apply_row_update(kern._chips, kern._nodes, payload, r)
                ),
                bound_ms=update_bound_ms(r),
            )
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["smi"] = smi_sample()
            out.append(row)
            print("update_rows", json.dumps(row))
    return out


def churn_flip_hosts(b, rng, names: list[str], event: int) -> list[str]:
    """The 4 hosts of a health-flip event: with a live burst set, the even
    ``event``s (counted over events that found a live set) take 4 hosts
    the set does not reference (infeasible for every remaining entry,
    untouched by its ledger: the set is retained) and the odd ones 2
    referenced and 2 unreferenced (the set drops); with none, 4 seeded
    hosts."""
    burst = b._burst
    if burst is None:
        return [names[i] for i in rng.choice(len(names), 4, replace=False)]
    mask = np.zeros(len(burst.names), dtype=bool)
    for e in burst.entries.values():
        mask |= e.result.feasible[: len(burst.names)].astype(bool)
    live = set(names)
    refd = [nm for i, nm in enumerate(burst.names)
            if (mask[i] or nm in burst.consumed) and nm in live]
    unref = [nm for i, nm in enumerate(burst.names)
             if not mask[i] and nm not in burst.consumed and nm in live]
    take_ref = 0 if event % 2 == 0 else min(2, len(refd))
    take_unref = min(4 - take_ref, len(unref))
    pick = [refd[i] for i in rng.choice(len(refd), take_ref, replace=False)]
    pick += [unref[i] for i in rng.choice(len(unref), take_unref, replace=False)]
    return pick


def run_churn(platform: str, pods, *, classic: bool = False) -> dict:
    """Run (e): ``pods`` singletons at batch_requests 16 on the 5,000-node
    fleet, drained loop turn by loop turn and cycle by cycle. Between loop
    turns the agent republishes every host bound during the turn (a
    value-changing CR: the bound pod's HBM is now charged); every 8th
    cycle it flips one chip's health on 4 hosts (churn_flip_hosts); at
    the first turn boundary past half the pods it removes one idle v5e
    host (a structural delta). A republish of a bound host lands between
    turns because mid-turn it would always drop the live burst set (the
    host is in its ledger), leaving the retention branch unreachable.
    ``classic`` unsets the four delta feeds after build_stack: the classic
    per-version refresh, for comparison only."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod
    from yoda_tpu_torch.ops.arrays import FleetArrays
    from yoda_tpu_torch.ops.kernel import stack_static

    stack, agent = build_fleet(platform, 16)
    b, inf = stack.batch, stack.informer
    if classic:
        b.changes_fn = b.reserved_delta_fn = None
        b.claimed_delta_fn = b.admission_changes_fn = None
    for name, labels in pods:
        stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
    names = sorted(t.name for t in stack.cluster.list_tpu_metrics())
    timers: dict[str, list[float]] = {"eval": [], "dyn": [], "admission": [], "refresh": []}

    def timed(key, inner):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return inner(*args, **kw)
            finally:
                timers[key].append(time.perf_counter() - t)
        return call

    b._kern.evaluate_burst = timed("eval", b._kern.evaluate_burst)
    b._dyn_for = timed("dyn", b._dyn_for)
    b._admission_vec = timed("admission", b._admission_vec)
    b._refresh_static = timed("refresh", b._refresh_static)
    rng = np.random.default_rng(7)
    sched, queue = stack.scheduler, stack.scheduler.queue
    state = dict(cycle=0, flips=0, live_flips=0, republishes=0, expected_rows=0,
                 syncs=(0, 0))
    pending: set[str] = set()   # hosts changed since the last sync
    delta_ms: list[float] = []
    first_restack_ms = None
    removed = None

    def publish(host: str) -> None:
        before = inf.metrics_version
        agent.refresh(host)
        if inf.metrics_version != before:
            pending.add(host)
            state["republishes"] += 1

    def note_sync() -> None:
        nonlocal first_restack_ms
        r = b._resident
        if r is None:
            return
        if first_restack_ms is None and r.restacks:
            first_restack_ms = r.last_restack_ms
        syncs = (r.delta_syncs, r.restacks)
        if syncs == state["syncs"]:
            return
        if r.restacks != state["syncs"][1]:
            pending.clear()  # the re-stack absorbed them
        else:
            state["expected_rows"] += len(pending)
            pending.clear()
            delta_ms.append(r.last_delta_ms)
        state["syncs"] = syncs

    def bound_hosts() -> set:
        return {p.node_name for p in stack.cluster.list_pods() if p.node_name}

    cuda_kernel.launches = kernel_mod.row_update_launches = 0
    seen, bound_at_retry = bound_hosts(), -1
    t0 = time.monotonic()
    while True:
        for host in sorted(bound_hosts() - seen):
            publish(host)
        seen = bound_hosts()
        n_bound = sum(1 for p in stack.cluster.list_pods() if p.node_name)
        if removed is None and n_bound >= len(pods) // 2:
            removed = next(
                nm for nm in names if nm.startswith("v5e")
                and stack.accountant.chips_in_use(nm) == 0 and nm not in seen
            )
            agent.remove_host(removed)
            names.remove(removed)
        qpi = queue.pop(timeout=0)
        if qpi is None:
            if not queue.pending_retry_count() or n_bound == bound_at_retry:
                break
            bound_at_retry = n_bound
            queue.move_all_to_active(force=True)
            continue
        batch = sched._pop_batch(qpi)
        note_sync()
        for q in batch:
            sched.schedule_one(q)
            note_sync()
            state["cycle"] += 1
            if state["cycle"] % 8 == 0:
                live = b._burst is not None
                for host in churn_flip_hosts(b, rng, names, state["live_flips"]):
                    chip = int(rng.integers(0, 4))
                    h = agent._hosts[host]
                    agent.set_chip_health(host, chip, chip in h.unhealthy)
                    publish(host)
                state["flips"] += 1
                state["live_flips"] += live
    if platform != "cpu":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, row_launches = cuda_kernel.launches, kernel_mod.row_update_launches
    bindings = {name: stack.cluster.get_pod(f"default/{name}").node_name for name, _ in pods}
    lat = sorted(r.latency_s for r in sched.stats.results if r.outcome == "bound")
    # Against every chip of a host: a health flip may take a chip out from
    # under a pod that is already running there.
    capacity = {t.name: len(t.chips) for t in stack.cluster.list_tpu_metrics()}
    over = [h for h, cap in capacity.items() if stack.accountant.chips_in_use(h) > cap]
    out = dict(
        platform=platform, classic=classic, pods=len(pods),
        bound=sum(v is not None for v in bindings.values()), bindings=bindings,
        overcommitted=over, cycles=state["cycle"], flip_events=state["flips"],
        live_set_flip_events=state["live_flips"],
        republishes=state["republishes"], removed_host=removed,
        launches=launches, row_update_launches=row_launches,
        dispatch_count=b.dispatch_count, burst_dispatches=b.burst_dispatches,
        burst_served=b.burst_served, burst_invalidated=b.burst_invalidated,
        sets_retained=b.sets_retained, restacks=b.restacks,
        dispatch_errors=b.dispatch_errors,
        admission_reuse=b.admission_reuse, admission_patched=b.admission_patched,
        admission_rebuilds=b.admission_rebuilds,
        wall_s=wall, pods_per_s=len(lat) / wall if wall else 0.0,
        p50_ms=1e3 * lat[len(lat) // 2] if lat else None,
        p99_ms=1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else None,
        eval_ms_per_call=1e3 * statistics.mean(timers["eval"]) if timers["eval"] else None,
        refresh_ms_per_call=1e3 * statistics.mean(timers["refresh"]),
        dyn_ms_per_dispatch=1e3 * sum(timers["dyn"]) / max(b.dispatch_count, 1),
        admission_ms_per_dispatch=1e3 * sum(timers["admission"]) / max(b.dispatch_count, 1),
    )
    r = b._resident
    if r is not None:
        out.update(
            delta_syncs=r.delta_syncs, rows_applied=r.rows_applied,
            expected_rows=state["expected_rows"],
            delta_sync_ms_median=statistics.median(delta_ms) if delta_ms else None,
            first_restack_ms=first_restack_ms, last_restack_ms=r.last_restack_ms,
        )
        # One closing sync brings the resident state to the final snapshot;
        # it must equal a cold lowering and upload of that snapshot.
        snap = inf.snapshot()
        b._refresh_static(snap)
        chips, nodes = stack_static(FleetArrays.from_snapshot(snap))
        out["resident_equals_cold"] = bool(
            torch.equal(b._kern._chips.cpu(), torch.from_numpy(chips))
            and torch.equal(b._kern._nodes.cpu(), torch.from_numpy(nodes))
        )
    return out


def check_churn(g: dict, c: dict) -> None:
    if g["bound"] != g["pods"]:
        raise AssertionError(f"run e: {g['bound']}/{g['pods']} pods bound")
    if g["bindings"] != c["bindings"]:
        diff = [p for p in g["bindings"] if g["bindings"][p] != c["bindings"][p]]
        raise AssertionError(f"run e: {len(diff)} pods bound differently on cuda vs cpu")
    for run in (g, c):
        name = f"run e ({run['platform']})"
        if run["overcommitted"]:
            raise AssertionError(f"{name}: over-committed {run['overcommitted']}")
        if run["restacks"] != 2:
            raise AssertionError(f"{name}: {run['restacks']} re-stacks, want 2")
        if not run["delta_syncs"] or run["rows_applied"] != run["expected_rows"]:
            raise AssertionError(
                f"{name}: {run['delta_syncs']} delta syncs, {run['rows_applied']} rows "
                f"applied for {run['expected_rows']} value-changing republishes"
            )
        if not (run["sets_retained"] > 0 and run["burst_invalidated"] > 0):
            raise AssertionError(
                f"{name}: sets_retained {run['sets_retained']}, burst_invalidated "
                f"{run['burst_invalidated']} (want both branches of _retain_set)"
            )
        if run["dispatch_errors"]:
            raise AssertionError(f"{name}: {run['dispatch_errors']} dispatch errors")
        if not run["resident_equals_cold"]:
            raise AssertionError(f"{name}: resident tensors != cold put_static")
    if not 0 < g["launches"] == g["dispatch_count"]:
        raise AssertionError(
            f"run e: {g['launches']} fleet_eval launches for {g['dispatch_count']} dispatches"
        )
    if g["row_update_launches"] != g["delta_syncs"]:
        raise AssertionError(
            f"run e: {g['row_update_launches']} row updates for {g['delta_syncs']} delta syncs"
        )
    if c["launches"] or c["row_update_launches"]:
        raise AssertionError("run e: the CPU run launched on the card")


def phase_churn(smi: str) -> dict:
    pods = fleet_and_pods(seed=2)[1]  # 256 singletons, drawn as run (b)'s
    g = run_churn("auto", pods)
    c = run_churn("cpu", pods)
    classic = run_churn("auto", pods, classic=True)
    for run in (g, c, classic):
        summary = {k: v for k, v in run.items() if k != "bindings"}
        print(f"churn (e) {run['platform']}{' classic' if run['classic'] else ''} [{smi}]:",
              json.dumps(summary))
    check_churn(g, c)
    return g


# Run (f)'s pools on the 5,000-node fleet: 64 v5e hosts (512 chips) and 4
# v5p-32 slices (16 hosts x 4 chips).
MIXED_E = [f"v5e-{h * 41:04d}" for h in range(64)]
MIXED_P = [f"v5p-{s * 128:03d}-{i}" for s in range(4) for i in range(4)]


def preemption_script():
    """Run (f)'s two waves of (name, labels, pool) and its gangs (name ->
    (kind, size)). Wave 1 (priority 1) fills both pools exactly; wave 2
    needs 40 of the 64 v5e hosts whole and 2 of the 4 slices."""
    wave1 = [(f"inf-e{i:03d}", {"tpu/chips": "2", "tpu/priority": "1"}, "mixed-e")
             for i in range(256)]
    wave1 += [(f"inf-p{i:02d}", {"tpu/chips": "4", "tpu/priority": "1"}, "mixed-p")
              for i in range(16)]
    gangs: dict[str, tuple[str, int]] = {}
    wave2 = []
    for g in range(2):
        gangs[f"train{g}"] = ("plain", 16)
        wave2 += [(f"train{g}-{m:02d}", {
            "tpu/gang": f"train{g}", "tpu/gang-size": "16", "tpu/chips": "8",
            "tpu/priority": "100"}, "mixed-e") for m in range(16)]
    wave2 += [(f"solo{i}", {"tpu/chips": "8", "tpu/priority": "50"}, "mixed-e")
              for i in range(8)]
    for g in range(2):
        gangs[f"topo{g}"] = ("topology", 4)
        wave2 += [(f"topo{g}-{m}", {
            "tpu/gang": f"topo{g}", "tpu/topology": "2x2x1", "tpu/chips": "4",
            "tpu/priority": "100"}, "mixed-p") for m in range(4)]
    return [wave1, wave2], gangs


def run_preemption(platform: str) -> dict:
    """Run (f) on one kernel_platform: wave 1, the agent republishing every
    bound host (their usage becomes metrics-visible: delta syncs), then
    wave 2, timed. Bindings (evictions included), counters and wave 2's
    latencies."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod

    pools = {h: "mixed-e" for h in MIXED_E} | {h: "mixed-p" for h in MIXED_P}
    stack, agent = build_fleet(platform, 16, pools=pools)
    waves, gangs = preemption_script()
    plugin = stack.preemption
    post_filter_ms: list[float] = []
    fleet_calls: list[int] = []
    inner_post_filter, real_fleet_eval = plugin.post_filter, cuda_kernel.fleet_eval

    def timed_post_filter(*args, **kw):
        t = time.perf_counter()
        try:
            return inner_post_filter(*args, **kw)
        finally:
            post_filter_ms.append(1e3 * (time.perf_counter() - t))

    def counted_fleet_eval(*args, **kw):
        fleet_calls.append(args[4].shape[0])
        return real_fleet_eval(*args, **kw)

    plugin.post_filter = timed_post_filter
    cuda_kernel.fleet_eval = counted_fleet_eval
    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    kernel_mod.row_update_launches = 0
    try:
        for name, labels, pool in waves[0]:
            stack.cluster.create_pod(
                PodSpec(name, labels=dict(labels), node_selector={"pool": pool})
            )
        stack.scheduler.run_until_idle(max_wall_s=300)
        for host in sorted({p.node_name for p in stack.cluster.list_pods() if p.node_name}):
            agent.refresh(host)
        first_wave2 = len(stack.scheduler.stats.results)
        t0 = time.monotonic()
        for name, labels, pool in waves[1]:
            stack.cluster.create_pod(
                PodSpec(name, labels=dict(labels), node_selector={"pool": pool})
            )
        stack.scheduler.run_until_idle(max_wall_s=300)
        if platform != "cpu":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        cuda_kernel.fleet_eval = real_fleet_eval
    pods = [name for wave in waves for name, _, _ in wave]
    bound = bindings_of(stack, pods)
    wave2 = {name: labels for name, labels, _ in waves[1]}
    lat, completion = bind_latencies(
        stack.scheduler.stats.results[first_wave2:], wave2, bound
    )
    capacity = {
        t.name: sum(c.healthy for c in t.chips) for t in stack.cluster.list_tpu_metrics()
    }
    slice_of = {t.name: t.slice_id for t in stack.cluster.list_tpu_metrics()}
    verdicts = {}
    for g, (kind, size) in gangs.items():
        nodes = [bound[n] for n in pods if n.startswith(f"{g}-")]
        placed = [x for x in nodes if x not in (None, "evicted")]
        verdicts[g] = dict(kind=kind, size=size, bound=len(placed), hosts=len(set(placed)),
                           slices=len({slice_of[x] for x in placed}))
    b, r = stack.batch, stack.batch._resident
    return dict(
        platform=platform, pods=len(pods), bindings=bound, verdicts=verdicts,
        wave2_bound=sum(bound[n] not in (None, "evicted") for n in wave2),
        evicted=sorted(n for n, v in bound.items() if v == "evicted"),
        preempted_total=plugin.preempted_total,
        nominations=stack.scheduler.stats.preempt_nominations,
        nominated={p.name: p.nominated_node_name for p in stack.cluster.list_pods()
                   if p.nominated_node_name},
        overcommitted=[h for h, c in capacity.items() if stack.accountant.chips_in_use(h) > c],
        waiting=len(stack.framework.waiting_pods()),
        launches=cuda_kernel.launches, fleet_calls=len(fleet_calls),
        chunks=sum(-(-k // cuda_kernel.MAX_REQUESTS) for k in fleet_calls),
        joint_fit_launches=cuda_kernel.joint_fit_launches,
        row_update_launches=kernel_mod.row_update_launches,
        **{c: getattr(b, c) for c in GANG_COUNTERS},
        restacks=b.restacks, delta_syncs=r.delta_syncs, rows_applied=r.rows_applied,
        post_filter_calls=len(post_filter_ms),
        post_filter_ms_median=statistics.median(post_filter_ms) if post_filter_ms else None,
        post_filter_ms_max=max(post_filter_ms, default=None),
        wall_s=wall, pods_per_s=len(lat) / wall if wall else 0.0,
        p50_ms=pct_ms(lat, 0.5), p99_ms=pct_ms(lat, 0.99),
        gang_p50_ms=pct_ms(completion, 0.5), gang_p99_ms=pct_ms(completion, 0.99),
    )


PREEMPTION_PARITY = (
    "bindings", "evicted", "preempted_total", "nominations", "nominated", "restacks",
    "delta_syncs", "rows_applied", "dispatch_count", "joint_parked",
)


def check_preemption(g: dict, c: dict) -> None:
    diff = {k: (g[k], c[k]) for k in PREEMPTION_PARITY if g[k] != c[k]}
    if diff:
        short = {k: v if k != "bindings" else "differ" for k, v in diff.items()}
        raise AssertionError(f"run f: cuda != cpu in {short}")
    for run in (g, c):
        name = f"run f ({run['platform']})"
        if run["overcommitted"]:
            raise AssertionError(f"{name}: over-committed {run['overcommitted']}")
        if run["waiting"] or run["dispatch_errors"]:
            raise AssertionError(f"{name}: {run['waiting']} left at Permit, "
                                 f"{run['dispatch_errors']} dispatch errors")
        if run["wave2_bound"] != 48:
            raise AssertionError(f"{name}: {run['wave2_bound']}/48 wave-2 pods bound")
        if run["preempted_total"] != len(run["evicted"]) or not run["evicted"]:
            raise AssertionError(
                f"{name}: {run['preempted_total']} evictions counted, "
                f"{len(run['evicted'])} pods gone"
            )
        if any(not n.startswith("inf-") for n in run["evicted"]):
            raise AssertionError(f"{name}: a wave-2 pod was evicted: {run['evicted']}")
        if not run["nominations"] or run["restacks"] != 1 or not run["delta_syncs"]:
            raise AssertionError(
                f"{name}: nominations {run['nominations']}, restacks "
                f"{run['restacks']}, delta syncs {run['delta_syncs']} (want > 0, 1, > 0)"
            )
        for gang, v in run["verdicts"].items():
            if v["bound"] != v["size"] or (
                v["kind"] == "topology" and (v["hosts"] != 4 or v["slices"] != 1)
            ):
                raise AssertionError(f"{name}: gang {gang} not placed whole: {v}")
    if not 0 < g["launches"] == g["chunks"] or g["fleet_calls"] != g["dispatch_count"]:
        raise AssertionError(
            f"run f: {g['launches']} fleet_eval launches for {g['chunks']} chunks "
            f"of {g['fleet_calls']} calls, {g['dispatch_count']} dispatches"
        )
    if g["joint_fit_launches"] != g["fused_plan_dispatches"]:
        raise AssertionError(
            f"run f: {g['joint_fit_launches']} joint_fit launches for "
            f"{g['fused_plan_dispatches']} fused dispatches"
        )
    if g["row_update_launches"] != g["delta_syncs"]:
        raise AssertionError(
            f"run f: {g['row_update_launches']} row updates for {g['delta_syncs']} delta syncs"
        )
    if c["launches"] or c["joint_fit_launches"] or c["row_update_launches"]:
        raise AssertionError("run f: the CPU run launched on the card")


def phase_preemption(smi: str) -> dict:
    g = run_preemption("auto")
    c = run_preemption("cpu")
    for run in (g, c):
        summary = {k: v for k, v in run.items()
                   if k not in ("bindings", "evicted", "nominated", "verdicts")}
        summary["evicted"] = len(run["evicted"])
        print(f"preemption (f) {run['platform']} [{smi}]:", json.dumps(summary))
    check_preemption(g, c)
    return g


# Run (g): inter-pod affinity, topology spread, volumes and budgets on the
# 5,000-node fleet. Four zones: each v5p slice lies wholly in one (128
# slices a zone), the v5e hosts in four contiguous blocks of 738. The
# smaller size is the card tests' copy of the same script.
HOST_KEY = "kubernetes.io/hostname"
ZONE_KEY = "topology.kubernetes.io/zone"
ACCEL_KEY = "cloud.google.com/gke-tpu-accelerator"
V5E_ACCEL = "tpu-v5-lite-podslice"
CSI_DRIVER = "pd.csi.storage.gke.io"
AFFINITY_FULL = dict(slices=512, v5e_hosts=2952, replicas=48, kv=48, plain=64,
                     ft_a=8, ft_b=8, team_b=4, zonal=16, wffc=4, rwo=4, pool=32)
AFFINITY_SMALL = dict(slices=16, v5e_hosts=96, replicas=12, kv=12, plain=16,
                      ft_a=4, ft_b=4, team_b=4, zonal=8, wffc=4, rwo=4, pool=8)


def affinity_layout(size: dict) -> dict:
    """Run (g)'s fleet layout: each host's zone, the mixed-g pool (every
    other pool host's fill pod is budget-protected), the two local-SSD
    hosts of zone 2 with an attach limit of 1, the WaitForFirstConsumer
    claims' selected nodes and the ReadWriteOnce claim's host."""
    slices, v5e = size["slices"], size["v5e_hosts"]
    block = v5e // 4
    zone = {f"v5p-{s:03d}-{i}": s * 4 // slices for s in range(slices) for i in range(4)}
    zone |= {f"v5e-{h:04d}": min(h // block, 3) for h in range(v5e)}
    pool = [f"v5e-{i * v5e // size['pool'] + 7:04d}" for i in range(size["pool"])]
    return dict(
        zone=zone, pool=pool,
        ssd=[f"v5e-{2 * block + 5:04d}", f"v5e-{2 * block + 11:04d}"],
        wffc=[f"v5e-{(i % 4) * block + block // 2 + i:04d}" for i in range(size["wffc"])],
        rwo_host=f"v5e-{block + 30:04d}",
    )


def affinity_script(size: dict):
    """Run (g)'s objects: (Node objects by host, Namespaces, claims and
    volumes, the bound ReadWriteOnce holder, wave 1's pods, wave 2's fill,
    the budget, the preempting gang and the singleton). Everything in the
    port's own types."""
    from yoda_tpu_torch.api.affinity import (
        LabelSelector,
        PodAffinityTerm,
        TopologySpreadConstraint,
    )
    from yoda_tpu_torch.api.types import (
        K8sNamespace,
        K8sNode,
        K8sPdb,
        K8sPv,
        K8sPvc,
        NodeSelectorRequirement,
        NodeSelectorTerm,
        PodSpec,
        Taint,
        Toleration,
    )

    lay = affinity_layout(size)
    pool, ssd = set(lay["pool"]), set(lay["ssd"])

    def node(name: str):
        labels = {HOST_KEY: name, ZONE_KEY: f"zone-{lay['zone'][name]}",
                  ACCEL_KEY: "tpu-v5p-slice" if name.startswith("v5p") else V5E_ACCEL}
        taints, attach = [], {}
        if name in pool:
            labels["pool"] = "mixed-g"
            taints = [Taint("dedicated", "mixed-g", "NoSchedule")]
        if name in ssd:
            labels["storage"] = "local-ssd"
            attach = {f"csi-{CSI_DRIVER}": 1}
        return K8sNode(name, labels=labels, taints=taints, attach_limits=attach)

    def sel(**labels):
        return LabelSelector(match_labels=tuple(sorted(labels.items())))

    def zone_term(z: str):
        return NodeSelectorTerm(match_expressions=(NodeSelectorRequirement(ZONE_KEY, "In", (z,)),))

    v5e = {ACCEL_KEY: V5E_ACCEL}
    namespaces = [K8sNamespace("default", {"tier": "serving"}),
                  K8sNamespace("team-b", {"tier": "research"})]
    # Wave 1 in creation (and so queue) order: the volume pods, then the
    # plain singletons (bursts, while no bound pod declares terms), then
    # the serving replicas, their caches, team-b's pods and the two gangs.
    volumes, vol_pods, wave1 = [], [], []
    for name, labels in fleet_and_pods(seed=3)[0][: size["plain"]]:
        wave1.append(PodSpec(f"g-{name}", labels=dict(labels)))
    serve = sel(app="llm-serve")
    for i in range(size["replicas"]):
        wave1.append(PodSpec(
            f"llm-serve-{i:02d}", node_selector=dict(v5e),
            labels={"app": "llm-serve", "pod-template-hash": "5d8c7b9f4", "tpu/chips": "4"},
            pod_anti_affinity=(PodAffinityTerm(HOST_KEY, serve),),
            topology_spread=(TopologySpreadConstraint(
                1, ZONE_KEY, "DoNotSchedule", serve, ("pod-template-hash",)),),
        ))
    for i in range(size["kv"]):
        wave1.append(PodSpec(
            f"kv-cache-{i:02d}", node_selector=dict(v5e),
            labels={"app": "kv-cache", "tpu/chips": "2"},
            preferred_pod_affinity=((100, PodAffinityTerm(HOST_KEY, serve)),),
        ))
    for i in range(size["team_b"]):
        wave1.append(PodSpec(
            f"eval-{i}", namespace="team-b", labels={"app": "eval", "tpu/chips": "2"},
            pod_affinity=(PodAffinityTerm(
                ZONE_KEY, serve, namespace_selector=sel(tier="serving")),),
        ))
    for gang, n, chips, term in (
        ("ft-a", size["ft_a"], "4", "anti"), ("ft-b", size["ft_b"], "8", "aff"),
    ):
        own = PodAffinityTerm(HOST_KEY if term == "anti" else ZONE_KEY, sel(app=gang))
        for m in range(n):
            wave1.append(PodSpec(
                f"{gang}-{m}",
                labels={"app": gang, "tpu/gang": gang, "tpu/gang-size": str(n),
                        "tpu/chips": chips},
                pod_anti_affinity=(own,) if term == "anti" else (),
                pod_affinity=(own,) if term == "aff" else (),
            ))
    for i in range(size["zonal"]):
        z = f"zone-{i % 4}"
        volumes += [
            K8sPv(f"pv-zonal-{i}", node_affinity=(zone_term(z),),
                  claim_ref=f"default/zonal-{i}", driver=CSI_DRIVER),
            K8sPvc(f"zonal-{i}", zone=z, access_modes=("ReadWriteOnce",),
                   volume_name=f"pv-zonal-{i}"),
        ]
        prefer_ssd = ()
        if z == "zone-2":
            prefer_ssd = ((100, NodeSelectorTerm(match_expressions=(
                NodeSelectorRequirement("storage", "In", ("local-ssd",)),))),)
        vol_pods.append(PodSpec(f"vol-zonal-{i:02d}", labels={"tpu/chips": "1"},
                                pvc_names=(f"zonal-{i}",),
                                preferred_node_affinity=prefer_ssd))
    for i, host in enumerate(lay["wffc"]):
        volumes.append(K8sPvc(f"wffc-{i}", selected_node=host,
                              access_modes=("ReadWriteOnce",)))
        vol_pods.append(PodSpec(f"vol-wffc-{i}", labels={"tpu/chips": "2"},
                                pvc_names=(f"wffc-{i}",)))
    volumes.append(K8sPvc("shared-rwo", access_modes=("ReadWriteOnce",)))
    holder = PodSpec("rwo-holder", labels={"tpu/chips": "1"}, pvc_names=("shared-rwo",),
                     node_name=lay["rwo_host"], phase="Running")
    for i in range(size["rwo"]):
        vol_pods.append(PodSpec(f"vol-rwo-{i}", labels={"tpu/chips": "1"},
                                pvc_names=("shared-rwo",)))
    wave1 = vol_pods + wave1
    tolerate = [Toleration("dedicated", "Equal", "mixed-g", "NoSchedule")]
    on_pool = {"pool": "mixed-g"}
    fill = [
        PodSpec(f"fill-{i:02d}", node_selector=dict(on_pool), tolerations=list(tolerate),
                labels={"app": "batch-protected" if i % 2 == 0 else "batch",
                        "tpu/chips": "8", "tpu/priority": "1"})
        for i in range(size["pool"])
    ]
    budget = K8sPdb("batch-protected", selector=sel(app="batch-protected"),
                    disruptions_allowed=0)
    half = size["pool"] // 2
    gang = [
        PodSpec(f"ft-pre-{m:02d}", node_selector=dict(on_pool), tolerations=list(tolerate),
                labels={"tpu/gang": "ft-pre", "tpu/gang-size": str(half),
                        "tpu/chips": "8", "tpu/priority": "100"})
        for m in range(half)
    ]
    solo = PodSpec("solo-50", node_selector=dict(on_pool), tolerations=list(tolerate),
                   labels={"tpu/chips": "8", "tpu/priority": "50"})
    return dict(node=node, namespaces=namespaces, volumes=volumes, holder=holder,
                wave1=wave1, fill=fill, budget=budget, gang=gang, solo=solo, layout=lay)


def run_affinity(platform: str, size: dict = AFFINITY_FULL) -> dict:
    """Run (g) on one kernel_platform: Namespaces, claims, volumes and the
    bound ReadWriteOnce holder, then wave 1 at batch_requests 16 (timed),
    then wave 2 (timed): the pool's fill and its budget, the agent
    republishing every bound host, the priority-100 gang and the
    priority-50 singleton. Bindings, evictions, counters and the host and
    device times the run's affinity pods cost."""
    from yoda_tpu_torch.api import affinity as aff_mod
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod
    from yoda_tpu_torch.plugins.yoda import batch as batch_mod

    script = affinity_script(size)
    stack, agent = build_fleet(platform, 16, node_fn=script["node"], slices=size["slices"],
                               v5e_hosts=size["v5e_hosts"])
    cluster, plugin, b = stack.cluster, stack.preemption, stack.batch
    for ns in script["namespaces"]:
        cluster.put_namespace(ns)
    for obj in script["volumes"]:
        (cluster.put_pv if hasattr(obj, "driver") else cluster.put_pvc)(obj)
    cluster.create_pod(script["holder"])

    times: dict[str, list[float]] = {"evaluators": [], "admission": [], "bonus": [],
                                     "post_filter": []}
    fleet_calls: list[int] = []
    refused: list[str] = []
    k1_args: list = []

    def timed(key, fn, when=lambda *a, **kw: True):
        def wrapper(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                if when(*args, **kw):
                    times[key].append(1e3 * (time.perf_counter() - t))
        return wrapper

    def counted_fleet_eval(*args, **kw):
        fleet_calls.append(args[4].shape[0])
        if args[4].shape[0] == 1 and platform != "cpu":
            k1_args[:] = [a.clone() for a in args[:5]] + [args[5]]
        return real_fleet_eval(*args, **kw)

    def counted_evict(key):
        ok = real_evict(key)
        if ok is False:
            refused.append(key)
        return ok

    builds = {cls: cls.__dict__["build"] for cls in (aff_mod.InterPodEvaluator,
                                                     aff_mod.SpreadEvaluator)}
    real_fleet_eval, real_admission = cuda_kernel.fleet_eval, batch_mod._host_admission
    real_evict = plugin.evict_fn
    for cls, build in builds.items():
        setattr(cls, "build", timed("evaluators", build.__get__(None, cls)))
    batch_mod._host_admission = timed(
        "admission", real_admission, lambda *a, **kw: len(a) > 3 and a[3] is not None)
    b._preference_bonus = timed(
        "bonus", b._preference_bonus, lambda *a, **kw: len(a) > 3 and a[3] is not None)
    plugin.post_filter = timed("post_filter", plugin.post_filter)
    plugin.evict_fn = counted_evict
    cuda_kernel.fleet_eval = counted_fleet_eval
    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    kernel_mod.row_update_launches = 0
    walls = []
    try:
        t0 = time.monotonic()
        for pod in script["wave1"]:
            cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=600)
        walls.append(time.monotonic() - t0)
        first_wave2 = len(stack.scheduler.stats.results)
        t0 = time.monotonic()
        cluster.put_pdb(script["budget"])
        for pod in script["fill"]:
            cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=300)
        for host in sorted({p.node_name for p in cluster.list_pods() if p.node_name}):
            agent.refresh(host)
        for pod in script["gang"]:
            cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=300)
        cluster.create_pod(script["solo"])
        stack.scheduler.run_until_idle(max_wall_s=300)
        if platform != "cpu":
            torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    finally:
        cuda_kernel.fleet_eval = real_fleet_eval
        batch_mod._host_admission = real_admission
        for cls, build in builds.items():
            setattr(cls, "build", build)
    launches = cuda_kernel.launches
    device_k1, windows, k1_ms, k1_plain_ms = None, [], None, None
    if k1_args:
        # The tracer was seen to lose kernel records on this input (16 of
        # 20 in every window, while both counts said 20): the fullest short
        # window gives the time per recorded launch.
        device_k1, _per_call, windows = profiled_ms(
            lambda: cuda_kernel.fleet_eval(*k1_args), lambda: cuda_kernel.launches,
            short_ok=True)
        from yoda_tpu_torch.ops.kernel import kernel_packed_burst

        k1_ms = cuda_ms(lambda: cuda_kernel.fleet_eval(*k1_args))
        cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in k1_args]
        k1_plain_ms = cuda_ms(lambda: kernel_packed_burst(*cpu_args), warmup=1, iters=3)
    waves = {"wave1": script["wave1"],
             "wave2": script["fill"] + script["gang"] + [script["solo"]]}
    pods = [script["holder"]] + waves["wave1"] + waves["wave2"]
    bound = {}
    for p in pods:
        live = cluster.get_pod(p.key)
        bound[p.name] = "evicted" if live is None else live.node_name
    results = stack.scheduler.stats.results
    lat = {}
    for wave, start, end in (("wave1", 0, first_wave2), ("wave2", first_wave2, None)):
        labels_of = {p.name: p.labels for p in waves[wave]}
        lat[wave] = bind_latencies(results[start:end], labels_of, bound)
    capacity = {t.name: sum(c.healthy for c in t.chips) for t in cluster.list_tpu_metrics()}
    snap = stack.informer.snapshot()
    r = b._resident

    def ms(key):
        xs = times[key]
        return dict(calls=len(xs), median=statistics.median(xs) if xs else None,
                    max=max(xs, default=None))

    out = dict(
        platform=platform, nodes=len(snap), bindings=bound,
        evicted=sorted(n for n, v in bound.items() if v == "evicted"),
        preempted_total=plugin.preempted_total, refused_evictions=len(refused),
        nominations=stack.scheduler.stats.preempt_nominations,
        nominated={p.name: p.nominated_node_name for p in cluster.list_pods()
                   if p.nominated_node_name},
        overcommitted=[h for h, c in capacity.items() if stack.accountant.chips_in_use(h) > c],
        waiting=len(stack.framework.waiting_pods()),
        launches=launches, fleet_calls=len(fleet_calls),
        fleet_calls_k1=sum(k == 1 for k in fleet_calls),
        chunks=sum(-(-k // cuda_kernel.MAX_REQUESTS) for k in fleet_calls),
        joint_fit_launches=cuda_kernel.joint_fit_launches,
        row_update_launches=kernel_mod.row_update_launches,
        **{c: getattr(b, c) for c in GANG_COUNTERS},
        restacks=b.restacks, delta_syncs=r.delta_syncs, rows_applied=r.rows_applied,
        admission_reuse=b.admission_reuse, admission_rebuilds=b.admission_rebuilds,
        evaluator_build_ms=ms("evaluators"), admission_row_with_aff_ms=ms("admission"),
        preference_bonus_ms=ms("bonus"), post_filter_ms=ms("post_filter"),
        fleet_eval_k1_device_ms=device_k1, fleet_eval_k1_profiler_windows=windows,
        fleet_eval_k1_ms=k1_ms, fleet_eval_k1_plain_ms=k1_plain_ms,
        not_built=list(stack.not_built),
    )
    for wave, wall in zip(("wave1", "wave2"), walls):
        per_pod, gangs = lat[wave]
        out[wave] = dict(wall_s=wall, pods=len(waves[wave]),
                         pods_per_s=len(per_pod) / wall if wall else 0.0,
                         p50_ms=pct_ms(per_pod, 0.5), p99_ms=pct_ms(per_pod, 0.99),
                         gang_p50_ms=pct_ms(gangs, 0.5), gang_p99_ms=pct_ms(gangs, 0.99))
    out["checks"] = affinity_checks(stack, snap, script, bound)
    return out


def affinity_checks(stack, snap, script, bound) -> dict:
    """Run (g)'s placement facts, read off one run's final state."""
    from yoda_tpu_torch.plugins.yoda.filter_plugin import (
        node_fits_attach_limits,
        node_fits_volumes,
        resolve_volumes,
    )

    lay = script["layout"]
    zone_of = {h: f"zone-{z}" for h, z in lay["zone"].items()}

    def placed(prefix):
        return [v for n, v in bound.items() if n.startswith(prefix)]

    serve = placed("llm-serve-")
    per_zone = [sum(zone_of.get(h) == f"zone-{z}" for h in serve) for z in range(4)]
    kv_with_serve = sum(h in set(serve) for h in placed("kv-cache-"))
    volume_misplaced, attach_over = [], []
    for ni in snap.infos():
        for p in ni.pods:
            if p.pvc_names and p.name != "rwo-holder":
                claims, missing = resolve_volumes(snap, p)
                # A pod's own ReadWriteOnce claim pins it to where it (and
                # its co-users) mount it: checked below by name.
                claims = [c for c in claims if c.allowed_nodes is None]
                if missing is not None or not node_fits_volumes(claims, ni)[0]:
                    volume_misplaced.append(p.name)
        if not node_fits_attach_limits((), ni, snap.pvcs or {}, snap.pvs or {})[0]:
            attach_over.append(ni.name)
    if any(h != lay["rwo_host"] for h in placed("vol-rwo-")):
        volume_misplaced.append("vol-rwo")
    if any(bound[f"vol-wffc-{i}"] != h for i, h in enumerate(lay["wffc"])):
        volume_misplaced.append("vol-wffc")
    wave1 = [p.name for p in script["wave1"]]
    eval_zones = {zone_of.get(h) for h in placed("eval-")}
    return dict(
        wave1_unbound=[n for n in wave1 if bound[n] in (None, "evicted")],
        serve_hosts_distinct=len(set(serve)) == len(serve),
        serve_per_zone=per_zone, serve_skew=max(per_zone) - min(per_zone),
        kv_cache_beside_serve=kv_with_serve,
        eval_in_serve_zones=eval_zones <= {zone_of.get(h) for h in serve},
        ft_a_hosts=len(set(placed("ft-a-"))), ft_b_zones=len({zone_of.get(h) for h in placed("ft-b-")}),
        ssd_hosts_used=sorted(set(placed("vol-zonal-")) & set(lay["ssd"])),
        volume_misplaced=volume_misplaced, attach_over=attach_over,
        protected_evicted=[n for n in bound if bound[n] == "evicted"
                           and n.startswith("fill-") and int(n[5:]) % 2 == 0],
        gang_bound=sum(h not in (None, "evicted") for h in placed("ft-pre-")),
        gang_on_pool=all(h in set(lay["pool"]) for h in placed("ft-pre-")),
        solo=bound["solo-50"],
    )


AFFINITY_PARITY = (
    "bindings", "evicted", "preempted_total", "refused_evictions", "nominations",
    "nominated", "dispatch_count", "burst_dispatches", "burst_served", "restacks",
    "delta_syncs", "rows_applied", "joint_parked", "checks",
)


def check_affinity_run(run: dict, size: dict) -> None:
    """Run (g)'s invariants on one platform's run."""
    name, c = f"run g ({run['platform']})", run["checks"]
    want_gang = size["pool"] // 2
    failures = []
    if run["overcommitted"]:
        failures.append(f"over-committed {run['overcommitted']}")
    if run["waiting"] or run["dispatch_errors"]:
        failures.append(f"{run['waiting']} left at Permit, {run['dispatch_errors']} errors")
    if c["wave1_unbound"]:
        failures.append(f"wave 1 left unbound: {c['wave1_unbound']}")
    if not c["serve_hosts_distinct"] or c["serve_skew"] > 1:
        failures.append(f"llm-serve replicas share a host or skew: {c['serve_per_zone']}")
    if not c["eval_in_serve_zones"]:
        failures.append("a team-b pod sits in a zone without an llm-serve replica")
    if c["ft_a_hosts"] != size["ft_a"] or c["ft_b_zones"] != 1:
        failures.append(f"ft-a on {c['ft_a_hosts']} hosts, ft-b in {c['ft_b_zones']} zones")
    if c["volume_misplaced"] or c["attach_over"]:
        failures.append(f"volumes misplaced {c['volume_misplaced']}, "
                        f"attach limits exceeded on {c['attach_over']}")
    if c["protected_evicted"]:
        failures.append(f"budget-protected pods evicted: {c['protected_evicted']}")
    if c["gang_bound"] != want_gang or not c["gang_on_pool"]:
        failures.append(f"preempting gang: {c['gang_bound']}/{want_gang} bound")
    if run["preempted_total"] != want_gang or len(run["evicted"]) != want_gang:
        failures.append(f"{run['preempted_total']} evictions, {len(run['evicted'])} pods gone "
                        f"(want {want_gang})")
    if c["solo"] is not None or not run["refused_evictions"]:
        failures.append(f"solo-50 on {c['solo']}, {run['refused_evictions']} refused evictions")
    if failures:
        raise AssertionError(f"{name}: " + "; ".join(failures))


def check_affinity(g: dict, c: dict, size: dict) -> None:
    diff = {k: (g[k], c[k]) for k in AFFINITY_PARITY if g[k] != c[k]}
    if diff:
        short = {k: v if k != "bindings" else "differ" for k, v in diff.items()}
        raise AssertionError(f"run g: cuda != cpu in {short}")
    for run in (g, c):
        check_affinity_run(run, size)
    if not 0 < g["launches"] == g["chunks"] or g["fleet_calls"] != g["dispatch_count"]:
        raise AssertionError(
            f"run g: {g['launches']} fleet_eval launches for {g['chunks']} chunks "
            f"of {g['fleet_calls']} calls, {g['dispatch_count']} dispatches"
        )
    if g["joint_fit_launches"] != g["fused_plan_dispatches"]:
        raise AssertionError(
            f"run g: {g['joint_fit_launches']} joint_fit launches for "
            f"{g['fused_plan_dispatches']} fused dispatches"
        )
    if g["row_update_launches"] != g["delta_syncs"]:
        raise AssertionError(
            f"run g: {g['row_update_launches']} row updates for {g['delta_syncs']} delta syncs"
        )
    if c["launches"] or c["joint_fit_launches"] or c["row_update_launches"]:
        raise AssertionError("run g: the CPU run launched on the card")


def phase_affinity(smi: str) -> dict:
    g = run_affinity("auto")
    c = run_affinity("cpu")
    for run in (g, c):
        summary = {k: v for k, v in run.items()
                   if k not in ("bindings", "evicted", "nominated")}
        summary["evicted"] = len(run["evicted"])
        print(f"affinity (g) {run['platform']} [{smi}]:", json.dumps(summary))
    check_affinity(g, c, AFFINITY_FULL)
    return g


def wide_fleet_script(seed: int = 5):
    """A fleet of 16 hosts of 40 chips (the lowering pads every node to 64)
    and 48 of 8, and 96 singletons of 1-32 chips, some with HBM or clock
    floors."""
    rng = np.random.default_rng(seed)
    hosts = [(f"big-{h:02d}", 40) for h in range(16)] + [(f"v5e-{h:02d}", 8) for h in range(48)]
    pods = []
    for i in range(96):
        labels = {"tpu/chips": str(int(rng.choice([1, 2, 4, 8, 16, 32])))}
        if rng.random() < 0.5:
            labels["tpu/hbm"] = f"{int(rng.integers(1, 16))}Gi"
        if rng.random() < 0.2:
            labels["tpu/clock"] = "900"
        pods.append((f"w{i:02d}", labels))
    return hosts, pods


def run_wide_fleet(platform: str, burst: int) -> dict:
    """The wide fleet's singletons through build_stack on one platform:
    bindings, launches and dispatches."""
    from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.standalone import build_stack

    stack = build_stack(
        config=SchedulerConfig(kernel_platform=platform, batch_requests=burst)
    )
    agent = FakeTpuAgent(stack.cluster)
    hosts, pods = wide_fleet_script()
    for name, chips in hosts:
        agent.add_host(name, generation="v5e", chips=chips)
    agent.publish_all()
    for name, labels in pods:
        stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
    cuda_kernel.launches = 0
    stack.scheduler.run_until_idle(max_wall_s=120)
    if platform != "cpu":
        torch.cuda.synchronize()
    b = stack.batch
    return dict(
        platform=platform, burst=burst, chip_bucket=int(b._static.hbm_free_mib.shape[1]),
        bindings=bindings_of(stack, [n for n, _ in pods]),
        launches=cuda_kernel.launches, dispatch_count=b.dispatch_count,
        dispatch_errors=b.dispatch_errors,
    )


def phase_wide_fleet(smi: str) -> list[dict]:
    """The 40-chip stack check: bindings on the card equal the CPU run's,
    every evaluation launched the wide kernel."""
    out = []
    for burst in (1, 16):
        g, c = run_wide_fleet("auto", burst), run_wide_fleet("cpu", burst)
        bound = sum(v is not None for v in g["bindings"].values())
        print(f"wide fleet (40 + 8 chips, K = {burst}) [{smi}]:", json.dumps(
            {k: v for k, v in g.items() if k != "bindings"} | {"bound": bound}))
        if g["bindings"] != c["bindings"]:
            diff = [p for p in g["bindings"] if g["bindings"][p] != c["bindings"][p]]
            raise AssertionError(f"wide fleet: {len(diff)} pods bound differently, e.g. {diff[:3]}")
        if g["chip_bucket"] != 64 or not 0 < bound < len(g["bindings"]):
            raise AssertionError(f"wide fleet: bucket {g['chip_bucket']}, {bound} bound")
        if g["dispatch_errors"] or not 0 < g["launches"] == g["dispatch_count"]:
            raise AssertionError(
                f"wide fleet: {g['launches']} launches for {g['dispatch_count']} "
                f"dispatches, {g['dispatch_errors']} errors"
            )
        if c["launches"]:
            raise AssertionError("wide fleet: the CPU run launched the kernel")
        out.append(g)
    return out


# Run (h): the background path on the 5,000-node fleet — the speculative
# placement cache, the rebalancer, the reconciler, and all of them on a
# second thread while the serve loop runs. The smaller size is the tests'
# copy of the same script.
BACKGROUND_FULL = dict(slices=512, v5e_hosts=2952, waves=16, wave=16, pool=64,
                       frag_slices=4, gang=16, threaded_pods=256, threaded_s=8.0,
                       period_s=1.0)
BACKGROUND_SMALL = dict(slices=16, v5e_hosts=96, waves=4, wave=8, pool=24,
                        frag_slices=4, gang=4, threaded_pods=32, threaded_s=1.0,
                        period_s=0.1)
# (h1)'s four hot shapes: v5e pods of 1, 2, 4 and 8 chips.
HOT_SHAPES = (1, 2, 4, 8)


def hot_pod(name: str, chips: int):
    from yoda_tpu_torch.api.types import PodSpec

    return PodSpec(name, labels={"tpu/chips": str(chips), "tpu/generation": "v5e"})


def singleton_latencies(stack, names: "list[str]") -> list[float]:
    """Sorted seconds from each bound singleton's first cycle start to its
    bind (bind_latencies over pods without gang labels)."""
    labels = {n: stack.cluster.get_pod(f"default/{n}").labels for n in names}
    return bind_latencies(stack.scheduler.stats.results, labels,
                          bindings_of(stack, names))[0]


def over_capacity(stack) -> list[str]:
    capacity = {
        t.name: sum(c.healthy for c in t.chips) for t in stack.cluster.list_tpu_metrics()
    }
    return [h for h, c in capacity.items() if stack.accountant.chips_in_use(h) > c]


def accounting_gap(stack) -> dict:
    """Nodes whose reserved chips differ from the chips of their bound pods."""
    from yoda_tpu_torch.api.requests import pod_request

    bound: dict[str, int] = {}
    for p in stack.cluster.list_pods():
        if p.node_name:
            bound[p.node_name] = bound.get(p.node_name, 0) + pod_request(p).effective_chips
    held = {n: c for n, c in stack.accountant.chips_by_node().items() if c}
    return {n: (held.get(n, 0), bound.get(n, 0))
            for n in set(held) | set(bound) if held.get(n, 0) != bound.get(n, 0)}


def update_rows_device_ms(spec, rows: int = 64, calls: int = 20) -> dict:
    """The private mirror's ``update_rows`` on its own stream: device ms per
    call of ``rows`` rows (its index_copy_ pair; the pinned upload is a
    copy, counted apart) from a profiler window over ``calls`` calls, and
    the host's ms per call by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kern, arrays = spec.kernel, spec._fleet.arrays
    picked = list(range(0, min(rows * 37, len(arrays.names)), 37))[:rows]
    with torch.cuda.stream(spec._stream):
        kern.update_rows(arrays, picked)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                kern.update_rows(arrays, picked)
            torch.cuda.synchronize()
        host_ms = cuda_ms(lambda: kern.update_rows(arrays, picked))
    kernel_us = copy_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        total = getattr(evt, "self_device_time_total", None)
        if total is None:
            total = evt.self_cuda_time_total
        if evt.key.startswith("Memcpy"):
            copy_us += total
        else:
            kernel_us += total
    if not kernel_us:
        return dict(rows=len(picked), device_ms=None, copy_ms=None, ms=host_ms)
    return dict(rows=len(picked), device_ms=kernel_us / calls / 1e3,
                copy_ms=copy_us / calls / 1e3, ms=host_ms)


def stream_kernels(prof, kernel: str) -> "dict[int, list[tuple[int, int]]]":
    """(start, end) ns of every device record of ``kernel`` in a profiler
    window, by the stream the tracer saw it on."""
    from torch.autograd import DeviceType

    out: dict[int, list[tuple[int, int]]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and kernel in e.name():
            start = e.start_ns()
            out.setdefault(e.device_resource_id(), []).append((start, start + e.duration_ns()))
    return out


def concurrent_eval(stack, spec, spec_inputs, calls: int = 40) -> dict:
    """fleet_eval at K = 1 on the speculation cache's stream, alone and while
    a second thread launches, in a loop on the default stream, what the
    serve path launches: fleet_eval at K = 16 and joint_fit on run (c)'s
    seeded 64 x 8,192 rows (JOINT_MAIN_SHAPE, one cluster of up to 16
    blocks). CUDA-event ms per call on the private stream (from the host's
    enqueue to the kernel's end: a wait for the card's SMs, or for the
    interpreter lock the other thread holds, shows there); from a profiler
    window of each, the private kernel's own device ms and how many of its
    launches overlapped a serve-stream fleet_eval or joint_fit in time; and
    every result of both threads held against the plain version of the
    same inputs."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from yoda_tpu_torch.ops.cuda_kernel import fleet_eval, joint_fit
    from yoda_tpu_torch.ops.kernel import joint_fit_scan, kernel_packed_burst, pack_request

    kern = spec.kernel
    dyn, request = spec_inputs
    dev = kern.device
    d_dyn = torch.from_numpy(np.ascontiguousarray(dyn)).to(dev)
    spec_args = (kern._chips, kern._nodes, d_dyn, d_dyn[3:4].contiguous(),
                 torch.from_numpy(pack_request(request)[None]).to(dev), kern.weights)
    serve = stack.batch._kern
    rng = np.random.default_rng(7)
    n = serve._chips.shape[2]
    host_ok = (rng.random((16, n)) < 0.5).astype(np.int32)
    reqs = REQUEST_TABLE[rng.integers(0, len(REQUEST_TABLE), 16)]
    serve_dyn = np.ascontiguousarray(dyn)
    serve_args = (serve._chips, serve._nodes, torch.from_numpy(serve_dyn).to(dev),
                  torch.from_numpy(host_ok).to(dev), torch.from_numpy(reqs).to(dev),
                  serve.weights)
    k, jn = JOINT_MAIN_SHAPE
    joint_args = tuple(torch.from_numpy(x).to(dev)
                       for x in joint_case(k, jn, seed=k * 7 + jn))
    plain = [kernel_packed_burst(*(t.cpu() if torch.is_tensor(t) else t for t in args))
             for args in (spec_args, serve_args)]
    cpu_spec_args = [t.cpu() if torch.is_tensor(t) else t for t in spec_args]
    plain_ms = cuda_ms(lambda: kernel_packed_burst(*cpu_spec_args), warmup=1, iters=3)
    packed_cpu = joint_args[0].cpu()
    plain_joint = [w.to(torch.int32) for w in joint_fit_scan(
        packed_cpu[:, 0], packed_cpu[:, 3], packed_cpu[:, 5],
        *(t.cpu() for t in joint_args[1:]))]
    bad: list[str] = []

    def timed(label: str) -> float:
        times = []
        with torch.cuda.stream(spec._stream):
            for _ in range(calls):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fleet_eval(*spec_args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
                if not torch.equal(out.cpu(), plain[0]):
                    bad.append(label)
        return statistics.median(times)

    alone = timed("alone")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        timed("alone, profiled")
    alone_kernels = [iv for ivs in stream_kernels(prof, "fleet_eval").values() for iv in ivs]
    stop = threading.Event()
    serve_calls = [0]
    errors: list[BaseException] = []

    def serve_loop():
        try:
            while not stop.is_set():
                out = fleet_eval(*serve_args)
                got = joint_fit(*joint_args)
                torch.cuda.current_stream(dev).synchronize()
                if not torch.equal(out.cpu(), plain[1]):
                    bad.append("serve thread fleet_eval")
                if not all(torch.equal(g.cpu(), w) for g, w in zip(got, plain_joint)):
                    bad.append("serve thread joint_fit")
                serve_calls[0] += 1
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    thread = threading.Thread(target=serve_loop, daemon=True)
    thread.start()
    try:
        time.sleep(0.05)
        before = serve_calls[0]
        concurrent = timed("concurrent")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            timed("concurrent, profiled")
        during = serve_calls[0] - before
    finally:
        stop.set()
        thread.join(timeout=30)
    by_stream = stream_kernels(prof, "fleet_eval")
    joints = [iv for ivs in stream_kernels(prof, "joint_fit").values() for iv in ivs]
    if thread.is_alive() or errors or bad or not during:
        raise AssertionError(
            f"concurrent fleet_eval: alive {thread.is_alive()}, errors {errors}, "
            f"serve-thread passes during the windows {during}, results that "
            f"differ from the plain version: {sorted(set(bad))}"
        )
    # The private stream is the one whose kernels ran alone at K = 1: its
    # records are the shortest. The other stream's are the serve thread's.
    private = min(by_stream, default=None,
                  key=lambda s: statistics.mean(b - a for a, b in by_stream[s]))
    mine = by_stream.get(private, [])
    theirs = [iv for s, ivs in by_stream.items() if s != private for iv in ivs]

    def device_ms(ivs):
        return statistics.mean(b - a for a, b in ivs) / 1e6 if ivs else None

    def overlapping(others):
        return sum(any(a < d and c < b for c, d in others) for a, b in mine)

    return dict(
        alone_ms=alone, concurrent_ms=concurrent, calls=calls, plain_ms=plain_ms,
        serve_thread_calls=serve_calls[0], serve_thread_calls_in_windows=during,
        alone_device_ms=device_ms(alone_kernels), profiled_alone=len(alone_kernels),
        concurrent_device_ms=device_ms(mine),
        serve_device_ms=device_ms(theirs), joint_fit_device_ms=device_ms(joints),
        profiled_private=len(mine), profiled_serve=len(theirs),
        profiled_joint_fit=len(joints), streams=len(by_stream),
        overlapped=overlapping(theirs), overlapped_joint_fit=overlapping(joints),
    )


def run_speculation(platform: str, size: dict) -> dict:
    """(h1): hot-shape singletons at K = 1 in ``waves`` waves of ``wave``,
    one speculate_once before each; after each wave the agent republishes
    the hosts it bound (their usage becomes metrics-visible: both mirrors
    take delta syncs, the private one with update_rows on its stream).
    Bindings, every tick's plans, the cache's counters, times and the
    private kernel's launches."""
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod

    stack, agent = build_fleet(platform, 1, slices=size["slices"],
                               v5e_hosts=size["v5e_hosts"])
    spec = stack.speculation
    rng = np.random.default_rng(8)
    bind_ms: list[float] = []
    spec.bind_observe = bind_ms.append
    kept: list = []
    inner_evaluate = spec.kernel.evaluate

    def kept_evaluate(dyn, request):
        kept[:] = [(np.array(dyn), request)]
        return inner_evaluate(dyn, request)

    spec.kernel.evaluate = kept_evaluate
    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    kernel_mod.row_update_launches = 0
    tick_ms, plans, names = [], [], []
    t0 = time.monotonic()
    for w in range(size["waves"]):
        t = time.perf_counter()
        produced = spec.speculate_once()
        if platform != "cpu":
            torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t))
        plans.append((produced, sorted(
            (int(k[1].number), p.node, p.base_reserved) for k, p in spec._plans.items()
        )))
        wave = []
        for i in range(size["wave"]):
            wave.append(f"sp{w:02d}-{i:02d}")
            stack.cluster.create_pod(hot_pod(wave[-1], int(rng.choice(HOT_SHAPES))))
        stack.scheduler.run_until_idle(max_wall_s=300)
        names += wave
        for host in sorted({stack.cluster.get_pod(f"default/{n}").node_name for n in wave}):
            agent.refresh(host)
    if platform != "cpu":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    lat = singleton_latencies(stack, names)
    out = dict(
        platform=platform, pods=len(names), bindings=bindings_of(stack, names),
        plans=plans, stats=spec.stats(),
        launches=cuda_kernel.launches, spec_launches=spec.kernel.launches,
        spec_row_updates=spec.kernel.row_updates,
        serve_launches=stack.batch._kern.launches,
        row_update_launches=kernel_mod.row_update_launches,
        dispatch_count=stack.batch.dispatch_count, dispatch_errors=stack.batch.dispatch_errors,
        spec_restacks=spec._fleet.restacks, spec_delta_syncs=spec._fleet.delta_syncs,
        overcommitted=over_capacity(stack), accounting_gap=accounting_gap(stack),
        speculate_ms_median=statistics.median(tick_ms),
        speculate_ms_max=max(tick_ms),
        spec_bind_ms_median=statistics.median(bind_ms) if bind_ms else None,
        spec_bind_ms_max=max(bind_ms, default=None),
        wall_s=wall, pods_per_s=len(lat) / wall if wall else 0.0,
        p50_ms=pct_ms(lat, 0.5), p99_ms=pct_ms(lat, 0.99),
    )
    spec.kernel.evaluate = inner_evaluate
    if platform != "cpu" and kept:
        out["update_rows"] = update_rows_device_ms(spec)
        out["concurrent"] = concurrent_eval(stack, spec, kept[0])
    return out


def rebalance_layout(size: dict) -> "tuple[dict[str, str], list[str]]":
    """(h2)'s pools: ``pool`` v5e hosts (rb-e), and the hosts of
    ``frag_slices`` v5p slices (rb-p, in slice order)."""
    step = max(size["v5e_hosts"] // size["pool"], 1)
    pools = {f"v5e-{h * step:04d}": "rb-e" for h in range(size["pool"])}
    frag = [f"v5p-{s * (size['slices'] // size['frag_slices']):03d}-{i}"
            for s in range(size["frag_slices"]) for i in range(4)]
    pools.update({h: "rb-p" for h in frag})
    return pools, frag


def run_rebalance(platform: str, size: dict):
    """(h2): the rb-e pool filled at priority 1, 1x1x1 topology gangs on
    the rb-p slices with the gangs on each slice's diagonal deleted (two
    free islands a slice), an elastic gang (min 4, max 16, size 8; 16
    members), both at priority 5, and a parked priority-100 plain gang of
    ``gang`` x 8 chips on rb-e (preemption off in this stack: only the
    rebalancer can admit it, through at most 32 victims); then
    resync and rebalance passes until one changes nothing. Returns the run
    and its stack (the reconciler run rebuilds a stack over its cluster)."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod

    pools, frag = rebalance_layout(size)
    stack, _agent = build_fleet(
        platform, 16, pools=pools, slices=size["slices"], v5e_hosts=size["v5e_hosts"],
        enable_preemption=False, rebalance_max_victims=32, rebalance_min_gain=1e-4,
    )
    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    kernel_mod.row_update_launches = 0
    names: list[str] = []

    def create(pods, selector=None):
        for name, labels in pods:
            names.append(name)
            stack.cluster.create_pod(
                PodSpec(name, labels=dict(labels), node_selector=selector or {})
            )
        stack.scheduler.run_until_idle(max_wall_s=300)

    create([(f"fill{i:03d}", {"tpu/chips": "8", "tpu/priority": "1"})
            for i in range(size["pool"])], {"pool": "rb-e"})
    create([(f"t{i:02d}-0", {"tpu/gang": f"t{i:02d}", "tpu/topology": "1x1x1",
                             "tpu/chips": "4", "tpu/priority": "5"})
            for i in range(len(frag))],
           {"pool": "rb-p"})
    diagonal = {h for h in frag if h.endswith(("-0", "-3"))}
    for p in list(stack.cluster.list_pods()):
        if p.name.startswith("t") and p.node_name in diagonal:
            stack.cluster.delete_pod(p.key)
    stack.scheduler.run_until_idle(max_wall_s=60)
    create([(f"el-{i:02d}", {"tpu/gang": "el", "tpu/gang-size": "8",
                             "tpu/min-members": "4", "tpu/max-members": "16",
                             "tpu/chips": "4", "tpu/generation": "v5e",
                             "tpu/priority": "5"})
            for i in range(16)])
    create([(f"hi-{i:02d}", {"tpu/gang": "hi", "tpu/gang-size": str(size["gang"]),
                             "tpu/chips": "8", "tpu/priority": "100"})
            for i in range(size["gang"])], {"pool": "rb-e"})
    parked = sum(stack.cluster.get_pod(f"default/hi-{i:02d}").node_name is None
                 for i in range(size["gang"]))
    t = time.perf_counter()
    resync = stack.reconciler.resync()
    resync_ms = 1e3 * (time.perf_counter() - t)
    passes, pass_ms, admitted_at = [], [], None
    for _ in range(12):
        t_clock = stack.scheduler.clock()
        t = time.perf_counter()
        report = stack.rebalancer.run_once()
        pass_ms.append(1e3 * (time.perf_counter() - t))
        view = dataclasses.asdict(report)
        passes.append(view)
        if report.admitted_gangs and admitted_at is None:
            admitted_at = t_clock
        stack.scheduler.run_until_idle(max_wall_s=300)
        if not (report.moves or report.aborted_moves or report.preempted or report.resizes):
            break
    if platform != "cpu":
        torch.cuda.synchronize()
    hi_done = [r.completed_at for r in stack.scheduler.stats.results
               if r.pod_key.startswith("default/hi-") and r.node is not None
               and r.outcome in ("bound", "waiting")]
    bound = bindings_of(stack, names)
    hi_bound = sum(bound[f"hi-{i:02d}"] is not None for i in range(size["gang"]))
    out = dict(
        platform=platform, pods=len(names), bindings=bound, passes=passes,
        resync=dataclasses.asdict(resync) | {"duration_ms": None},
        resync_ms=resync_ms, pass_ms=pass_ms, parked_before=parked, hi_bound=hi_bound,
        el_bound=sum(bound[f"el-{i:02d}"] is not None for i in range(16)),
        effective_el=stack.gang.effective_size("el"),
        gang_completion_ms=(1e3 * (max(hi_done) - admitted_at)
                            if admitted_at is not None and hi_done else None),
        unbinds=stack.binder.unbinds, launches=cuda_kernel.launches,
        joint_fit_launches=cuda_kernel.joint_fit_launches,
        row_update_launches=kernel_mod.row_update_launches,
        dispatch_count=stack.batch.dispatch_count, dispatch_errors=stack.batch.dispatch_errors,
        overcommitted=over_capacity(stack), accounting_gap=accounting_gap(stack),
        waiting=len(stack.framework.waiting_pods()),
    )
    return out, stack


def run_reconcile(platform: str, size: dict, cluster) -> dict:
    """(h3): the leader that ran (h2) dies with a plain gang half bound (2 of
    4 members bound, written to the cluster as its last act); a new stack
    is built over the same cluster, resyncs (the gang is adopted and
    completes), and after a ghost binding, a dropped deletion and a leaked
    claim the drift pass repairs them. Both reports and each pass's ms."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod
    from yoda_tpu_torch.standalone import build_stack

    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    kernel_mod.row_update_launches = 0

    def free_hosts(n: int) -> list[str]:
        held = {p.node_name for p in cluster.list_pods() if p.node_name}
        return [f"v5e-{h:04d}" for h in range(size["v5e_hosts"] - 1, 0, -1)
                if f"v5e-{h:04d}" not in held][:n]

    free = free_hosts(2)
    labels = {"tpu/gang": "orphan", "tpu/gang-size": "4", "tpu/chips": "8",
              "tpu/generation": "v5e"}
    for i in range(4):
        pod = PodSpec(f"orphan-{i}", labels=dict(labels))
        if i < 2:
            pod.node_name, pod.phase = free[i], "Running"
        cluster.create_pod(pod)
    t = time.perf_counter()
    stack = build_stack(cluster=cluster, config=SchedulerConfig(
        kernel_platform=platform, batch_requests=16, enable_preemption=False))
    build_ms = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    resync = stack.reconciler.resync()
    resync_ms = 1e3 * (time.perf_counter() - t)
    stack.scheduler.run_until_idle(max_wall_s=300)
    orphan = {f"orphan-{i}": stack.cluster.get_pod(f"default/orphan-{i}").node_name
              for i in range(4)}
    free = free_hosts(2)
    ghost = PodSpec("ghost", labels={"tpu/chips": "8", "tpu/generation": "v5e"})
    ghost.node_name, ghost.phase = free[0], "Running"
    dropped = next(p for p in cluster.list_pods()
                   if p.node_name and p.name.startswith("fill"))
    cluster.suppress_kinds.add("Pod")
    try:
        cluster.create_pod(ghost)
        cluster.delete_pod(dropped.key)
    finally:
        cluster.suppress_kinds.clear()
    stack.accountant._claim("leaked-uid", free[1], 8)
    t = time.perf_counter()
    drift = stack.reconciler.reconcile()
    reconcile_ms = 1e3 * (time.perf_counter() - t)
    stack.scheduler.run_until_idle(max_wall_s=60)
    return dict(
        platform=platform, orphan=orphan, dropped=dropped.name,
        resync=dataclasses.asdict(resync) | {"duration_ms": None},
        drift=dataclasses.asdict(drift), build_ms=build_ms, resync_ms=resync_ms,
        reconcile_ms=reconcile_ms, overcommitted=over_capacity(stack),
        accounting_gap=accounting_gap(stack), launches=cuda_kernel.launches,
        joint_fit_launches=cuda_kernel.joint_fit_launches,
        row_update_launches=kernel_mod.row_update_launches,
    )


def run_threaded(platform: str, size: dict, spec_enabled: bool = True) -> dict:
    """(h4): the rebalancer's run_forever on a second thread (passes every
    ``period_s``, 50 ms speculation ticks) while the main thread serves
    ``threaded_pods`` hot-shape singletons at K = 16 in 16 waves over about
    ``threaded_s`` seconds, and in two of the waves two plain gangs each,
    which the serve path places in one joint pass (fleet_eval, then
    joint_fit). The start of every rebalance pass is recorded, so the
    check can require one that began inside the serve window.
    Every kernel object's launch counts are zeroed just before the window;
    pods/s and latencies count the serve waves only. Invariants only: timing decides who wins a race, so the
    bindings are not compared with any other run. Counted over the window
    too: the burst rows whose serve-time check failed (``_pick_checks``
    False) and the serve path's dispatches; ``spec_enabled=False`` runs
    the same window with the speculative cache off."""
    import logging
    import threading

    from yoda_tpu_torch.api.types import PodSpec, pod_admits_on
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod

    stack, _agent = build_fleet(platform, 16, slices=size["slices"],
                                v5e_hosts=size["v5e_hosts"], spec_enabled=spec_enabled)
    spec, rb = stack.speculation, stack.rebalancer
    errors: list[str] = []
    pick_failures = [0]
    inner_pick = stack.batch._pick_checks

    def counted_pick(*args, **kw):
        ok = inner_pick(*args, **kw)
        pick_failures[0] += not ok
        return ok

    stack.batch._pick_checks = counted_pick

    class Errors(logging.Handler):
        def emit(self, record):
            errors.append(record.getMessage())

    handler = Errors(level=logging.ERROR)
    logging.getLogger("yoda_tpu_torch").addHandler(handler)
    consumed: list = []
    inner_revalidate = spec.revalidate

    def noted_revalidate(plan, pod, snapshot):
        ok = inner_revalidate(plan, pod, snapshot)
        if ok:
            consumed.append((pod, plan.node))
        return ok

    spec.revalidate = noted_revalidate
    pass_starts: list[float] = []
    inner_pass = rb.run_once

    def timed_pass():
        pass_starts.append(time.monotonic())
        return inner_pass()

    rb.run_once = timed_pass
    rng = np.random.default_rng(9)
    names = []
    for i in range(16):  # warm: the shapes are seen, the fleet is resident
        names.append(f"warm{i:02d}")
        stack.cluster.create_pod(hot_pod(names[-1], int(rng.choice(HOT_SHAPES))))
    stack.scheduler.run_until_idle(max_wall_s=300)
    stack.reconciler.resync()
    serve = stack.batch._kern
    for kern in (serve, spec.kernel):
        kern.launches = kern.joint_fit_launches = kern.row_updates = 0
    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    kernel_mod.row_update_launches = 0
    pick_failures[0] = 0
    b = stack.batch
    window_base = (b.dispatch_count, b.burst_dispatches, b.burst_served, b.burst_invalidated)
    stop = threading.Event()
    thread = threading.Thread(
        target=rb.run_forever, args=(stop,),
        kwargs={"period_s": size["period_s"], "spec_period_s": 0.05}, daemon=True,
    )
    per_wave = size["threaded_pods"] // 16
    gang_waves = {5: ("tg0", "tg1"), 11: ("tg2", "tg3")}
    t0 = time.monotonic()
    thread.start()
    try:
        for w in range(16):
            for i in range(per_wave):
                names.append(f"th{w:02d}-{i:02d}")
                stack.cluster.create_pod(hot_pod(names[-1], int(rng.choice(HOT_SHAPES))))
            for g in gang_waves.get(w, ()):
                for m in range(4):
                    names.append(f"{g}-{m}")
                    stack.cluster.create_pod(PodSpec(names[-1], labels={
                        "tpu/gang": g, "tpu/gang-size": "4", "tpu/chips": "8",
                        "tpu/generation": "v5e"}))
            stack.scheduler.run_until_idle(max_wall_s=300)
            time.sleep(max(t0 + (w + 1) * size["threaded_s"] / 16 - time.monotonic(), 0))
        serve_end = time.monotonic()
    finally:
        stop.set()
        thread.join(timeout=60)
        spec.revalidate = inner_revalidate
        rb.run_once = inner_pass
        logging.getLogger("yoda_tpu_torch").removeHandler(handler)
    if platform != "cpu":
        torch.cuda.synchronize()
    wall = serve_end - t0
    snap = stack.informer.snapshot()
    bad_plans = []
    for pod, node in consumed:
        live = stack.cluster.get_pod(pod.key)
        if live is None or live.node_name != node:
            continue  # Reserve lost the race: the full path placed it
        ni = snap.get(node) if node in snap else None
        if (ni is None or ni.tpu is None or ni.tpu.generation != "v5e"
                or not pod_admits_on(ni.node, pod)[0]):
            bad_plans.append((pod.name, node))
    gangs = {g: sum(stack.cluster.get_pod(f"default/{g}-{m}").node_name is not None
                    for m in range(4)) for pair in gang_waves.values() for g in pair}
    lat = singleton_latencies(stack, [n for n in names if n.startswith("th")])
    window_pods = sum(n.startswith(("th", "tg")) for n in names)
    dispatches, bursts, served, invalidated = (
        now - then for now, then in zip(
            (b.dispatch_count, b.burst_dispatches, b.burst_served, b.burst_invalidated),
            window_base))
    return dict(
        platform=platform, spec_enabled=spec_enabled, window_pods=window_pods,
        pick_check_failures=pick_failures[0], burst_invalidated=invalidated,
        burst_dispatches=bursts, burst_served=served, serve_dispatches=dispatches,
        serve_dispatches_per_pod=dispatches / window_pods,
        serve_launches_per_pod=serve.launches / window_pods,
        pods=len(names), alive=thread.is_alive(), errors=errors[:5],
        bound=sum(v is not None for v in bindings_of(stack, names).values()),
        gangs=gangs, consumed=len(consumed), bad_plans=bad_plans,
        stats=spec.stats(), rebalance_passes=rb.passes,
        passes_begun_in_window=sum(t < serve_end for t in pass_starts),
        serve_launches=serve.launches, spec_launches=spec.kernel.launches,
        serve_joint_fit_launches=serve.joint_fit_launches,
        spec_joint_fit_launches=spec.kernel.joint_fit_launches,
        fused_plan_dispatches=stack.batch.fused_plan_dispatches,
        launches=cuda_kernel.launches, joint_fit_launches=cuda_kernel.joint_fit_launches,
        row_update_launches=kernel_mod.row_update_launches,
        dispatch_errors=stack.batch.dispatch_errors,
        overcommitted=over_capacity(stack), accounting_gap=accounting_gap(stack),
        wall_s=wall, pods_per_s=len(lat) / wall if wall else 0.0,
        p50_ms=pct_ms(lat, 0.5), p99_ms=pct_ms(lat, 0.99),
    )


def run_background(platform: str, size: dict = BACKGROUND_FULL,
                   threaded: bool = True) -> dict:
    """Run (h) on one kernel_platform: (h1)-(h3), and (h4) when asked."""
    t = time.monotonic()
    h1 = run_speculation(platform, size)
    h1["part_s"], t = time.monotonic() - t, time.monotonic()
    h2, stack = run_rebalance(platform, size)
    h2["part_s"], t = time.monotonic() - t, time.monotonic()
    h3 = run_reconcile(platform, size, stack.cluster)
    h3["part_s"], t = time.monotonic() - t, time.monotonic()
    h4 = run_threaded(platform, size) if threaded else None
    if h4 is not None:
        h4["part_s"] = time.monotonic() - t
    return dict(h1=h1, h2=h2, h3=h3, h4=h4)


BACKGROUND_PARITY = {
    "h1": ("bindings", "plans", "stats", "dispatch_count", "spec_restacks",
           "spec_delta_syncs"),
    "h2": ("bindings", "passes", "resync", "parked_before", "hi_bound", "el_bound",
           "effective_el", "unbinds", "dispatch_count"),
    "h3": ("orphan", "dropped", "resync", "drift"),
}


def check_background_run(run: dict, size: dict) -> None:
    """The checks of one run (h) that need no second run."""
    name = f"run h ({run['h1']['platform']})"
    for part in ("h1", "h2", "h3") + (("h4",) if run["h4"] else ()):
        r = run[part]
        if r["overcommitted"] or r["accounting_gap"]:
            raise AssertionError(f"{name} {part}: over capacity {r['overcommitted']}, "
                                 f"accounting != bound pods at {r['accounting_gap']}")
    h1, h2, h3, h4 = run["h1"], run["h2"], run["h3"], run["h4"]
    if h1["dispatch_errors"] or any(v is None for v in h1["bindings"].values()):
        raise AssertionError(f"{name} h1: unbound pods or dispatch errors")
    if not h1["stats"]["hits"] or h1["stats"]["ticks"] != size["waves"]:
        raise AssertionError(f"{name} h1: no speculative hit: {h1['stats']}")
    if h1["dispatch_count"] + h1["stats"]["hits"] != h1["pods"]:
        raise AssertionError(
            f"{name} h1: {h1['dispatch_count']} dispatches + {h1['stats']['hits']} "
            f"hits for {h1['pods']} pods"
        )
    if not h2["parked_before"] or h2["hi_bound"] != size["gang"]:
        raise AssertionError(f"{name} h2: gang hi parked {h2['parked_before']}, "
                             f"bound after the passes {h2['hi_bound']}")
    passes = h2["passes"]
    if not any(p["preempted"] for p in passes) or not any(p["resizes"] for p in passes):
        raise AssertionError(f"{name} h2: no preemption or no resize: {passes}")
    if passes[-1]["moves"] or passes[-1]["preempted"] or passes[-1]["resizes"]:
        raise AssertionError(f"{name} h2: the passes did not settle: {passes[-1]}")
    if h2["waiting"] or h2["dispatch_errors"]:
        raise AssertionError(f"{name} h2: {h2['waiting']} at Permit, "
                             f"{h2['dispatch_errors']} dispatch errors")
    if h3["resync"]["adopted_gangs"] != ["orphan"] or None in h3["orphan"].values():
        raise AssertionError(f"{name} h3: the half-bound gang: {h3['resync']}, {h3['orphan']}")
    d = h3["drift"]
    if (d["ghost_pods"], d["leaked_reservations"]) != (2, 1):
        raise AssertionError(f"{name} h3: drift report {d}")
    if h4 is not None:
        if h4["alive"] or h4["errors"] or h4["dispatch_errors"] or h4["bad_plans"]:
            raise AssertionError(
                f"{name} h4: thread alive {h4['alive']}, errors {h4['errors']}, "
                f"dispatch errors {h4['dispatch_errors']}, plans that do not admit "
                f"their pod {h4['bad_plans']}"
            )
        if h4["bound"] != h4["pods"] or set(h4["gangs"].values()) != {4}:
            raise AssertionError(f"{name} h4: {h4['bound']}/{h4['pods']} bound, gangs {h4['gangs']}")
        if not h4["passes_begun_in_window"] or not h4["stats"]["ticks"]:
            raise AssertionError(
                f"{name} h4: no rebalance pass began beside the serve loop: {h4}")
        if not h4["fused_plan_dispatches"]:
            raise AssertionError(f"{name} h4: the serve thread took no joint pass")


def check_background(g: dict, c: dict, size: dict) -> None:
    """Run (h) on the card against the same script on the CPU: the
    deterministic parts equal, every check of each run, and the card run's
    launches where they must be."""
    for part, keys in BACKGROUND_PARITY.items():
        diff = [k for k in keys if g[part][k] != c[part][k]]
        if diff:
            raise AssertionError(f"run h {part}: cuda != cpu in {diff}")
    check_background_run(g, size)
    check_background_run(c, size)
    h1 = g["h1"]
    if h1["spec_launches"] < h1["stats"]["speculations"] or not h1["spec_launches"]:
        raise AssertionError(f"run h1: {h1['spec_launches']} private fleet_eval launches "
                             f"for {h1['stats']['speculations']} plans")
    if not 0 < h1["spec_row_updates"] <= h1["spec_delta_syncs"]:
        raise AssertionError(f"run h1: {h1['spec_row_updates']} private update_rows for "
                             f"{h1['spec_delta_syncs']} delta syncs")
    if h1["launches"] != h1["spec_launches"] + h1["serve_launches"]:
        raise AssertionError(f"run h1: {h1['launches']} launches, {h1['spec_launches']} "
                             f"private + {h1['serve_launches']} serve")
    h4 = g["h4"]
    if h4 and not (h4["serve_launches"] and h4["spec_launches"]
                   and h4["launches"] == h4["serve_launches"] + h4["spec_launches"]):
        raise AssertionError(f"run h4: {h4['launches']} launches, serve thread "
                             f"{h4['serve_launches']}, speculation thread "
                             f"{h4['spec_launches']}")
    if h4 and not (0 < h4["serve_joint_fit_launches"] == h4["joint_fit_launches"]
                   == h4["fused_plan_dispatches"] and not h4["spec_joint_fit_launches"]):
        raise AssertionError(f"run h4: {h4['joint_fit_launches']} joint_fit launches, "
                             f"serve thread {h4['serve_joint_fit_launches']}, "
                             f"speculation thread {h4['spec_joint_fit_launches']}, "
                             f"{h4['fused_plan_dispatches']} fused dispatches")
    for part in ("h1", "h2"):
        if c[part]["launches"] or c[part]["row_update_launches"]:
            raise AssertionError(f"run {part}: the CPU run launched on the card")


def print_background(run: dict, smi: str) -> None:
    """One line per part of a run (h), less its bindings and plans; the
    rebalance passes as counts."""
    for part in ("h1", "h2", "h3", "h4"):
        if run[part] is None:
            continue
        summary = {k: v for k, v in run[part].items()
                   if k not in ("bindings", "plans", "passes")}
        if "passes" in run[part]:
            summary["passes"] = [
                {k: (len(v) if isinstance(v, (list, dict)) else v) for k, v in p.items()}
                for p in run[part]["passes"]
            ]
        print(f"background ({part}) {run['h1']['platform']} [{smi}]:", json.dumps(summary))


# Run (i): the node health path on the 5,000-node fleet — the health
# ladder on stopped heartbeats, fencing through the admission rows the card
# reads, condition signals, drains and gang-whole repair. The smaller size
# is the tests' copy of the same script.
NODEHEALTH_FULL = dict(slices=512, v5e_hosts=2952, topo=16, plain=8, gang=16,
                       singles=128, serve=256, stop=64)
NODEHEALTH_SMALL = dict(slices=16, v5e_hosts=96, topo=4, plain=4, gang=4,
                        singles=16, serve=32, stop=16)
# How long one drain of the queue may take before run (i) fails: its
# scheduling clock is stepped by hand, so a pod left at Permit would hold a
# drain for all of it.
NODEHEALTH_DRAIN_S = 120.0


class SteppedClock:
    """A clock the script advances by hand: run (i)'s wall clock of the
    agents' publish stamps (the monitor's ladder reads it) and its
    scheduling clock (queue backoff, Permit deadlines, drain deadlines).
    Stepping both by hand makes the card and CPU runs take the same
    decisions whatever their speed."""

    def __init__(self, t: float) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def nodehealth_pools(size: dict) -> "dict[str, str]":
    """Run (i)'s pools: ``gang`` v5e hosts for the elastic gang (nh-el),
    ``2 * gang`` for the two plain gangs of (i4) (nh-q), and one v5p slice
    per topology gang (nh-t<i>, slices spread over the fleet), so each
    2x1x1 gang leaves its slice two free hosts to be patched or drained
    into."""
    g = size["gang"]
    pools = {f"v5e-{h:04d}": "nh-el" for h in range(g)}
    pools.update({f"v5e-{h:04d}": "nh-q" for h in range(g, 3 * g)})
    step = size["slices"] // size["topo"]
    for t in range(size["topo"]):
        pools.update({f"v5p-{t * step:03d}-{i}": f"nh-t{t:02d}" for i in range(4)})
    return pools


def nodehealth_waves(size: dict, seed: int = 12):
    """Run (i)'s two waves of (name, labels, node selector) and each gang's
    (kind, members): first the pool-bound gangs (the elastic gang el, the
    plain gangs p0 and p1), then the topology gangs (2x1x1 on v5p), the
    other plain gangs and the singletons."""
    rng = np.random.default_rng(seed)
    g = size["gang"]
    v5e = {"tpu/chips": "8", "tpu/generation": "v5e"}
    gangs = {"el": ("elastic", g)}
    first = [(f"el-{i:02d}", {"tpu/gang": "el", "tpu/gang-size": str(g),
                              "tpu/min-members": str(g // 2),
                              "tpu/max-members": str(g), **v5e}, {"pool": "nh-el"})
             for i in range(g)]
    for j in (0, 1):
        gangs[f"p{j}"] = ("plain", g)
        first += [(f"p{j}-{i:02d}", {"tpu/gang": f"p{j}", "tpu/gang-size": str(g), **v5e},
                   {"pool": "nh-q"}) for i in range(g)]
    second = []
    for t in range(size["topo"]):
        gangs[f"t{t:02d}"] = ("topology", 2)
        second += [(f"t{t:02d}-{i}", {"tpu/gang": f"t{t:02d}", "tpu/topology": "2x1x1",
                                      "tpu/chips": "4"}, {"pool": f"nh-t{t:02d}"})
                   for i in range(2)]
    for j in range(2, size["plain"]):
        gangs[f"p{j}"] = ("plain", g)
        second += [(f"p{j}-{i:02d}", {"tpu/gang": f"p{j}", "tpu/gang-size": str(g), **v5e},
                    None) for i in range(g)]
    second += [(f"s{i:03d}", {"tpu/chips": str(int(rng.choice(HOT_SHAPES))),
                              "tpu/generation": "v5e"}, None)
               for i in range(size["singles"])]
    return [first, second], gangs


def abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest absolute difference of two integer or bool tensors (on
    any devices), 0 when empty."""
    if not want.numel():
        return 0
    return int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())


def gang_of(name: str) -> "str | None":
    """The gang a run (i) pod belongs to, None for a singleton."""
    return None if name.startswith(("s", "serve", "probe")) else name.rsplit("-", 1)[0]


def run_nodehealth(platform: str, size: dict = NODEHEALTH_FULL) -> dict:
    """Run (i) on one kernel_platform (module docstring): bindings, node
    states, fence sets and every monitor pass's RepairReport for the
    comparison with the other platform; pass and repair times, the counters
    across each fence flip and the kernels' launches; and on the card every
    ``fleet_eval`` and ``joint_fit`` call's result against its plain
    version."""
    from yoda_tpu_torch.api.types import PodSpec
    from yoda_tpu_torch.ops import cuda_kernel
    from yoda_tpu_torch.ops import kernel as kernel_mod

    now, clock = SteppedClock(1_000_000.0), SteppedClock(1_000.0)
    # bind_workers 0: every unbind inline and in order, so both platforms
    # requeue in one order (tests/test_torch_nodehealth.py holds the
    # default fan-out against the reference on what no order changes).
    stack, agent = build_fleet(
        platform, 16, pools=nodehealth_pools(size), slices=size["slices"],
        v5e_hosts=size["v5e_hosts"], clock=clock, now_fn=now, bind_workers=0,
    )
    monitor, batch = stack.nodehealth, stack.batch
    monitor.now_fn = now
    # The monitor's own clock times the repairs (RepairReport.durations_ms)
    # and no deadline of this script can pass on it: the first drain's
    # window is 300 s, the second's 0, and every patch completes in the
    # drain after its pass, long before patch_grace_s.
    monitor.clock = time.monotonic
    suspect_s, down_s = monitor.suspect_after_s, monitor.down_after_s
    binds: list[tuple[float, str, str]] = []  # (host time, pod, node)
    inner_bind = stack.cluster.bind_pod

    def noted_bind(key, node):
        inner_bind(key, node)
        binds.append((time.perf_counter(), key.split("/", 1)[1], node))

    stack.cluster.bind_pod = noted_bind
    kept_fleet: list = []
    kept_joint: list = []
    real_fleet_eval, real_joint_fit = cuda_kernel.fleet_eval, cuda_kernel.joint_fit

    def kept_fleet_eval(chips, nodes, dyn, host_ok, reqs, weights, out=None, counter=None):
        got = real_fleet_eval(chips, nodes, dyn, host_ok, reqs, weights, out=out,
                              counter=counter)
        if chips.is_cuda:
            kept_fleet.append((tuple(t.clone() for t in (chips, nodes, dyn, host_ok, reqs)),
                               weights, got.clone()))
        return got

    def kept_joint_fit(packed, chips_k, starts_k, valid_k, out=None, counter=None):
        got = real_joint_fit(packed, chips_k, starts_k, valid_k, out=out, counter=counter)
        if packed.is_cuda:
            kept_joint.append((tuple(t.clone() for t in (packed, chips_k, starts_k, valid_k)),
                               tuple(t.clone() for t in got)))
        return got

    names: list[str] = []

    def create(pods):
        for name, labels, selector in pods:
            names.append(name)
            stack.cluster.create_pod(
                PodSpec(name, labels=dict(labels), node_selector=selector or {}))
        drain()

    def drain():
        stack.scheduler.run_until_idle(max_wall_s=NODEHEALTH_DRAIN_S)
        if stack.framework.waiting_pods():
            raise AssertionError(f"run i ({platform}): pods left at Permit: "
                                 f"{[w.pod.name for w in stack.framework.waiting_pods()]}")

    def bound() -> dict:
        return {p.name: p.node_name for p in stack.cluster.list_pods()}

    def counters() -> dict:
        return dict(restacks=batch.restacks,
                    row_update_launches=kernel_mod.row_update_launches,
                    admission_patched=batch.admission_patched,
                    fleet_eval=cuda_kernel.launches, joint_fit=cuda_kernel.joint_fit_launches)

    fence_log: list = []

    def note_fence():
        fence_log.append((time.perf_counter(), monitor.fenced_nodes()))

    flips: list[dict] = []

    def flip(label: str, fn):
        """A fence-changing step and the counters across it."""
        before = counters()
        out = fn()
        note_fence()
        after = counters()
        flips.append(dict(step=label, fenced=len(monitor.fenced_nodes()),
                          **{k: after[k] - before[k] for k in before}))
        return out

    passes: list[dict] = []

    def monitor_pass(label: str):
        t = time.perf_counter()
        report = flip(label, monitor.run_once)
        ms = 1e3 * (time.perf_counter() - t)
        passes.append(dict(
            step=label, ms=ms, start=t,
            report={k: (sorted(v) if k == "durations_ms" else v)
                    for k, v in dataclasses.asdict(report).items()},
            durations_ms=dict(report.durations_ms),
            states={n: s.value for n, s in sorted(monitor.states().items())
                    if s.value != "healthy"},
            fenced=sorted(monitor.fenced_nodes()),
        ))
        return report

    def rebind_ms(p: dict, gangs_of_pass: list) -> dict:
        """Host ms from the pass's start to each repaired gang's last
        member bind after it (None while a member is unbound)."""
        out = {}
        for gname in gangs_of_pass:
            after = [t for t, n, _ in binds if t > p["start"] and gang_of(n) == gname]
            out[gname] = 1e3 * (max(after) - p["start"]) if after else None
        singles = [t for t, n, _ in binds if t > p["start"] and gang_of(n) is None]
        if p["report"]["singles"]:
            out["singletons"] = 1e3 * (max(singles) - p["start"]) if singles else None
        return out

    cuda_kernel.fleet_eval, cuda_kernel.joint_fit = kept_fleet_eval, kept_joint_fit
    cuda_kernel.launches = cuda_kernel.joint_fit_launches = 0
    kernel_mod.row_update_launches = 0
    phase_launches: dict[str, dict] = {}
    phase_bindings: dict[str, dict] = {}
    t0 = time.monotonic()
    try:
        waves, gangs = nodehealth_waves(size)
        base = counters()
        for wave in waves:
            create(wave)
        agent.publish_all()
        note_fence()
        start = bound()
        if None in start.values():
            raise AssertionError(f"run i ({platform}): the fleet did not bind: "
                                 f"{[n for n, v in start.items() if v is None][:5]}")
        phase_bindings["i0"] = start
        phase_launches["i0"] = counters()
        note_fence()
        # (i1) the silence ladder on 64 hosts holding gang members and
        # singletons; half flap back inside the debounce window.
        gang_hosts = {h for n, h in start.items() if gang_of(n)}
        topo_hosts = [start[f"t{t:02d}-0"] for t in range(size["topo"])]
        plain_hosts = [(start[f"p{j}-00"], start[f"p{j}-01"]) for j in range(2, size["plain"])]
        el_hosts = [start[f"el-{i:02d}"] for i in range(size["gang"] // 4)]
        single_hosts = sorted({h for n, h in start.items() if not gang_of(n)} - gang_hosts)
        half = size["stop"] // 2
        n_single = size["stop"] - len(topo_hosts) - 2 * len(plain_hosts) - len(el_hosts)
        if len(single_hosts) < n_single:
            raise AssertionError(f"run i: {len(single_hosts)} singleton hosts, want {n_single}")
        down = (topo_hosts[: len(topo_hosts) // 2] + [a for a, _ in plain_hosts] + el_hosts)
        down += single_hosts[: half - len(down)]
        stopped = topo_hosts + [h for pair in plain_hosts for h in pair] + el_hosts
        stopped += single_hosts[:n_single]
        flap = [h for h in stopped if h not in down]
        # The probes ask for more chips than any host has, under the plain
        # singletons' admission key: the first folds every change so far
        # into the cached admission row, the second dispatches right after
        # the flip, so the row's patch count is the flip's alone.
        probe = {"tpu/chips": "9", "tpu/generation": "v5e"}
        create([("probe-0", probe, None)])
        for h in stopped:
            agent.stop_heartbeat(h)
        now.advance(suspect_s + 1.0)
        agent.publish_all()
        note_fence()
        monitor_pass("i1 suspect")
        flip("i1 probe", lambda: create([("probe-1", probe, None)]))
        for n in ("probe-0", "probe-1"):
            stack.cluster.delete_pod(f"default/{n}")
            names.remove(n)
        fenced = set(monitor.fenced_nodes())
        if fenced != set(stopped):
            raise AssertionError(f"run i ({platform}): fenced {len(fenced)} hosts, "
                                 f"stopped {len(stopped)}")
        rng = np.random.default_rng(13)
        t = time.monotonic()
        create([(f"serve{i:03d}", {"tpu/chips": str(int(rng.choice(HOT_SHAPES))),
                                   "tpu/generation": "v5e"}, None)
                for i in range(size["serve"])])
        serve_s = time.monotonic() - t
        for h in flap:
            agent.resume_heartbeat(h)
        note_fence()
        monitor_pass("i1 flap")
        now.advance(down_s - suspect_s)
        agent.publish_all()
        note_fence()
        monitor_pass("i1 down")
        drain()
        passes[-1]["rebind_ms"] = rebind_ms(
            passes[-1], passes[-1]["report"]["patched"] + passes[-1]["report"]["requeued"])
        phase_launches["i1"] = counters()
        phase_bindings["i1"] = bound()
        # (i2) condition signals at event time.
        now_bound = bound()
        killed = now_bound[f"t{size['topo'] - 1:02d}-1"]
        not_ready = now_bound[f"p{size['plain'] - 1}-02"]
        agent.stop_heartbeat(killed)  # the host is gone: its agent too
        flip("i2 kill", lambda: stack.cluster.kill_node(killed))
        ghost_left = stack.accountant.chips_in_use(killed)
        flip("i2 not ready", lambda: stack.cluster.set_node_ready(not_ready, False))
        event_states = {h: monitor.state_of(h).value for h in (killed, not_ready)}
        monitor_pass("i2 repair")
        drain()
        passes[-1]["rebind_ms"] = rebind_ms(
            passes[-1], passes[-1]["report"]["patched"] + passes[-1]["report"]["requeued"])
        phase_launches["i2"] = counters()
        phase_bindings["i2"] = bound()
        # (i3) a drain the rebalancer migrates, then one past its deadline.
        now_bound = bound()
        drained_host = now_bound[f"t{size['topo'] - 2:02d}-0"]
        flip("i3 drain", lambda: monitor.drain(drained_host))
        t = time.perf_counter()
        rb = flip("i3 rebalance", stack.rebalancer.run_once)
        rebalance_ms = 1e3 * (time.perf_counter() - t)
        drain()
        evacuated = bound()[f"p{size['plain'] - 2}-03"]
        flip("i3 deadline 0", lambda: monitor.drain(evacuated, deadline_s=0.0))
        monitor_pass("i3 evacuate")
        drain()
        phase_launches["i3"] = counters()
        phase_bindings["i3"] = bound()
        # (i4) whole requeue of the two pool gangs, then the fence reopens.
        now_bound = bound()
        k = size["gang"] // 2 + 1
        lost = [now_bound[f"p{j}-{i:02d}"] for j in (0, 1) for i in range(k)]
        for h in lost:
            agent.stop_heartbeat(h)
        now.advance(down_s + 1.0)
        agent.publish_all()
        note_fence()
        monitor_pass("i4 down")
        drain()
        parked = {g: sum(bound()[f"{g}-{i:02d}"] is not None for i in range(size["gang"]))
                  for g in ("p0", "p1")}
        flip("i4 resume", lambda: [agent.resume_heartbeat(h) for h in lost])
        monitor_pass("i4 reopen")
        fused_before, joint_before = batch.fused_plan_dispatches, cuda_kernel.joint_fit_launches
        t = time.perf_counter()
        drain()
        reopen_ms = 1e3 * (time.perf_counter() - t)
        reopen_fused = batch.fused_plan_dispatches - fused_before
        reopen_joint_fit = cuda_kernel.joint_fit_launches - joint_before
        phase_launches["i4"] = counters()
        phase_bindings["i4"] = bound()
    finally:
        cuda_kernel.fleet_eval, cuda_kernel.joint_fit = real_fleet_eval, real_joint_fit
        stack.cluster.bind_pod = inner_bind
    if platform != "cpu":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    final = bound()
    # Invariants.
    violations = []
    for t, name, node in binds:
        in_force = [f for ft, f in fence_log if ft <= t]
        if in_force and node in in_force[-1]:
            violations.append((name, node))
    members: dict[str, list] = {}
    for name, node in final.items():
        g = gang_of(name)
        if g:
            members.setdefault(g, []).append(node)
    split = {}
    for g, nodes in members.items():
        n = sum(x is not None for x in nodes)
        eff = stack.gang.effective_size(g)
        kind, size_g = gangs[g]
        lo = size_g // 2 if kind == "elastic" else size_g
        if n and not lo <= n <= size_g:
            split[g] = n
        if n and eff is not None and n != eff:
            split[g] = (n, eff)
    live = {p.uid for p in stack.cluster.list_pods()}
    leaked = sorted(stack.accountant.claimed_uids() - live)
    max_err = {"fleet_eval": 0, "joint_fit": 0}
    for args, weights, got in kept_fleet:
        want = kernel_mod.kernel_packed_burst(*(a.cpu() for a in args), weights)
        max_err["fleet_eval"] = max(max_err["fleet_eval"], abs_err(got, want))
    for (packed, chips_k, starts_k, valid_k), got in kept_joint:
        p = packed.cpu()
        want = kernel_mod.joint_fit_scan(p[:, 0], p[:, 3], p[:, 5], chips_k.cpu(),
                                         starts_k.cpu(), valid_k.cpu())
        for g_t, w_t in zip(got, want):
            max_err["joint_fit"] = max(max_err["joint_fit"], abs_err(g_t, w_t))
    unbound = sorted(n for n, v in final.items() if v is None)
    return dict(
        platform=platform, pods=len(names), bindings=final, phase_bindings=phase_bindings,
        passes=[{k: v for k, v in p.items() if k not in ("ms", "start", "durations_ms",
                                                          "rebind_ms")} for p in passes],
        pass_ms={p["step"]: p["ms"] for p in passes},
        durations_ms={p["step"]: p["durations_ms"] for p in passes},
        rebind_ms={p["step"]: p["rebind_ms"] for p in passes if "rebind_ms" in p},
        flips=flips, stopped=len(stopped), down=len(down), flap=len(flap),
        event_states=event_states, ghost_left=ghost_left,
        drained=rb.drained, drain_moves=rb.moves, parked_after_requeue=parked,
        reopen_fused=reopen_fused, reopen_joint_fit=reopen_joint_fit,
        unbound=unbound, violations=violations, split=split, leaked=leaked,
        overcommitted=over_capacity(stack), accounting_gap=accounting_gap(stack),
        effective_el=stack.gang.effective_size("el"),
        launches=cuda_kernel.launches, joint_fit_launches=cuda_kernel.joint_fit_launches,
        row_update_launches=kernel_mod.row_update_launches,
        phase_launches={
            p: {k: c[k] - prev[k] for k in ("fleet_eval", "joint_fit")}
            for (p, c), prev in zip(phase_launches.items(),
                                    [base, *phase_launches.values()])
        },
        # The launches of the calls held against the plain versions: one
        # fleet_eval launch per MAX_REQUESTS request rows, one joint_fit a call.
        kept_launches={
            "fleet_eval": sum(-(-args[4].shape[0] // cuda_kernel.MAX_REQUESTS)
                              for args, _, _ in kept_fleet),
            "joint_fit": len(kept_joint),
        },
        max_abs_err=max_err, dispatch_errors=batch.dispatch_errors,
        dispatch_count=batch.dispatch_count, serve_s=serve_s,
        serve_pods_per_s=size["serve"] / serve_s if serve_s else 0.0,
        rebalance_ms=rebalance_ms, reopen_ms=reopen_ms, wall_s=wall,
    )


NODEHEALTH_PARITY = ("bindings", "phase_bindings", "passes", "stopped", "down", "flap",
                     "event_states", "ghost_left", "drained", "drain_moves",
                     "parked_after_requeue", "reopen_fused", "unbound", "effective_el",
                     "dispatch_count")


def check_nodehealth_run(run: dict, size: dict) -> None:
    """The checks of one run (i) that need no second run."""
    name = f"run i ({run['platform']})"
    for key in ("violations", "split", "leaked", "overcommitted", "accounting_gap"):
        if run[key]:
            raise AssertionError(f"{name}: {key} {run[key]}")
    if run["dispatch_errors"]:
        raise AssertionError(f"{name}: {run['dispatch_errors']} dispatch errors")
    passes = {p["step"]: p for p in run["passes"]}
    empty = dict(patched=[], shrunk=[], requeued=[], deferred=[], singles=[],
                 durations_ms=[])
    if passes["i1 suspect"]["report"] != empty or passes["i1 flap"]["report"] != empty:
        raise AssertionError(f"{name}: the suspect or flap pass repaired: "
                             f"{passes['i1 suspect']['report']}, {passes['i1 flap']['report']}")
    if len(passes["i1 suspect"]["fenced"]) != size["stop"]:
        raise AssertionError(f"{name}: {len(passes['i1 suspect']['fenced'])} fenced")
    if len(passes["i1 flap"]["fenced"]) != run["down"]:
        raise AssertionError(f"{name}: the flapped hosts stayed fenced")
    rep = passes["i1 down"]["report"]
    plain = {f"p{j}" for j in range(2, size["plain"])}
    topo = {f"t{t:02d}" for t in range(size["topo"] // 2)}
    if (rep["shrunk"] != ["el"] or not plain <= set(rep["patched"])
            or set(rep["patched"]) | set(rep["requeued"]) != plain | topo
            or not rep["singles"]):
        raise AssertionError(f"{name}: the down pass repaired {rep}")
    flips = {f["step"]: f for f in run["flips"]}
    pure = flips["i1 probe"]
    if pure["restacks"] or pure["row_update_launches"] or pure["admission_patched"] != size["stop"]:
        raise AssertionError(f"{name}: the fence flip moved {pure}")
    if run["ghost_left"] or set(run["event_states"].values()) != {"down"}:
        raise AssertionError(f"{name}: ghost claims {run['ghost_left']}, "
                             f"states at event time {run['event_states']}")
    if run["drained"] != [f"t{size['topo'] - 2:02d}"]:
        raise AssertionError(f"{name}: the rebalancer drained {run['drained']}")
    if passes["i3 evacuate"]["report"]["patched"] != [f"p{size['plain'] - 2}"]:
        raise AssertionError(f"{name}: the deadline pass {passes['i3 evacuate']['report']}")
    if (passes["i4 down"]["report"]["requeued"] != ["p0", "p1"]
            or set(run["parked_after_requeue"].values()) != {0}):
        raise AssertionError(f"{name}: (i4) requeued {passes['i4 down']['report']}, "
                             f"bound after {run['parked_after_requeue']}")
    if not run["reopen_fused"]:
        raise AssertionError(f"{name}: the reopened gangs took no fused joint pass")
    lost_el = size["gang"] // 4
    if (run["effective_el"] != size["gang"] - lost_el
            or len(run["unbound"]) != lost_el
            or not all(n.startswith("el-") for n in run["unbound"])):
        raise AssertionError(f"{name}: unbound {run['unbound']}, el at {run['effective_el']}")


def check_nodehealth(g: dict, c: dict, size: dict) -> None:
    """Run (i) on the card against the same script on the CPU: every
    decision equal, every check of each run, the card run's kernels where
    they must launch and equal to their plain versions."""
    diff = [k for k in NODEHEALTH_PARITY if g[k] != c[k]]
    if diff:
        raise AssertionError(f"run i: cuda != cpu in {diff}")
    patched = [(f["step"], f["admission_patched"]) for f in g["flips"]]
    if patched != [(f["step"], f["admission_patched"]) for f in c["flips"]]:
        raise AssertionError("run i: admission rows patched differently on cuda and cpu")
    check_nodehealth_run(g, size)
    check_nodehealth_run(c, size)
    if c["launches"] or c["joint_fit_launches"] or c["row_update_launches"]:
        raise AssertionError("run i: the CPU run launched on the card")
    if not (g["phase_launches"]["i1"]["fleet_eval"] and g["reopen_joint_fit"]):
        raise AssertionError(f"run i: launches {g['phase_launches']}, "
                             f"joint_fit at the reopen {g['reopen_joint_fit']}")
    launched = {"fleet_eval": g["launches"], "joint_fit": g["joint_fit_launches"]}
    if g["kept_launches"] != launched:
        raise AssertionError(f"run i: {g['kept_launches']} launches held against the "
                             f"plain versions, {launched} launched")
    if g["max_abs_err"] != {"fleet_eval": 0, "joint_fit": 0}:
        raise AssertionError(f"run i: kernels differ from their plain versions: "
                             f"{g['max_abs_err']}")


def print_nodehealth(run: dict, smi: str) -> None:
    """Run (i)'s measurements, less its bindings, states and reports."""
    summary = {k: v for k, v in run.items()
               if k not in ("bindings", "phase_bindings", "passes")}
    summary["reports"] = {p["step"]: {k: v for k, v in p["report"].items() if v}
                          for p in run["passes"]}
    print(f"node health (i) {run['platform']} [{smi}]:", json.dumps(summary))


# Threads of the process that reruns run (h) on the CPU beside the card's
# phases: the card's are host-bound on one core, and the machine has eight.
CPU_RERUN_THREADS = 2


def cpu_rerun_child(conn, size: dict, nodehealth_size: "dict | None") -> None:
    """The body of the CPU rerun process: run (h)'s (h1)-(h3) and, given its
    size, run (i) on kernel_platform "cpu", sent back whole ({"h": ...,
    "i": ... or None}) or as the error that stopped them."""
    torch.set_num_threads(CPU_RERUN_THREADS)
    try:
        h = run_background("cpu", size, threaded=False)
        i = None if nodehealth_size is None else run_nodehealth("cpu", nodehealth_size)
        conn.send(("ok", {"h": h, "i": i}))
    except BaseException as e:  # noqa: BLE001 — the parent reports it
        conn.send(("error", f"{type(e).__name__}: {e}"))
    conn.close()


class CpuRerun:
    """The CPU runs of run (h) and, given ``nodehealth_size``, run (i) in a
    second process (spawned: the parent holds a CUDA context), started when
    the kernels are built so that it overlaps the card's phases instead of
    following them; :meth:`result` waits for it and returns run (h),
    :meth:`nodehealth` returns run (i), and :meth:`stop` ends the process
    if it still runs."""

    def __init__(self, size: dict = BACKGROUND_FULL,
                 nodehealth_size: "dict | None" = None) -> None:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._recv, send = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=cpu_rerun_child,
                                 args=(send, size, nodehealth_size), daemon=True)
        self._proc.start()
        send.close()
        self._value: "dict | None" = None

    def _wait(self, timeout_s: float) -> dict:
        if self._value is None:
            if not self._recv.poll(timeout_s):
                raise TimeoutError(f"the CPU rerun sent nothing in {timeout_s} s")
            status, value = self._recv.recv()
            self._proc.join(timeout=30)
            if status != "ok":
                raise RuntimeError(f"the CPU rerun failed: {value}")
            self._value = value
        return self._value

    def result(self, timeout_s: float = 600.0) -> dict:
        return self._wait(timeout_s)["h"]

    def nodehealth(self, timeout_s: float = 600.0) -> "dict | None":
        return self._wait(timeout_s)["i"]

    def stop(self) -> None:
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=10)


def check_threaded_nospec(run: dict) -> None:
    """(h4) with the speculative cache off: the serve path's invariants,
    and no launch or plan from the cache."""
    name = "run h4 (speculation off)"
    if run["overcommitted"] or run["accounting_gap"]:
        raise AssertionError(f"{name}: over capacity {run['overcommitted']}, "
                             f"accounting != bound pods at {run['accounting_gap']}")
    if run["alive"] or run["errors"] or run["dispatch_errors"]:
        raise AssertionError(f"{name}: thread alive {run['alive']}, errors "
                             f"{run['errors']}, dispatch errors {run['dispatch_errors']}")
    if run["bound"] != run["pods"] or set(run["gangs"].values()) != {4}:
        raise AssertionError(f"{name}: {run['bound']}/{run['pods']} bound, gangs {run['gangs']}")
    if run["spec_launches"] or run["consumed"] or not run["serve_launches"]:
        raise AssertionError(f"{name}: {run['spec_launches']} speculation launches, "
                             f"{run['consumed']} plans consumed, {run['serve_launches']} "
                             f"serve launches")


Q9_KEYS = ("spec_enabled", "window_pods", "pick_check_failures", "burst_invalidated",
           "burst_dispatches", "burst_served", "serve_dispatches",
           "serve_dispatches_per_pod", "serve_launches", "serve_launches_per_pod",
           "consumed", "spec_launches", "pods_per_s", "p50_ms", "p99_ms", "wall_s")


def phase_background(smi: str, rerun: CpuRerun) -> dict:
    g = run_background("auto")
    c = rerun.result()
    print_background(g, smi)
    print_background(c, smi)
    check_background(g, c, BACKGROUND_FULL)
    # PERF.md section 7, Q9: the same (h4) window with speculation off.
    g["h4_nospec"] = run_threaded("auto", BACKGROUND_FULL, spec_enabled=False)
    check_threaded_nospec(g["h4_nospec"])
    for run in (g["h4"], g["h4_nospec"]):
        print(f"background (h4) serve-time checks [{smi}]:",
              json.dumps({k: run[k] for k in Q9_KEYS}))
    return g


def phase_nodehealth(smi: str, rerun: CpuRerun) -> dict:
    g = run_nodehealth("auto")
    c = rerun.nodehealth()
    print_nodehealth(g, smi)
    print_nodehealth(c, smi)
    check_nodehealth(g, c, NODEHEALTH_FULL)
    return g


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    seconds: dict[str, float] = {}

    def phase(label: str, fn, *args):
        t = time.monotonic()
        try:
            out = fn(*args)
        except Exception as e:  # noqa: BLE001 — report the failing phase
            fail(label, e)
        seconds[label] = time.monotonic() - t
        return out

    kind, smi = phase("device/build", phase_device)
    rerun = CpuRerun(BACKGROUND_FULL, NODEHEALTH_FULL)
    try:
        rows, profiled = phase("kernel vs plain", phase_kernel)
        joint_rows = phase("joint_fit vs plain", phase_joint_fit)
        update_rows = phase("update_rows vs put_static", phase_update_rows)
        gpu = phase("main path", phase_main_path, smi)
        gangs = phase("gang path", phase_gang_path, smi)
        churn = phase("churn run (e)", phase_churn, smi)
        preemption = phase("preemption run (f)", phase_preemption, smi)
        affinity = phase("affinity run (g)", phase_affinity, smi)
        wide = phase("wide fleet", phase_wide_fleet, smi)
        background = phase("background run (h)", phase_background, smi, rerun)
        nodehealth = phase("node health run (i)", phase_nodehealth, smi, rerun)
        print("phase seconds:", json.dumps(seconds))
        h_runs = [background[part] for part in ("h1", "h2", "h3", "h4", "h4_nospec")]
        main_row = next(
            r for r in profiled
            if (r["nodes"], r["padded"], r["k"]) == MAIN_PATH_SHAPE and r["chips"] == CHIPS
        )
        joint_main = next(
            r for r in joint_rows
            if r["case"] == "seeded" and (r["k"], r["n"]) == JOINT_MAIN_SHAPE
        )
        update_main = next(
            r for r in update_rows if (r["padded"], r["rows"]) == UPDATE_MAIN_SHAPE
        )
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
                    "launches": sum(run["launches"] for run in (
                        gpu["a"], gpu["b"], gangs["c"], gangs["d"], churn, preemption,
                        affinity, *wide, *h_runs, nodehealth)),
                    "launches_run_g": affinity["launches"],
                    "launches_run_i": {
                        part: n["fleet_eval"] for part, n in nodehealth["phase_launches"].items()
                    },
                    "run_g_k1_device_ms": not_measured(affinity["fleet_eval_k1_device_ms"]),
                    "run_g_k1_ms": not_measured(affinity["fleet_eval_k1_ms"]),
                    "run_g_k1_plain_ms": not_measured(affinity["fleet_eval_k1_plain_ms"]),
                    "launches_run_h": {
                        part: background[part]["launches"]
                        for part in ("h1", "h2", "h3", "h4", "h4_nospec")
                    },
                    "launches_run_h_speculation": {
                        "h1": background["h1"]["spec_launches"],
                        "h4": background["h4"]["spec_launches"],
                    },
                    "run_h_spec_k1_device_ms": not_measured(
                        background["h1"]["concurrent"]["alone_device_ms"]),
                    "run_h_concurrent_k1_ms": {
                        k: not_measured(v) for k, v in background["h1"]["concurrent"].items()
                    },
                    "max_abs_err": max(max(r["max_abs_err"] for r in rows),
                                       nodehealth["max_abs_err"]["fleet_eval"]),
                    "ms": main_row["ms"],
                    "plain_ms": main_row["plain_ms"],
                    "bound_ms": main_row["bound_ms"],
                    "bound_by": main_row["bound_by"],
                    "library_ms": None,
                    "device_ms": not_measured(main_row["device_ms"]),
                    "round_trip_ms": main_row["round_trip_ms"],
                    "cuda_launches_per_call": not_measured(main_row["launches_per_call"]),
                    "shapes": [
                        {
                            key: not_measured(r.get(key))
                            for key in ("padded", "chips", "k", "ms", "device_ms",
                                        "launches_per_call", "plain_ms", "bound_ms",
                                        "bound_by", "plan", "round_trips_ms", "smi")
                        }
                        for r in profiled
                    ],
                },
                {
                    "name": "joint_fit",
                    "route": "cuda",
                    "source": "yoda_tpu_torch/csrc/joint_fit.cu",
                    "replaces": (
                        "yoda_tpu/ops/kernel.py:500 joint_fit_scan "
                        "(lax.scan in kernel_joint_plan, :581)"
                    ),
                    "launches": gangs["c"]["joint_fit_launches"]
                    + gangs["d"]["joint_fit_launches"] + preemption["joint_fit_launches"]
                    + affinity["joint_fit_launches"]
                    + sum(run["joint_fit_launches"] for run in h_runs[1:])
                    + nodehealth["joint_fit_launches"],
                    "launches_run_i": {
                        part: n["joint_fit"] for part, n in nodehealth["phase_launches"].items()
                    },
                    "max_abs_err": max(max(r["max_abs_err"] for r in joint_rows),
                                       nodehealth["max_abs_err"]["joint_fit"]),
                    "ms": joint_main["ms"],
                    "device_ms": not_measured(joint_main["device_ms"]),
                    "plain_ms": joint_main["plain_ms"],
                    "bound_ms": joint_main["bound_ms"],
                    "bound_by": "bytes",
                    "library_ms": None,
                    "main_path_device_ms": {
                        run: not_measured(gangs[run]["joint_fit_device_ms"])
                        for run in ("c", "d")
                    },
                    "shapes": [
                        {
                            key: not_measured(r.get(key))
                            for key in ("case", "k", "n", "ms", "device_ms", "us_per_row",
                                        "plain_ms", "bound_ms", "plan", "smi")
                        }
                        for r in joint_rows
                    ],
                },
            ],
            # The resident row update is a torch op, not a hand kernel (the
            # reference's XLA scatter, yoda_tpu/ops/kernel.py:662): launches are
            # runs (e)-(h)'s update_rows calls on the card, times at the main
            # path's fleet with 64 rows.
            "torch_ops": [
                {
                    "name": "update_rows",
                    "route": "torch",
                    "source": "yoda_tpu_torch/ops/kernel.py (TorchFleetKernel.update_rows)",
                    "replaces": "yoda_tpu/ops/kernel.py:662 apply_row_update (jitted :671)",
                    "launches": churn["row_update_launches"]
                    + preemption["row_update_launches"] + affinity["row_update_launches"]
                    + sum(run["row_update_launches"] for run in h_runs)
                    + nodehealth["row_update_launches"],
                    "launches_run_h_speculation": background["h1"]["spec_row_updates"],
                    "max_abs_err": max(r["max_abs_err"] for r in update_rows),
                    "ms": update_main["ms"],
                    "plain_ms": update_main["put_static_ms"],
                    "bound_ms": update_main["bound_ms"],
                    "bound_by": "bytes",
                    "library_ms": update_main["library_ms"],
                    "shapes": [
                        {key: r[key] for key in ("padded", "rows", "ms", "put_static_ms",
                                                 "library_ms", "bound_ms", "smi")}
                        for r in update_rows
                    ],
                },
            ],
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
    finally:
        rerun.stop()


if __name__ == "__main__":
    main()
