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
   and PostFilter ms per call. Last, a fleet of 40-chip and 8-chip hosts
   (the wide kernel on the main path) at K = 1 and 16 must bind as on the
   CPU.
4. One line {"kernels": [...]} with each kernel's launches over every run
   above, its largest difference from the plain version and its times
   ("not measured" where the profiler saw no device activity).

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


def build_fleet(platform: str, burst: int, pools: "dict[str, str] | None" = None):
    """The 5,000-node fleet's stack and its agent: 512 v5p 2x2x1 slices and
    2,952 v5e hosts, published by the port's FakeTpuAgent. With ``pools``
    every host gets a Node object, labelled pool=<its pool> where ``pools``
    names it."""
    from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
    from yoda_tpu_torch.api.types import K8sNode
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.standalone import build_stack

    stack = build_stack(
        config=SchedulerConfig(kernel_platform=platform, batch_requests=burst)
    )
    agent = FakeTpuAgent(stack.cluster)
    hosts = []
    for s in range(512):
        hosts += agent.add_slice(f"v5p-{s:03d}", generation="v5p", host_topology=(2, 2, 1))
    for h in range(2952):
        agent.add_host(f"v5e-{h:04d}", generation="v5e", chips=8)
        hosts.append(f"v5e-{h:04d}")
    if pools is not None:
        for name in hosts:
            pool = pools.get(name)
            stack.cluster.put_node(K8sNode(name, labels={"pool": pool} if pool else {}))
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


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    try:
        kind, smi = phase_device()
    except Exception as e:  # noqa: BLE001 — report the failing phase
        fail("device/build", e)
    try:
        rows, profiled = phase_kernel()
    except Exception as e:  # noqa: BLE001
        fail("kernel vs plain", e)
    try:
        joint_rows = phase_joint_fit()
    except Exception as e:  # noqa: BLE001
        fail("joint_fit vs plain", e)
    try:
        update_rows = phase_update_rows()
    except Exception as e:  # noqa: BLE001
        fail("update_rows vs put_static", e)
    try:
        gpu = phase_main_path(smi)
    except Exception as e:  # noqa: BLE001
        fail("main path", e)
    try:
        gangs = phase_gang_path(smi)
    except Exception as e:  # noqa: BLE001
        fail("gang path", e)
    try:
        churn = phase_churn(smi)
    except Exception as e:  # noqa: BLE001
        fail("churn run (e)", e)
    try:
        preemption = phase_preemption(smi)
    except Exception as e:  # noqa: BLE001
        fail("preemption run (f)", e)
    try:
        wide = phase_wide_fleet(smi)
    except Exception as e:  # noqa: BLE001
        fail("wide fleet", e)
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
                    *wide)),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
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
                + gangs["d"]["joint_fit_launches"] + preemption["joint_fit_launches"],
                "max_abs_err": max(r["max_abs_err"] for r in joint_rows),
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
        # runs (e) and (f)'s update_rows calls on the card, times at the
        # main path's fleet with 64 rows.
        "torch_ops": [
            {
                "name": "update_rows",
                "route": "torch",
                "source": "yoda_tpu_torch/ops/kernel.py (TorchFleetKernel.update_rows)",
                "replaces": "yoda_tpu/ops/kernel.py:662 apply_row_update (jitted :671)",
                "launches": churn["row_update_launches"]
                + preemption["row_update_launches"],
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


if __name__ == "__main__":
    main()
