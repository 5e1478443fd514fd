"""One run of one cell: set-up, the measured window, the reference's
verdict and the metrics.

Everything a cell is made of is found by name: its configuration file
(``BENCHMARK.json``'s ``configs[].file``), its traffic mix
(``portbench/traffic/<traffic>.json``), the mix's generator
(``portbench/generators/<kind>.py``) and each metric's reader
(``portbench/metrics/<name>.py``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from portbench.harness import fleet as fleet_mod
from portbench.harness import port, reference

FORBIDDEN = ("jax", "jaxlib", "flax", "yoda_tpu")


def load_module(path: Path):
    """A module from a file, under a name made from its path."""
    name = "portbench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    generator: object
    end_to_end: list          # metric entries this cell reports
    per_layer: list


def find_cell(root: Path, bench: dict, name: str) -> Cell:
    """The cell ``name`` of ``bench`` with its parts loaded by name."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg_file = root / cfg_entry["file"]
    mix_file = root / "portbench" / "traffic" / f"{cell['traffic']}.json"
    config = json.loads(cfg_file.read_text())
    mix = json.loads(mix_file.read_text())
    generator = load_module(root / "portbench" / "generators" / f"{mix['kind']}.py")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}

    def reports(m: dict) -> bool:
        if "workloads" in m:
            return name in m["workloads"]
        return m["moves"] in reported

    return Cell(name, config, mix, generator, e2e,
                [m for m in bench["per_layer"] if reports(m)])


@dataclass
class Run:
    """What a run leaves for the metric readers and the reference."""

    cell: str
    setup_s: float = 0.0
    t_start: float = 0.0
    t_end: float = 0.0
    events: list = field(default_factory=list)
    latency0: dict = field(default_factory=dict)
    latency1: dict = field(default_factory=dict)
    eval_s: list = field(default_factory=list)
    evaluations: list = field(default_factory=list)   # reference.Evaluation
    batches: list = field(default_factory=list)       # reference.Batch
    publishes: list = field(default_factory=list)     # unix times of the CRs
    launches: list = field(default_factory=list)   # (kernel, least seconds)
    trace: "dict | None" = None
    counters: dict = field(default_factory=dict)


class EvalTimer:
    """Host seconds of each evaluation round trip of the stack's kernel
    object: a wrapper around its evaluate_burst and evaluate_joint_plan."""

    def __init__(self, kern) -> None:
        self.calls: list = []
        self.active = False
        for name in ("evaluate_burst", "evaluate_joint_plan"):
            inner = getattr(kern, name)
            setattr(kern, name, self._wrap(inner))

    def _wrap(self, inner):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                if self.active:
                    self.calls.append(time.perf_counter() - t)
        return timed


class LaunchShapes:
    """The least time of every fleet_eval launch in the window, from the
    shapes its wrapper is called with."""

    def __init__(self) -> None:
        from portbench.harness import roofline
        from yoda_tpu_torch.ops import cuda_kernel

        self.launches: list = []
        self.active = False
        self._mod = cuda_kernel
        fe = cuda_kernel.fleet_eval

        def fleet_eval(chips, nodes, dyn, host_ok_k, reqs_k, *a, **kw):
            if self.active and chips.device.type == "cuda":
                _, c, n = chips.shape
                for s in roofline.fleet_eval_call(n, c, reqs_k.shape[0]):
                    self.launches.append(("fleet_eval", s))
            return fe(chips, nodes, dyn, host_ok_k, reqs_k, *a, **kw)

        self._orig = fe
        cuda_kernel.fleet_eval = fleet_eval

    def close(self) -> None:
        self._mod.fleet_eval = self._orig


class Evaluations:
    """When the program evaluated, when it began to read the state each
    evaluation ran on, and for which pods: a wrapper on the stack's kernel
    object's round trips and on the batch plugin's burst and filter passes.
    The reference takes from it the times and the order in which pods are
    served, and works every value out itself."""

    def __init__(self, stack) -> None:
        self.log: list = []
        self._open: "list | None" = None
        self._t_read: "float | None" = None
        kern, batch = stack.batch._kern, stack.batch
        for name in ("evaluate_burst", "evaluate_joint_plan"):
            setattr(kern, name, self._call(getattr(kern, name)))
        batch.prepare_burst = self._burst(batch.prepare_burst)
        batch.filter_and_score_batch = self._reading(batch.filter_and_score_batch)

    def _reading(self, inner):
        def pass_(*args, **kwargs):
            self._t_read = time.monotonic()
            try:
                return inner(*args, **kwargs)
            finally:
                self._t_read = None
        return pass_

    def _call(self, inner):
        def call(*args, **kwargs):
            e = reference.Evaluation(time.monotonic(), self._t_read)
            self.log.append(e)
            if self._open is not None:
                self._open.append(e)
            return inner(*args, **kwargs)
        return call

    def _burst(self, inner):
        def prepare_burst(pods, snapshot):
            self._open = []
            self._t_read = time.monotonic()
            try:
                return inner(pods, snapshot)
            finally:
                for e in self._open:
                    e.groups = [[p.key for p in pods]]
                self._open = None
                self._t_read = None
        return prepare_burst


class Batches:
    """When the program's ingest applied each batch of watch events, and
    which pods it carried: a wrapper on the batcher's apply and on the
    informer's batch handler. The reference takes from it when each event
    was folded in, and works every value out itself."""

    def __init__(self, stack) -> None:
        self.log: list = []
        self._mid = None
        ing, informer = stack.ingestor, stack.informer
        if ing is None:
            return
        apply, handle = ing.apply_fn, informer.handle_batch

        def handle_batch(events):
            self._mid = time.monotonic()
            return handle(events)

        def apply_fn(events):
            t0 = time.monotonic()
            self._mid = None
            try:
                return apply(events)
            finally:
                t1 = time.monotonic()
                keys = frozenset(e.obj.key for e in events
                                 if e.kind == "Pod" and e.obj is not None)
                self.log.append(reference.Batch(t0, self._mid or t1, t1, keys))

        informer.handle_batch = handle_batch
        ing.apply_fn = apply_fn


def int16_claims(kern) -> None:
    """Control ``int16``: the program with each evaluation's per-node
    dynamics (reservations in chips, claims in MiB) uploaded in int16, the
    step that halving the round trip's upload would take. Breaks the exact
    int32 arithmetic the configuration states: a host's claims pass 32,767
    MiB."""
    import numpy as np

    burst = kern.evaluate_burst
    plan = kern.evaluate_joint_plan

    def narrow(dyn):
        return np.asarray(dyn).astype(np.int16).astype(np.int32)

    kern.evaluate_burst = lambda dyn, *a, **kw: burst(narrow(dyn), *a, **kw)
    kern.evaluate_joint_plan = lambda dyn, *a, **kw: plan(narrow(dyn), *a, **kw)


CONTROLS = {"int16": int16_claims}


def run_cell(root: Path, bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, *, t_process: float, platform: "str | None" = None,
             adjust=None, fault=None, control: "str | None" = None) -> dict:
    """Run ``cell_name`` once; returns the result line's fields plus the
    verdict's numbers. ``platform`` overrides the configuration's kernel
    platform (tests run on the CPU), ``adjust`` maps the configuration and
    mix to other ones (a smaller copy in the tests), ``fault`` plants a
    fault in the built stack (tests) and ``control`` names a control to run
    (CONTROLS)."""
    cell = find_cell(root, bench, cell_name)
    cfg, mix = cell.config, cell.mix
    if adjust is not None:
        cfg, mix = adjust(cfg, mix)
    settings = cfg["settings"]
    fleet = fleet_mod.build_fleet(cfg)
    prefill = fleet_mod.build_prefill(fleet, cfg, cfg["prefill"]["mix"], seed)
    reqs = {req.key: req for req, _ in prefill.pods}
    traffic = cell.generator.Traffic(mix, fleet, seed, reqs, settings, seconds)
    cluster, stack, rec = port.build(settings, fleet, prefill, reqs, platform=platform)
    on_card = stack.batch.device.type == "cuda"
    ctx = _ctx(cluster, stack, rec, reqs, fleet)
    traffic.warmup(ctx)
    run = Run(cell_name)
    resident = stack.batch._resident
    if resident is not None and resident.restacks == 1:
        run.counters["first_restack_ms"] = resident.last_restack_ms
    evaluations = Evaluations(stack)
    batches = Batches(stack)
    if control is not None:
        CONTROLS[control](stack.batch._kern)
    if fault is not None:
        fault(stack, cluster)
    timer = shapes = dtrace = None
    if trace:
        from portbench.harness.trace import DeviceTrace

        timer = EvalTimer(stack.batch._kern)
        if on_card:
            shapes = LaunchShapes()
            dtrace = DeviceTrace()
    if on_card:
        import torch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    stop = threading.Event()
    loop = threading.Thread(target=stack.scheduler.serve_forever, args=(stop,),
                            kwargs={"poll_s": 0.05}, name="serve-loop")
    run.latency0 = port.latency_series(stack)
    if timer is not None:
        timer.active = True
    if shapes is not None:
        shapes.active = True
    if dtrace is not None:
        dtrace.start()
    # The agents' heartbeat right before the window (after the profiler's
    # start, which takes seconds): no agent runs in the window, and every
    # node stays fresh (max_metrics_age_s) through it.
    run.publishes.append(time.time())
    port.publish(cluster, fleet, prefill, run.publishes[-1], nodes=False)
    ctx.flush()
    loop.start()
    run.t_start = time.monotonic()
    run.setup_s = run.t_start - t_process
    try:
        traffic.drive(ctx, run.t_start, run.t_start + seconds)
        run.t_end = run.t_start + seconds
        run.latency1 = port.latency_series(stack)
        if dtrace is not None:
            dtrace.stop()
        if timer is not None:
            timer.active = False
        if shapes is not None:
            shapes.active = False
        # Cancel what is still pending, so that once the program has taken
        # the deletions in, every claim it holds is one of a bound pod.
        with rec.cond:
            pending = sorted(rec.pending)
        for key in pending:
            ctx.delete(key)
        ctx.flush()
        held_by_program = _settled_claims(stack, rec)
    finally:
        stop.set()
        loop.join(timeout=60)
    if loop.is_alive():
        raise RuntimeError("the serve loop did not stop")
    memory_peak = 0
    if on_card:
        import torch

        torch.cuda.synchronize()
        memory_peak = int(torch.cuda.max_memory_allocated())
    if shapes is not None:
        shapes.close()
        run.launches = shapes.launches
    if timer is not None:
        run.eval_s = timer.calls
    if dtrace is not None:
        from portbench.harness.trace import reduce_ops

        run.trace = reduce_ops(dtrace.device_ops(), run.t_end - run.t_start)
    stack.close()
    del stack, ctx, cluster
    gc.collect()
    if on_card:
        import torch

        torch.cuda.empty_cache()
    with rec.cond:
        run.events = list(rec.events)
    run.evaluations = evaluations.log
    run.batches = batches.log
    verdict = judge(cfg, settings, fleet, prefill, reqs, run, traffic.sample(),
                    held_by_program)
    return dict(run=run, verdict=verdict, cell=cell, memory_peak=memory_peak,
                on_card=on_card,
                inputs=(cfg, settings, fleet, prefill, reqs, traffic.sample(),
                        held_by_program))


def _ctx(cluster, stack, rec, reqs, fleet):
    from portbench.harness.traffic import Ctx

    def run_until_idle():
        stack.scheduler.run_until_idle(max_wall_s=120)

    def flush():
        if stack.ingestor is not None:
            stack.ingestor.flush()

    return Ctx(cluster, rec, reqs, fleet, run_until_idle, flush)


def _settled_claims(stack, rec, timeout_s: float = 10.0) -> dict:
    """The program's claims per host once they agree with the pods bound,
    or as they stand after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while True:
        held = {h: n for h, n in stack.accountant.chips_by_node().items() if n}
        with rec.cond:
            want = {h: n for h, n in rec.held.items() if n}
        if held == want or time.monotonic() > deadline:
            return held
        time.sleep(0.05)


def judge(cfg, settings, fleet, prefill, reqs, run: Run, sample: set,
          held_by_program: dict):
    """The reference's verdict on a run: each number compared, with its
    limit (every limit is 0: the comparisons are exact)."""
    st = reference.Static.build(fleet, prefill.used)
    replay = reference.Replay(
        st, reqs, settings, cfg["fleet"]["generation_rank"], run.publishes,
        run.evaluations, sample=sample, batches=run.batches,
    )
    replay.prefill(prefill.pods)
    for e in run.events:
        if not (e.kind == "add" and e.node):  # the pre-fill, already held
            replay.on_event(e)
    leaked = sum(
        1 for name in st.names
        if int(held_by_program.get(name, 0)) != int(replay.reserved[st.index[name]])
    )
    v = reference.Verdict()
    for name, value in (
        ("wrong_node", replay.counts["wrong_node"]),
        ("infeasible_bind", replay.counts["infeasible_bind"]),
        ("over_chips", replay.counts["over_chips"]),
        ("leaked_claims", leaked),
    ):
        v.numbers[name] = (value, 0)
    depth = replay.fold_depth
    v.notes.append(f"picks_checked {replay.checked} of {replay.sampled_bound} sampled "
                   f"binds ({replay.unjudged} served by no logged evaluation)")
    if depth:
        v.notes.append(f"fold_depth_max {max(depth)} "
                       f"deeper_than_0 {sum(d > 0 for d in depth)}")
    return v
