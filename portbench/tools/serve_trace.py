"""Run a cell with the program's serve-loop instrumentation read from
inside, and name each idle gap of the device trace by the program spans
that cover it.

    python3 portbench/tools/serve_trace.py --workload batch5k.singles-backlog \\
        --seeds 11,12 --seconds 50 [--trace 1] [--capacity 1000000]

Each run prints one JSON line: the result line's metrics (the per-layer
ones with ``--trace 1``), the three shares read from the program's
families over the window (``gc_pause_pct``, ``ingest_busy_pct``,
``serve_cpu_pct``), one burst of the window accounted for (the burst
phase, the cycles and the serve thread's busy wall time per burst), and
with ``--trace 1`` on a card the ten longest idle gaps, each named by the
program spans that cover it (``program_trace.name_gaps``), with the
share of the device's time that lies inside a program span once mapped
(the check of the clock mapping). The span ring is raised to
``--capacity`` so that it holds the whole window; the cell's files are
not changed. This tool is not run by the benchmark."""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import port, program_trace, runner  # noqa: E402
from portbench.harness import trace as trace_mod  # noqa: E402


class Probe:
    """The run's hooks: the stack (kept past the run for its span ring),
    the program's families at the window's edges (the serve loop's start
    and the harness's closing read of the latency histogram) and the
    device trace's operations with its clock base."""

    def __init__(self) -> None:
        self.stack = None
        self.t0: dict = {}
        self.t1: dict = {}
        self.ops: list = []
        self.base_us = None
        self._saved = []

    def install(self, stack, cluster) -> None:
        self.stack = stack
        serve = stack.scheduler.serve_forever

        def serve_forever(*a, **kw):
            self.t0 = program_trace.family_totals(stack)
            return serve(*a, **kw)

        stack.scheduler.serve_forever = serve_forever

    def __enter__(self) -> "Probe":
        latency_series = port.latency_series
        device_ops = trace_mod.DeviceTrace.device_ops

        def read_latency(stack):
            self.t1 = program_trace.family_totals(stack)
            return latency_series(stack)

        def read_ops(dtrace):
            # A profile exports once: read its clock base from that export.
            export = dtrace._prof.export_chrome_trace

            def export_and_read_base(path):
                export(path)
                self.base_us = program_trace.trace_base_us(path)

            dtrace._prof.export_chrome_trace = export_and_read_base
            self.ops = device_ops(dtrace)
            return self.ops

        self._saved = [(port, "latency_series", latency_series),
                       (trace_mod.DeviceTrace, "device_ops", device_ops)]
        port.latency_series = read_latency
        trace_mod.DeviceTrace.device_ops = read_ops
        return self

    def __exit__(self, *exc) -> bool:
        for owner, name, value in self._saved:
            setattr(owner, name, value)
        return False


def with_capacity(capacity: int, adjust=None):
    def adjusted(cfg: dict, mix: dict):
        if adjust is not None:
            cfg, mix = adjust(cfg, mix)
        cfg = copy.deepcopy(cfg)
        cfg["settings"]["trace_capacity"] = capacity
        return cfg, mix
    return adjusted


def burst_account(run, t0: dict, t1: dict) -> "dict | None":
    """One burst of the window: the burst phase, the cycles it serves by
    path, and the serve thread's busy wall and CPU time per burst, with
    what the phases leave of the busy time."""
    def delta(phase):
        s0, n0 = run.latency0.get(phase, (0.0, 0))
        s1, n1 = run.latency1.get(phase, (0.0, 0))
        return s1 - s0, n1 - n0

    b_s, bursts = delta("burst")
    if bursts <= 0:
        return None
    c_s, cycles = delta("total")
    r_s, rows = delta("filter_burst_row")
    d_s, fresh = delta("filter_dispatch")
    busy0 = t0.get("yoda_serve_busy_seconds_total", {})
    busy1 = t1.get("yoda_serve_busy_seconds_total", {})
    wall = busy1.get('clock="wall"', 0.0) - busy0.get('clock="wall"', 0.0)
    cpu = busy1.get('clock="cpu"', 0.0) - busy0.get('clock="cpu"', 0.0)
    gc_s = (program_trace._sum_of(t1, "yoda_gc_pause_seconds") or 0.0) - (
        program_trace._sum_of(t0, "yoda_gc_pause_seconds") or 0.0)
    ing_s = (program_trace._sum_of(t1, "yoda_ingest_apply_seconds") or 0.0) - (
        program_trace._sum_of(t0, "yoda_ingest_apply_seconds") or 0.0)
    per = 1e3 / bursts
    return dict(
        bursts=bursts, cycles=cycles, cycles_per_burst=cycles / bursts,
        burst_ms=b_s * per, cycles_ms=c_s * per, cycle_ms=c_s / max(cycles, 1) * 1e3,
        burst_row_cycles=rows, burst_row_ms=r_s / max(rows, 1) * 1e3,
        dispatch_cycles=fresh, dispatch_ms=d_s / max(fresh, 1) * 1e3,
        busy_wall_ms=wall * per, busy_cpu_ms=cpu * per,
        gc_ms=gc_s * per, ingest_ms=ing_s * per,
        remainder_ms=(wall - b_s - c_s) * per,
    )


def run_one(root: Path, bench: dict, cell: str, seed: int, seconds: float,
            trace: bool, *, capacity: int = 1_000_000, platform=None,
            adjust=None) -> dict:
    run_py = runner.load_module(root / "portbench" / "run.py")
    probe = Probe()
    with probe:
        out = runner.run_cell(root, bench, cell, seed, seconds, trace,
                              t_process=time.monotonic(), platform=platform,
                              adjust=with_capacity(capacity, adjust),
                              fault=probe.install)
    run = out["run"]
    window = run.t_end - run.t_start
    t0, t1 = probe.t0, probe.t1
    line = dict(
        seed=seed, correct=out["verdict"].correct,
        metrics={k: v["value"] for k, v in run_py.result_line(out, trace)["metrics"].items()}
        if out["on_card"] else {},
        gc_pause_pct=program_trace.gc_pause_pct(t0, t1, window),
        ingest_busy_pct=program_trace.ingest_busy_pct(t0, t1, window),
        serve_cpu_pct=program_trace.serve_cpu_pct(t0, t1),
        burst=burst_account(run, t0, t1),
        gc_collections=program_trace.counts(t0, t1, "yoda_gc_pause_seconds"),
        ingest_applies=program_trace.counts(t0, t1, "yoda_ingest_apply_seconds"),
    )
    tracer = probe.stack.metrics.tracer
    lo, hi = run.t_start + tracer.unix_offset, run.t_end + tracer.unix_offset
    spans = [s for s in program_trace.unix_spans(tracer.records())
             if s[2] > lo and s[1] < hi]
    line["spans"] = len(spans)
    line["span_drops"] = tracer.dropped
    if run.trace is not None and probe.base_us is not None:
        line["busy_s"] = run.trace["busy_s"]
        line["idle_gaps"] = program_trace.name_gaps(probe.ops, probe.base_us, spans)
        line["reduce_ops_gaps"] = run.trace["breakdown"]["idle_gaps"]
        line["device_time_inside_spans_pct"] = program_trace.ops_inside(
            probe.ops, probe.base_us, spans)
    return line


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=50)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--capacity", type=int, default=1_000_000)
    args = ap.parse_args()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(run_one(ROOT, bench, args.workload, seed, args.seconds,
                                 bool(args.trace), capacity=args.capacity)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
