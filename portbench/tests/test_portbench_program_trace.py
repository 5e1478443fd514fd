"""The program's serve-loop instrumentation read from outside: the two
phase readers and the three family shares on a small CPU run, and the
naming of the device trace's idle gaps by program spans, which leaves
the gaps' seconds and the busy time as ``trace.reduce_ops`` computes
them."""

import random

import pytest

from portbench.harness import program_trace, runner
from portbench.harness.trace import reduce_ops
from small import ROOT, run_small

CELL = "batch5k.singles-backlog"


def _serve_trace():
    return runner.load_module(ROOT / "portbench" / "tools" / "serve_trace.py")


@pytest.fixture(scope="module")
def traced_small_run():
    tool = _serve_trace()
    probe = tool.Probe()
    with probe:
        out = run_small(CELL, seconds=3.0, fault=probe.install)
    return tool, probe, out


def test_the_new_phase_readers_read_a_small_cpu_run(traced_small_run):
    _tool, _probe, out = traced_small_run
    assert out["verdict"].correct, out["verdict"].numbers
    for name in ("burst_prep_ms.pods", "burst_row_ms.pods"):
        value = runner.load_module(ROOT / "portbench" / "metrics" / f"{name}.py").read(out["run"])
        assert value is not None and value > 0, name


def test_the_family_shares_read_a_small_cpu_run(traced_small_run):
    tool, probe, out = traced_small_run
    run = out["run"]
    window = run.t_end - run.t_start
    assert set(probe.t0) == set(probe.t1) == set(program_trace.FAMILIES)
    gc_pct = program_trace.gc_pause_pct(probe.t0, probe.t1, window)
    ingest_pct = program_trace.ingest_busy_pct(probe.t0, probe.t1, window)
    cpu_pct = program_trace.serve_cpu_pct(probe.t0, probe.t1)
    assert gc_pct is not None and 0 < gc_pct < 100
    assert ingest_pct is not None and 0 < ingest_pct < 100
    assert cpu_pct is not None and 0 < cpu_pct <= 100
    collections = program_trace.counts(probe.t0, probe.t1, "yoda_gc_pause_seconds")
    assert collections.get('generation="0"', 0) > 0
    assert sum(program_trace.counts(probe.t0, probe.t1,
                                    "yoda_ingest_apply_seconds").values()) > 0
    burst = tool.burst_account(run, probe.t0, probe.t1)
    assert burst["bursts"] > 0 and burst["cycles_per_burst"] > 1
    assert burst["burst_row_cycles"] + burst["dispatch_cycles"] <= burst["cycles"]
    assert burst["busy_wall_ms"] >= burst["busy_cpu_ms"] > 0
    # The serve loop's spans reach the probe's stack, on the serve thread.
    names = {r.name for r in probe.stack.metrics.tracer.records()
             if r.track == "serve-loop"}
    assert {"burst", "cycle"} <= names


def test_readers_read_nothing_from_a_program_without_the_families():
    empty: dict = {}
    assert program_trace.gc_pause_pct(empty, empty, 50.0) is None
    assert program_trace.ingest_busy_pct(empty, empty, 50.0) is None
    assert program_trace.serve_cpu_pct(empty, empty) is None
    assert program_trace.name_gaps([("a", 0.0, 1.0), ("b", 5.0, 6.0)], 0.0, []) == [
        ["host: uncovered 0.0000 s", 4e-06, {}, pytest.approx(4e-06)]]


BASE_US = 1.7e15  # the profiler's zero on the Unix clock, microseconds


def _at(us: float) -> float:
    return (us + BASE_US) / 1e6


def test_a_gap_is_named_by_the_spans_that_cover_it():
    ops = [("Memcpy HtoD", 0.0, 10.0), ("fleet_eval_kernel", 10.0, 20.0),
           ("Memcpy DtoH", 20.0, 30.0), ("Memcpy HtoD", 1_000_030.0, 1_000_040.0)]
    spans = [
        ("cycle", _at(30.0), _at(600_030.0)),          # 0.6 s from the gap's start
        ("gc", _at(100_030.0), _at(200_030.0)),        # a full collection inside it
        ("bound", _at(500_030.0), _at(700_030.0)),     # beside, then alone
        ("burst", _at(900_030.0), _at(2_000_000.0)),   # runs past the gap's end
        ("enqueue", _at(50.0), _at(50.0)),             # lasts nothing
    ]
    ((label, seconds, covered, uncovered),) = program_trace.name_gaps(ops, BASE_US, spans, n=1)
    assert seconds == pytest.approx(1.0)
    assert covered == pytest.approx({"cycle": 0.5, "gc": 0.1, "bound": 0.1,
                                     "burst": 0.1}, abs=1e-6)
    assert uncovered == pytest.approx(0.2, abs=1e-6)
    assert sum(covered.values()) + uncovered == pytest.approx(seconds)
    assert label.startswith("host: cycle 0.5000 s, ") and label.endswith(
        ", uncovered 0.2000 s")
    # The burst span covers the last upload alone: 10 of the ops' 40 us
    # (Unix seconds in a double resolve about 0.24 us).
    assert program_trace.ops_inside(ops, BASE_US, spans) == pytest.approx(25.0, abs=1.0)
    assert program_trace.ops_inside(ops, BASE_US, [("burst", _at(0.0), _at(40.0)),
                                                   ("cycle", _at(1e6), _at(1.1e6))]) == \
        pytest.approx(100.0, abs=1.0)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_naming_leaves_the_gap_seconds_and_busy_time_as_they_are(seed):
    rng = random.Random(seed)
    ops, t = [], 0.0
    for i in range(400):
        t += rng.choice([0.0, rng.uniform(0, 5), rng.uniform(1e3, 5e5)])
        dur = rng.uniform(1, 40)
        ops.append((rng.choice(["Memcpy HtoD", "Memcpy DtoH", "fleet_eval_kernel"]),
                    t, t + dur))
        t += rng.uniform(0, dur * 1.5)
    red = reduce_ops(list(ops), 50.0)
    before = (red["busy_s"], red["breakdown"])
    named = program_trace.name_gaps(ops, BASE_US, [])
    assert [g[1] for g in named] == [s for _n, s in red["breakdown"]["idle_gaps"]]
    assert all(g[3] == pytest.approx(g[1]) for g in named)
    red2 = reduce_ops(list(ops), 50.0)
    assert (red2["busy_s"], red2["breakdown"]) == before
