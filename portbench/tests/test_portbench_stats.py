"""The metric arithmetic on synthetic timestamps: a whole-window rate, and
a stall that moves it."""

import pytest

from portbench.harness.readers import binds_per_s
from portbench.harness.reference import LogEvent
from portbench.harness.runner import Run


def _run(bind_times):
    run = Run("x", t_start=10.0, t_end=20.0)
    run.events = [LogEvent(t, 0.0, "bind", f"p{i}", "n") for i, t in enumerate(bind_times)]
    return run


def test_rate_counts_every_bind_inside_the_window_only():
    times = [9.9] + [10.0 + 0.01 * i for i in range(1000)] + [20.0, 25.0]
    assert binds_per_s(_run(times)) == pytest.approx(100.0)


def test_a_stall_lowers_the_rate_by_the_binds_it_pushes_out_of_the_window():
    steady = [10.0 + 0.01 * i for i in range(1000)]
    stalled = [t if t < 15.0 else t + 3.0 for t in steady]
    assert binds_per_s(_run(stalled)) == pytest.approx(70.0)


def test_deletions_and_creations_are_not_binds():
    run = _run([11.0, 12.0])
    run.events += [LogEvent(13.0, 0.0, "delete", "p0"), LogEvent(14.0, 0.0, "add", "q")]
    assert binds_per_s(run) == pytest.approx(0.2)
