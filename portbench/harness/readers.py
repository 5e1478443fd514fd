"""The computations the metric readers share. Each reader
(``portbench/metrics/<name>.py``) is ``read(run) -> float | None``: None
when the run holds nothing to read, and the metric is then left out."""

from __future__ import annotations

from portbench.harness import stats
from portbench.harness.trace import kernel_time


def binds_per_s(run) -> "float | None":
    times = [e.t for e in run.events if e.kind == "bind"]
    return stats.rate(times, run.t_start, run.t_end)


def phase_mean_ms(run, phase: str) -> "float | None":
    """Mean of the program's yoda_scheduling_latency_seconds{phase} over the
    window: the deltas of its sum and count."""
    s0, n0 = run.latency0.get(phase, (0.0, 0))
    s1, n1 = run.latency1.get(phase, (0.0, 0))
    if n1 <= n0:
        return None
    return (s1 - s0) / (n1 - n0) * 1e3


def eval_mean_ms(run) -> "float | None":
    if not run.eval_s:
        return None
    return sum(run.eval_s) / len(run.eval_s) * 1e3


def roofline_pct(run, kernel: str) -> "float | None":
    """The kernel's mean least time per launch over its mean device time
    per traced record, in percent. Means, not sums: a tracer that drops a
    record drops its time and its count together."""
    if run.trace is None:
        return None
    least = [s for k, s in run.launches if k == kernel]
    secs, records = kernel_time(run.trace, f"{kernel}_kernel")
    if not least or not records or secs <= 0:
        return None
    return (sum(least) / len(least)) / (secs / records) * 100


def idle_pct(run) -> "float | None":
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return (1 - run.trace["busy_s"] / run.trace["window_s"]) * 100
