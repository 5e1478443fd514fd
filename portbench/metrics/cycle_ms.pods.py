"""Mean cycle of the program's own yoda_scheduling_latency_seconds{phase="total"} over the window."""

from portbench.harness.readers import phase_mean_ms


def read(run):
    return phase_mean_ms(run, "total")
