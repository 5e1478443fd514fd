"""Mean filter phase of the cycles served from their burst row, the program's own yoda_scheduling_latency_seconds{phase="filter_burst_row"} over the window."""

from portbench.harness.readers import phase_mean_ms


def read(run):
    return phase_mean_ms(run, "filter_burst_row")
