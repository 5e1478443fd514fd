"""Mean prepared burst of the program's own yoda_scheduling_latency_seconds{phase="burst"} over the window: further pops, snapshot, K-pod evaluation."""

from portbench.harness.readers import phase_mean_ms


def read(run):
    return phase_mean_ms(run, "burst")
