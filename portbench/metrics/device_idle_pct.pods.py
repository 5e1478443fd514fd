"""Share of the traced window in which no device operation runs."""

from portbench.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
