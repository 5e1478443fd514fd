"""fleet_eval's least time from its shapes over its profiled device time, percent."""

from portbench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "fleet_eval")
