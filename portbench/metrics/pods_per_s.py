"""Pods bound inside the window over the window's seconds."""

from portbench.harness.readers import binds_per_s


def read(run):
    return binds_per_s(run)
