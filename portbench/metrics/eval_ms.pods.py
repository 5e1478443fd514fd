"""Host ms per evaluation round trip of the stack's kernel object."""

from portbench.harness.readers import eval_mean_ms


def read(run):
    return eval_mean_ms(run)
