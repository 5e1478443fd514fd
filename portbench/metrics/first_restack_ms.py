"""The program's first re-stack of the resident fleet state, wall ms (its first lowering and upload)."""


def read(run):
    return run.counters.get("first_restack_ms")
