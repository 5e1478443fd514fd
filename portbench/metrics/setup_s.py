"""Process start to the window's start: imports, kernel load, fleet, pre-fill, warm-up."""


def read(run):
    return run.setup_s
