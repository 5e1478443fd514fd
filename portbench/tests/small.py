"""A small copy of each cell for runs on the CPU: the same configuration
and mix at 16 slices and 96 single hosts, with lighter traffic."""

import copy
import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def shrink(cfg: dict, mix: dict):
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    for pool in cfg["fleet"]["pools"]:
        if "slices" in pool:
            pool["slices"] = 16
        else:
            pool["hosts"] = 96
    for key, value in (("pool", 20480), ("pending_min", 16), ("pending_target", 32),
                       ("sample", 3000), ("sample_from", 20000)):
        if key in mix:
            mix[key] = value
    # The small fleet fills in a fraction of a second: churn in large
    # bursts.
    mix["churn"] = {"high": 0.9, "low": 0.55}
    return cfg, mix


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def run_small(cell: str, seed: int = 987654321987, seconds: float = 2.0, **kw) -> dict:
    from portbench.harness import runner

    return runner.run_cell(ROOT, bench(), cell, seed, seconds, False,
                           t_process=time.monotonic(), platform="cpu", adjust=shrink,
                           **kw)
