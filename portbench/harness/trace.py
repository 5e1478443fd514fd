"""The device trace of a traced run's window and what it reduces to.

``torch.profiler`` records the card's activity (kernels, copies, fills)
over the window; the trace is exported to the run's temporary directory,
read back and deleted. Busy time is the union of every device operation's
interval; a kernel's time is the sum of its records.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.__enter__()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)

    def device_ops(self) -> list:
        """(name, start us, end us) of every device operation, in order."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        events = data.get("traceEvents", data) if isinstance(data, dict) else data
        ops = [
            (e.get("name", "?"), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
        ]
        ops.sort(key=lambda o: o[1])
        return ops


def reduce_ops(ops: list, window_s: float) -> dict:
    """Busy seconds (the union of the intervals), seconds per operation
    name, record counts, and the ten longest gaps between operations."""
    busy_us = 0.0
    end = None
    start = None
    per_name: dict[str, float] = {}
    counts: dict[str, int] = {}
    gaps = []
    prev = None
    for name, t0, t1 in ops:
        per_name[name] = per_name.get(name, 0.0) + (t1 - t0) / 1e6
        counts[name] = counts.get(name, 0) + 1
        if end is None or t0 > end:
            if end is not None:
                gaps.append((f"host between {short(prev)} and {short(name)}",
                             (t0 - end) / 1e6))
            if start is not None:
                busy_us += end - start
            start, end = t0, t1
        else:
            end = max(end, t1)
        prev = name
    if start is not None:
        busy_us += end - start
    gaps.sort(key=lambda g: -g[1])
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        busy_s=busy_us / 1e6,
        window_s=window_s,
        per_name=per_name,
        counts=counts,
        breakdown=dict(
            device_ops=[[short(n), s] for n, s in top],
            idle_gaps=[[n, s] for n, s in gaps[:10]],
        ),
    )


def short(name: "str | None") -> str:
    """A kernel's name without its template arguments and parameters."""
    if not name:
        return "start"
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("<", 1)[0].split("(", 1)[0].strip()[:80]


def kernel_time(red: dict, needle: str) -> "tuple[float, int]":
    """(device seconds, records) of the operations whose name holds
    ``needle``."""
    secs, n = 0.0, 0
    for name, s in red["per_name"].items():
        if needle in name:
            secs += s
            n += red["counts"][name]
    return secs, n
