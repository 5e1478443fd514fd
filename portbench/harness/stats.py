"""The metric arithmetic: whole-window rates."""

from __future__ import annotations


def rate(times: list, t_start: float, t_end: float) -> float:
    """Events per second over the window [t_start, t_end)."""
    n = sum(1 for t in times if t_start <= t < t_end)
    return n / (t_end - t_start)
