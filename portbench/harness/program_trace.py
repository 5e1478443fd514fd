"""The program's own instrumentation of its serve loop, read from outside:
the families it exports beyond the reference (the collector's pauses, the
ingest's applies, the serve thread's wall and CPU seconds), read at the
window's edges, and its spans, which name each idle gap of the device
trace by what the host was doing.

The benchmark's runner does not call this module yet; the tool
``portbench/tools/serve_trace.py`` runs a cell with it. Against a program
that lacks a family or a span kind every reader returns None and every
gap reads as uncovered.
"""

from __future__ import annotations

import json

# The families read at the window's edges.
FAMILIES = (
    "yoda_gc_pause_seconds",
    "yoda_ingest_apply_seconds",
    "yoda_serve_busy_seconds_total",
)

# A gap's instant goes to the first of these spans that covers it: a
# collection stops every thread, a burst's preparation and a cycle run on
# the serve thread. Other span names follow, in the order of their names.
GAP_ORDER = ("gc", "burst", "cycle")


def family_totals(stack, families=FAMILIES) -> dict:
    """{family: {labels: value}} of the named families, from the program's
    exposition (``stack.metrics.registry``): a histogram's ``_sum`` and
    ``_count`` as (sum, count), a counter's samples as their value.
    Labels are the sample's label text, ``""`` without labels."""
    out: dict = {}
    for metric in list(stack.metrics.registry._metrics):
        if metric.name not in families:
            continue
        fam = out.setdefault(metric.name, {})
        for line in metric.render():
            if line.startswith("#"):
                continue
            head, value = line.rsplit(" ", 1)
            sample, _, labels = head.partition("{")
            labels = labels.rstrip("}")
            if sample == metric.name:
                fam[labels] = float(value)
            elif sample == metric.name + "_sum":
                fam[labels] = (float(value), fam.get(labels, (0.0, 0))[1])
            elif sample == metric.name + "_count":
                fam[labels] = (fam.get(labels, (0.0, 0))[0], int(float(value)))
    return out


def _sum_of(totals: dict, family: str) -> "float | None":
    fam = totals.get(family)
    if fam is None:
        return None
    return sum(v[0] for v in fam.values())


def counts(t0: dict, t1: dict, family: str) -> dict:
    """{labels: observations} of a histogram's series over the window."""
    f0, f1 = t0.get(family, {}), t1.get(family, {})
    return {k: v[1] - f0.get(k, (0.0, 0))[1] for k, v in f1.items()}


def share_pct(t0: dict, t1: dict, family: str, seconds: float) -> "float | None":
    """The change in a histogram's sum over all its series, over the
    window's seconds, in percent."""
    s0, s1 = _sum_of(t0, family), _sum_of(t1, family)
    if s0 is None or s1 is None or seconds <= 0:
        return None
    return (s1 - s0) / seconds * 100


def gc_pause_pct(t0: dict, t1: dict, seconds: float) -> "float | None":
    return share_pct(t0, t1, "yoda_gc_pause_seconds", seconds)


def ingest_busy_pct(t0: dict, t1: dict, seconds: float) -> "float | None":
    return share_pct(t0, t1, "yoda_ingest_apply_seconds", seconds)


def serve_cpu_pct(t0: dict, t1: dict) -> "float | None":
    """The serve thread's on-CPU seconds over its busy wall seconds in the
    window, in percent."""
    f0 = t0.get("yoda_serve_busy_seconds_total")
    f1 = t1.get("yoda_serve_busy_seconds_total")
    if f0 is None or f1 is None:
        return None
    wall = f1.get('clock="wall"', 0.0) - f0.get('clock="wall"', 0.0)
    cpu = f1.get('clock="cpu"', 0.0) - f0.get('clock="cpu"', 0.0)
    if wall <= 0:
        return None
    return cpu / wall * 100


def trace_base_us(path) -> "float | None":
    """The Unix microseconds at the zero of the profiler trace exported to
    ``path``: Kineto's ``baseTimeNanoseconds`` / 1e3, so that an event's
    Unix start is its ``ts`` plus this. None where the export carries no
    base."""
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds") if isinstance(data, dict) else None
    return None if base is None else float(base) / 1e3


def unix_spans(records) -> list:
    """(name, start, end) of each span that lasts, on the Unix clock in
    seconds (a record's ``wall_unix`` is its start)."""
    return [(r.name, r.wall_unix, r.wall_unix + r.dur_ms / 1e3)
            for r in records if r.dur_ms > 0]


def gap_intervals(ops: list) -> list:
    """(start us, end us) of each gap between device operations, longest
    first: the gaps ``trace.reduce_ops`` lists, in its order."""
    gaps = []
    end = None
    for _name, t0, t1 in ops:
        if end is None or t0 > end:
            if end is not None:
                gaps.append((end, t0))
            end = t1
        else:
            end = max(end, t1)
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    return gaps


def cover(a: float, b: float, spans: list) -> "tuple[dict, float]":
    """How the interval [a, b] (seconds) splits among the spans that
    cover it: each instant goes to the first covering span name in
    ``GAP_ORDER`` (then by name). Returns ({name: seconds}, uncovered
    seconds); together they sum to b - a."""

    def rank(name: str):
        return (GAP_ORDER.index(name) if name in GAP_ORDER else len(GAP_ORDER), name)

    edges = []
    for name, s, e in spans:
        s, e = max(s, a), min(e, b)
        if e > s:
            edges.append((s, 1, name))
            edges.append((e, -1, name))
    edges.sort(key=lambda x: (x[0], x[1]))
    active: dict = {}
    out: dict = {}
    uncovered = 0.0
    t = a
    for x, d, name in edges:
        if x > t:
            live = [n for n, c in active.items() if c > 0]
            if live:
                top = min(live, key=rank)
                out[top] = out.get(top, 0.0) + (x - t)
            else:
                uncovered += x - t
            t = x
        active[name] = active.get(name, 0) + d
    uncovered += max(b - t, 0.0)
    return out, uncovered


def gap_label(covered: dict, uncovered: float) -> str:
    parts = [f"{n} {s:.4f} s" for n, s in sorted(covered.items(), key=lambda kv: -kv[1])]
    return "host: " + ", ".join(parts + [f"uncovered {uncovered:.4f} s"])


def name_gaps(ops: list, base_us: float, spans: list, n: int = 10) -> list:
    """The ``n`` longest gaps of ``ops`` (profiler microseconds, whose
    zero is ``base_us`` on the Unix clock), each as [label, seconds,
    {span name: seconds}, uncovered seconds], named by ``spans``
    (``unix_spans``)."""
    out = []
    for g0, g1 in gap_intervals(ops)[:n]:
        covered, uncovered = cover((g0 + base_us) / 1e6, (g1 + base_us) / 1e6, spans)
        out.append([gap_label(covered, uncovered), (g1 - g0) / 1e6, covered, uncovered])
    return out


def ops_inside(ops: list, base_us: float, spans: list) -> "float | None":
    """The share of the device operations' time that lies inside a
    program span once mapped onto the Unix clock, in percent: a check of
    the mapping (the card runs only inside the program's calls)."""
    total = sum(t1 - t0 for _n, t0, t1 in ops)
    if total <= 0:
        return None
    inside = 0.0
    for _n, t0, t1 in ops:
        covered, _ = cover((t0 + base_us) / 1e6, (t1 + base_us) / 1e6, spans)
        inside += sum(covered.values()) * 1e6
    return inside / total * 100
