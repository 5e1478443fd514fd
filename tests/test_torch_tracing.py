"""Lifecycle tracing and why-pending, held against yoda_tpu.

Every case of ``tests/test_tracing.py`` that needs no unported part runs
on both packages from the reference's own source
(``torch_refcases.run_case``), with its fake clocks and exact
assertions. None is left out: ``TestConnectedLifecycleTrace`` runs with
``bind_pipeline: on`` (the release binds on executor workers), and the
``explain`` CLI cases run the port's ``cli.main``.
``TestConnectedTraceWithoutPipeline`` below walks the same rebalanced
gang with the pipeline off, on both packages, and ``TestPendingHttp`` the
HTTP half of the listing.
"""

from __future__ import annotations

import json
import urllib.request
from collections import Counter

import pytest
from torch_refcases import PACKAGES, cases, run_case

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.types as ref_types
import yoda_tpu.config as ref_config
import yoda_tpu.metrics_server as ref_server
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent as port_agent
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.metrics_server as port_server
import yoda_tpu_torch.standalone as port_standalone

REF = "test_tracing.py"
SKIP: "dict[str, str]" = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


SIDES = {
    "yoda_tpu": (ref_standalone, ref_config, ref_agent, ref_types, ref_server),
    "yoda_tpu_torch": (
        port_standalone, port_config, port_agent, port_types, port_server,
    ),
}


def _stack(pkg, **cfg):
    standalone, config, agent, _types, _server = SIDES[pkg]
    cfg.setdefault("enable_preemption", False)
    cfg.setdefault("kernel_platform", "cpu")
    stack = standalone.build_stack(config=config.SchedulerConfig(**cfg))
    return stack, agent.FakeTpuAgent(stack.cluster)


def _topo_gang(pkg, tag, shape, chips=4):
    size = 1
    for d in shape.split("x"):
        size *= int(d)
    labels = {"tpu/gang": tag, "tpu/topology": shape, "tpu/chips": str(chips)}
    pod = SIDES[pkg][3].PodSpec
    return [pod(f"{tag}-{i}", labels=dict(labels)) for i in range(size)]


def _rebalanced_gang(pkg):
    """The reference's TestRepack shape (gang b bound mid-slice, islands on
    both sides, rebalanced onto the slice origin) with the bind pipeline
    off: the release binds run inline, the move's unbinds on the
    executor's workers."""
    stack, agent = _stack(pkg, rebalance_min_gain=0.01, bind_workers=4)
    agent.add_slice("s", generation="v5p", host_topology=(6, 1, 1))
    agent.publish_all()
    for tag in ("a", "b"):
        for p in _topo_gang(pkg, tag, "2x1x1"):
            stack.cluster.create_pod(p)
        stack.scheduler.run_until_idle(max_wall_s=30)
    for p in list(stack.cluster.list_pods()):
        if p.name.startswith("a-"):
            stack.cluster.delete_pod(p.key)
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert stack.rebalancer.run_once().moves == ["b"]
    stack.scheduler.run_until_idle(max_wall_s=30)
    assert all(
        p.node_name for p in stack.cluster.list_pods() if p.name.startswith("b-")
    )
    return stack


class TestConnectedTraceWithoutPipeline:
    def test_one_connected_trace_on_both(self):
        """One bound-then-rebalanced gang is ONE connected trace on both
        packages, with the same (span, parent span) multiset; the move's
        unbinds land on executor worker tracks."""
        shapes = {}
        for pkg in PACKAGES:
            recs = _rebalanced_gang(pkg).metrics.tracer.records(subject="gang:b")
            assert len({r.trace_id for r in recs}) == 1
            by_id = {r.span_id: r for r in recs}
            roots = [r for r in recs if r.parent_id is None]
            assert len(roots) == 1 and roots[0].name == "enqueue"
            children: dict = {}
            for r in recs:
                if r.parent_id is not None:
                    assert r.parent_id in by_id, (pkg, r.name)
                    children.setdefault(r.parent_id, []).append(r.span_id)
            seen, frontier = set(), [roots[0].span_id]
            while frontier:
                cur = frontier.pop()
                seen.add(cur)
                frontier.extend(children.get(cur, []))
            assert seen == set(by_id), pkg
            assert any(
                r.name == "unbind" and r.track.startswith("bind-") for r in recs
            ), sorted({(r.name, r.track) for r in recs})
            assert any(
                r.name == "rebalance-move" and r.track == "rebalancer"
                for r in recs
            )
            # Inline binds are recorded only past a wall-time gate in
            # both packages, so they stay out of the comparison.
            shapes[pkg] = Counter(
                (r.name, by_id[r.parent_id].name if r.parent_id else None)
                for r in recs
                if r.name != "bind"
            )
        assert shapes["yoda_tpu"] == shapes["yoda_tpu_torch"]

    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_perfetto_tracks_per_thread(self, pkg):
        """The Perfetto export names one track per emitting thread: the
        rebalancer's and each executor worker's."""
        stack = _rebalanced_gang(pkg)
        server = SIDES[pkg][4].MetricsServer(
            stack.metrics, host="127.0.0.1", port=0
        )
        server.start()
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/debug/traces"
                "?gang=b&format=perfetto"
            ).read()
        finally:
            server.stop()
        events = json.loads(body)["traceEvents"]
        tracks = {e["args"]["name"] for e in events if e["ph"] == "M"}
        assert "rebalancer" in tracks
        assert any(t.startswith("bind-") for t in tracks)
        for e in events:
            assert e["ph"] in ("X", "M") and e["pid"] == 1
            if e["ph"] == "X":
                assert e["ts"] >= 0 and e["dur"] >= 0


class TestPendingHttp:
    def test_listing_equal_on_both(self):
        """The HTTP half of the reference's listing case: /debug/pending
        lists every pending key with verdict-class counts, the same on
        both packages."""
        got = {}
        for pkg in PACKAGES:
            stack, agent = _stack(pkg)
            agent.add_host("h0", generation="v5e", chips=2)
            agent.publish_all()
            pod = SIDES[pkg][3].PodSpec
            for name in ("big", "huge"):
                stack.cluster.create_pod(pod(name, labels={"tpu/chips": "32"}))
            stack.scheduler.run_until_idle(max_wall_s=5)
            server = SIDES[pkg][4].MetricsServer(
                stack.metrics, host="127.0.0.1", port=0
            )
            server.start()
            try:
                base = f"http://127.0.0.1:{server.port}"
                listing = json.loads(
                    urllib.request.urlopen(f"{base}/debug/pending").read()
                )
                one = json.loads(
                    urllib.request.urlopen(
                        f"{base}/debug/pending/default/big"
                    ).read()
                )
            finally:
                server.stop()
            # The listing is ordered by wall-clock recency: compare by key.
            listing["pending"].sort(key=lambda row: row["key"])
            got[pkg] = (_no_wall(listing), _no_wall(one))
        assert got["yoda_tpu"] == got["yoda_tpu_torch"]
        assert got["yoda_tpu"][0]["count"] == 2


def _no_wall(obj):
    """``obj`` without its wall-clock stamps (``*_wall_unix``)."""
    if isinstance(obj, dict):
        return {
            k: _no_wall(v) for k, v in obj.items() if not k.endswith("_wall_unix")
        }
    if isinstance(obj, list):
        return [_no_wall(v) for v in obj]
    return obj
