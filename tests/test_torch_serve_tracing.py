"""The port's serve loop traced from inside, beyond the reference's metric
set (``observability.PORT_ONLY_OBSERVABLES``).

- ``yoda_scheduling_latency_seconds{phase="burst"}`` and one ``burst``
  span per prepared burst (K > 1), never on K = 1;
- ``phase="filter_burst_row"`` and ``phase="filter_dispatch"``, which
  split each fused cycle's ``filter`` by what served it (loop mode
  records neither);
- ``yoda_gc_pause_seconds{generation}`` from the collector hook, one
  ``gc`` span per generation-2 collection, the hook installed once per
  metrics set and gone once every stack sharing it closed;
- ``yoda_ingest_apply_seconds`` once per batch, with no span (the pods'
  history keeps the span ring);
- ``yoda_serve_busy_seconds_total{clock="wall"|"cpu"}``, cpu within wall;
- ``yoda_burst_row_walks_total``, the full walks of a burst-served
  cycle's verdicts;
- a span's ``wall_unix`` is its start on the Unix clock.

Each name of the set is present on the port and absent from the
reference after the same drive. The parity tests
(``test_torch_observability.py``, ``test_torch_tracing.py``) take exactly
these names off the port's side before comparing.
"""

from __future__ import annotations

import gc
import threading
import time

import pytest

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.types as ref_types
import yoda_tpu.config as ref_config
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent as port_agent
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.standalone as port_standalone
from yoda_tpu_torch.cluster.fake import Event
from yoda_tpu_torch.cluster.ingest import EventBatcher
from yoda_tpu_torch.observability import (
    PORT_ONLY_OBSERVABLES,
    SchedulingMetrics,
    _GcHook,
)
from yoda_tpu_torch.tracing import Tracer

SIDES = {
    "yoda_tpu": (ref_standalone, ref_config, ref_agent, ref_types),
    "yoda_tpu_torch": (port_standalone, port_config, port_agent, port_types),
}

FAMILIES = {
    "yoda_gc_pause_seconds",
    "yoda_ingest_apply_seconds",
    "yoda_serve_busy_seconds_total",
    "yoda_burst_row_walks_total",
}
PHASES = {"burst", "filter_burst_row", "filter_dispatch"}
SPANS = {"burst", "gc"}


def _stack(pkg: str, metrics=None, **cfg):
    standalone, config, agent_mod, _types = SIDES[pkg]
    cfg.setdefault("kernel_platform", "cpu")
    cfg.setdefault("enable_preemption", False)
    kw = {} if metrics is None else {"metrics": metrics}
    stack = standalone.build_stack(config=config.SchedulerConfig(**cfg), **kw)
    agent = agent_mod.FakeTpuAgent(stack.cluster)
    for i in range(6):
        agent.add_host(f"h{i}", generation="v5e", chips=8)
    agent.publish_all()
    if stack.ingestor is not None:
        stack.ingestor.flush()
    return stack


def _pods(pkg: str, stack, prefix: str, n: int) -> None:
    pod = SIDES[pkg][3].PodSpec
    for i in range(n):
        stack.cluster.create_pod(pod(f"{prefix}{i}", labels={"tpu/chips": "1"}))
    if stack.ingestor is not None:
        stack.ingestor.flush()


def _drive(pkg: str):
    """Bursts of K = 4, then a lone pod (a fresh dispatch), batched ingest
    on, and one full collection."""
    stack = _stack(pkg, batch_requests=4, ingest_batch_window_ms=2)
    _pods(pkg, stack, "a", 10)
    stack.scheduler.run_until_idle(max_wall_s=20)
    _pods(pkg, stack, "b", 1)
    stack.scheduler.run_until_idle(max_wall_s=20)
    gc.collect(2)
    m = stack.metrics
    text = m.registry.render_prometheus()  # folds queued collections in
    out = dict(
        families={line.split()[2] for line in text.splitlines()
                  if line.startswith("# TYPE ")},
        phases={ph for ph in PHASES if m.latency.count(phase=ph)},
        spans={r.name for r in m.tracer.records()},
    )
    if pkg == "yoda_tpu_torch":
        stack.close()
    return out


@pytest.fixture(scope="module")
def drives():
    return {pkg: _drive(pkg) for pkg in SIDES}


def test_port_only_set_is_the_families_phases_and_spans():
    assert PORT_ONLY_OBSERVABLES == FAMILIES | PHASES | SPANS


@pytest.mark.parametrize("name", sorted(PORT_ONLY_OBSERVABLES))
def test_present_on_port_absent_from_reference(drives, name):
    for kind in ("families", "phases", "spans"):
        if name in {"families": FAMILIES, "phases": PHASES, "spans": SPANS}[kind]:
            assert name in drives["yoda_tpu_torch"][kind], (kind, name)
            assert name not in drives["yoda_tpu"][kind], (kind, name)


class TestBurstPhase:
    def _count_prepares(self, stack) -> list:
        calls = []
        inner = stack.framework.prepare_burst

        def prepare_burst(pods, snapshot):
            calls.append(len(pods))
            return inner(pods, snapshot)

        stack.framework.prepare_burst = prepare_burst
        return calls

    def test_once_per_prepared_burst(self):
        stack = _stack("yoda_tpu_torch", batch_requests=4)
        calls = self._count_prepares(stack)
        _pods("yoda_tpu_torch", stack, "p", 10)
        stack.scheduler.run_until_idle(max_wall_s=20)
        m = stack.metrics
        assert calls and all(k > 1 for k in calls)
        assert m.latency.count(phase="burst") == len(calls)
        spans = [r for r in m.tracer.records() if r.name == "burst"]
        assert [r.attrs["pods"] for r in spans] == calls
        assert {(r.subject, r.attrs["shard"]) for r in spans} == {("loop:serve", "")}
        assert m.latency.count(phase="total") == 10
        stack.close()

    @pytest.mark.parametrize("k,pods", [(1, 6), (4, 1)])
    def test_never_without_a_burst(self, k, pods):
        """K = 1, and K = 4 with a lone pod: no burst is prepared."""
        stack = _stack("yoda_tpu_torch", batch_requests=k)
        calls = self._count_prepares(stack)
        _pods("yoda_tpu_torch", stack, "p", pods)
        stack.scheduler.run_until_idle(max_wall_s=20)
        assert calls == []
        assert stack.metrics.latency.count(phase="burst") == 0
        assert not [r for r in stack.metrics.tracer.records() if r.name == "burst"]
        stack.close()


class TestFilterPaths:
    def test_the_two_paths_partition_filter_per_cycle(self):
        stack = _stack("yoda_tpu_torch", batch_requests=4)
        _pods("yoda_tpu_torch", stack, "a", 9)
        stack.scheduler.run_until_idle(max_wall_s=20)
        _pods("yoda_tpu_torch", stack, "b", 1)
        stack.scheduler.run_until_idle(max_wall_s=20)
        m = stack.metrics
        seen = set()
        for t in m.recent_traces(100):
            if "filter" not in t.phases_ms:
                continue
            paths = [p for p in ("filter_burst_row", "filter_dispatch")
                     if p in t.phases_ms]
            assert len(paths) == 1, t.phases_ms
            assert t.phases_ms[paths[0]] == t.phases_ms["filter"]
            seen.add(paths[0])
        assert seen == {"filter_burst_row", "filter_dispatch"}
        assert m.latency.count(phase="filter") == (
            m.latency.count(phase="filter_burst_row")
            + m.latency.count(phase="filter_dispatch")
        )
        assert stack.batch.burst_served == m.latency.count(phase="filter_burst_row")
        stack.close()

    def test_loop_mode_records_neither(self):
        """The per-node filter chain dispatches no evaluation: its filter
        time is neither path's."""
        stack = _stack("yoda_tpu_torch", mode="loop")
        _pods("yoda_tpu_torch", stack, "p", 3)
        stack.scheduler.run_until_idle(max_wall_s=20)
        m = stack.metrics
        assert m.latency.count(phase="filter") == 3
        assert m.latency.count(phase="filter_burst_row") == 0
        assert m.latency.count(phase="filter_dispatch") == 0
        stack.close()


def _gc2(m: SchedulingMetrics) -> int:
    return m.gc_pause.count(generation="2")


def _hooks_of(m: SchedulingMetrics) -> list:
    return [cb for cb in gc.callbacks
            if isinstance(cb, _GcHook) and cb.ref() is m.gc_pauses]


class TestGcPauses:
    def test_full_collection_one_observation_and_one_span(self):
        stack = _stack("yoda_tpu_torch")
        m = stack.metrics
        n0 = _gc2(m)
        spans0 = len([r for r in m.tracer.records() if r.name == "gc"])
        gc.collect(2)
        assert _gc2(m) == n0 + 1
        spans = [r for r in m.tracer.records() if r.name == "gc"]
        assert len(spans) == spans0 + 1
        assert (spans[-1].track, spans[-1].subject) == ("gc", "interpreter:gc")
        assert spans[-1].dur_ms > 0
        stack.close()

    def test_young_collections_counted_not_spanned(self):
        stack = _stack("yoda_tpu_torch")
        m = stack.metrics
        gc.collect(0)
        m.gc_pauses.fold()
        assert m.gc_pause.count(generation="0") >= 1
        assert {r.attrs["generation"] for r in m.tracer.records()
                if r.name == "gc"} <= {2}
        stack.close()

    def test_shared_metrics_one_hook_gone_after_both_close(self):
        shared = SchedulingMetrics()
        a = _stack("yoda_tpu_torch", metrics=shared)
        b = _stack("yoda_tpu_torch", metrics=shared)
        assert len(_hooks_of(shared)) == 1
        n0 = _gc2(shared)
        gc.collect(2)
        assert _gc2(shared) == n0 + 1
        a.close()
        assert len(_hooks_of(shared)) == 1
        b.close()
        b.close()  # a second close gives nothing back twice
        assert _hooks_of(shared) == []
        n1 = _gc2(shared)
        gc.collect(2)
        assert _gc2(shared) == n1

    def test_collection_while_the_family_lock_is_held(self):
        """The hook takes no lock: a collection on a thread that holds
        the histogram's and the tracer's locks finishes, and is folded in
        once they are free."""
        stack = _stack("yoda_tpu_torch")
        m = stack.metrics
        n0 = _gc2(m)
        done = threading.Event()

        def hold_and_collect():
            with m.gc_pause._lock, m.tracer._lock:
                gc.collect(2)
            done.set()

        t = threading.Thread(target=hold_and_collect, daemon=True)
        t.start()
        t.join(timeout=30)
        assert done.is_set() and not t.is_alive()
        assert _gc2(m) == n0 + 1
        stack.close()

    def test_dropped_metrics_leave_no_live_hook(self):
        stack = _stack("yoda_tpu_torch")
        del stack
        gc.collect()
        _stack("yoda_tpu_torch").close()
        assert not [cb for cb in gc.callbacks
                    if isinstance(cb, _GcHook) and cb.ref() is None]


class TestIngestApply:
    def test_flush_observes_one_apply_per_batch(self):
        stack = _stack("yoda_tpu_torch", ingest_batch_window_ms=60_000)
        m = stack.metrics
        n0 = m.ingest_apply.count()
        pod = port_types.PodSpec
        for i in range(3):
            stack.cluster.create_pod(pod(f"p{i}", labels={"tpu/chips": "1"}))
        stack.ingestor.flush()
        stack.ingestor.flush()  # nothing buffered: no apply
        assert m.ingest_apply.count() == n0 + 1
        stack.close()

    def test_an_apply_adds_no_span(self):
        """The applies are counted, not spanned: a batch of node updates
        leaves the span ring as it was."""
        stack = _stack("yoda_tpu_torch", ingest_batch_window_ms=60_000)
        m = stack.metrics
        n0, spans0 = m.ingest_apply.count(), m.tracer.records()
        agent = port_agent.FakeTpuAgent(stack.cluster)
        for i in range(3):
            agent.add_host(f"x{i}", generation="v5e", chips=8)
        agent.publish_all()
        stack.ingestor.flush()
        assert m.ingest_apply.count() == n0 + 1
        assert m.tracer.records() == spans0
        stack.close()

    def test_hook_gets_the_apply_interval(self):
        got = []

        def apply(events):
            time.sleep(0.01)

        b = EventBatcher(apply, on_batch=lambda *a: got.append(a))
        b.offer(Event("added", "Pod", port_types.PodSpec("x")))
        raw, applied, t0, t1 = got[-1]
        assert (raw, applied) == (1, 1) and t1 - t0 >= 0.01
        b.flush()
        assert len(got) == 1


class TestServeBusy:
    def test_cpu_within_wall_in_run_until_idle(self):
        stack = _stack("yoda_tpu_torch", batch_requests=4)
        _pods("yoda_tpu_torch", stack, "p", 8)
        stack.scheduler.run_until_idle(max_wall_s=20)
        busy = stack.metrics.serve_busy
        wall, cpu = busy.value(clock="wall"), busy.value(clock="cpu")
        assert 0 < cpu <= wall
        stack.close()

    def test_cpu_within_wall_in_serve_forever(self):
        stack = _stack("yoda_tpu_torch", batch_requests=4)
        stop = threading.Event()
        loop = threading.Thread(target=stack.scheduler.serve_forever, args=(stop,),
                                kwargs={"poll_s": 0.02}, name="serve-loop")
        loop.start()
        try:
            _pods("yoda_tpu_torch", stack, "p", 8)
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and stack.metrics.binds.value() < 8:
                time.sleep(0.01)
        finally:
            stop.set()
            loop.join(timeout=10)
        assert not loop.is_alive()
        assert stack.metrics.binds.value() == 8
        busy = stack.metrics.serve_busy
        wall, cpu = busy.value(clock="wall"), busy.value(clock="cpu")
        assert 0 < cpu <= wall
        assert {r.track for r in stack.metrics.tracer.records()
                if r.name == "burst"} == {"serve-loop"}
        stack.close()


class TestSpanStart:
    def test_wall_unix_is_the_start(self):
        tr = Tracer()
        t0 = tr.clock()
        unix0 = time.time()
        time.sleep(0.05)
        tr.add("loop:serve", "burst", t0=t0, t1=tr.clock())
        rec = tr.records()[-1]
        assert abs(rec.wall_unix - unix0) < 0.01
        assert rec.dur_ms >= 50
        assert rec.to_dict()["wall_unix"] == round(rec.wall_unix, 6)

    def test_wall_unix_on_a_stepped_clock(self):
        now = [100.0]
        tr = Tracer(clock=lambda: now[0])
        now[0] = 130.0
        tr.add("pod:a", "cycle", t0=110.0, t1=120.0)
        rec = tr.records()[-1]
        assert rec.wall_unix == pytest.approx(tr.unix_offset + 110.0)
        (event,) = [e for e in Tracer.to_perfetto([rec])["traceEvents"]
                    if e["ph"] == "X"]
        assert event["args"]["wall_unix"] == rec.wall_unix
