"""The metrics registry, the scheduling trace and the metrics endpoint,
held against yoda_tpu.

Every case of ``tests/test_observability.py`` runs on both packages from
the reference's own source (``torch_refcases.run_case``), with its exact
assertions, the federation's series (``yoda_cluster_state``,
``yoda_cluster_transitions_total``, ``yoda_spillover_gangs_total``) among
them. None is left out.

``TestAllFamiliesRegistered::test_checker_list_matches_code`` lints the
yoda_tpu source tree on both sides; ``tests/test_torch_lint.py`` runs the
same lint passes over the port, and ``TestSchema`` holds the port's
rendered families.

Beside them: a default stack's ``/metrics`` renders the same families,
types and label keys in both packages; a seeded sweep of mixed
singletons and gangs on a stepped clock gives equal counters, gauges,
histogram counts, trace entries, why-pending summaries, SLO evaluations
and span multisets; a threaded drive with every background loop and a
scraper running beside the serve loop, tracing on, ends without a
deadlock. The card-only check that a dispatch span covers its kernels'
device time is in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import re
import threading
import time
import urllib.request
from collections import Counter

import numpy as np
import pytest
from torch_refcases import PACKAGES, cases, run_case

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.types as ref_types
import yoda_tpu.config as ref_config
import yoda_tpu.observability as ref_observability
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent as port_agent
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.metrics_server as port_server
import yoda_tpu_torch.observability as port_observability
import yoda_tpu_torch.standalone as port_standalone

REF = "test_observability.py"
SKIP: dict = {}

# What the port records beyond the reference (families, phase labels, span
# names): taken off the port's side, and nothing else, before a comparison.
PORT_ONLY = port_observability.PORT_ONLY_OBSERVABLES


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


SIDES = {
    "yoda_tpu": (ref_standalone, ref_config, ref_agent, ref_types),
    "yoda_tpu_torch": (port_standalone, port_config, port_agent, port_types),
}

_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})? (\S+)$")


def scrape(text: str) -> "tuple[dict, dict]":
    """Prometheus text -> ({family: type}, {(sample name, labels): value})."""
    types, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split()
            types[name] = typ
        elif line and not line.startswith("#"):
            m = _SAMPLE.match(line)
            assert m is not None, line
            labels = tuple(sorted(
                tuple(kv.split("=", 1)) for kv in (m.group(2) or "").split(",")
                if kv
            ))
            samples[(m.group(1), labels)] = float(m.group(3))
    return types, samples


def family_of(sample: str, types: dict) -> str:
    if sample in types:
        return sample
    return re.sub(r"_(bucket|sum|count)$", "", sample)


class TestSchema:
    def test_scheduling_metrics_registers_58_families_on_both(self):
        """SchedulingMetrics itself (54) plus attach_fleet (4): the same
        names, help strings and types in both packages."""
        def families(mod):
            m = mod.SchedulingMetrics()
            m.attach_fleet(lambda: type("S", (), {"infos": lambda self: []})())
            return [
                (f.name, f.help, type(f).__name__) for f in m.registry._metrics
            ]

        ref, port = families(ref_observability), families(port_observability)
        assert len(ref) == 58
        assert [f for f in port if f[0] not in PORT_ONLY] == ref

    def test_default_stack_renders_same_families_types_label_keys(self):
        got = {}
        for pkg in PACKAGES:
            standalone, config, agent_mod, _types = SIDES[pkg]
            stack = standalone.build_stack(
                config=config.SchedulerConfig(kernel_platform="cpu")
            )
            agent_mod.FakeTpuAgent(stack.cluster).add_host(
                "h0", generation="v5e", chips=4
            )
            types, samples = scrape(stack.metrics.registry.render_prometheus())
            keys: dict = {}
            for (name, labels), _v in samples.items():
                fam = family_of(name, types)
                keys.setdefault(fam, set()).add(
                    tuple(k for k, _ in labels if k != "le")
                )
            helps = {
                f.name: f.help for f in stack.metrics.registry._metrics
            }
            if pkg == "yoda_tpu_torch":
                types, keys, helps = (
                    {k: v for k, v in d.items() if k not in PORT_ONLY}
                    for d in (types, keys, helps)
                )
            got[pkg] = (types, keys, helps)
        assert got["yoda_tpu"] == got["yoda_tpu_torch"]
        assert len(got["yoda_tpu"][0]) >= 100


# --- the seeded sweep -------------------------------------------------------


class SteppedClock:
    def __init__(self) -> None:
        self.now = 500.0

    def __call__(self) -> float:
        return self.now


def sweep_script(seed: int):
    """Hosts and two waves of pods from one seed: singletons (some too big
    to ever fit, some of high priority), plain gangs and one topology
    gang, with deletions between the waves."""
    rng = np.random.default_rng(seed)
    hosts = [(f"e{i:02d}", int(rng.choice([4, 8]))) for i in range(int(rng.integers(5, 9)))]
    waves = []
    for w in range(2):
        pods = []
        for j in range(int(rng.integers(6, 14))):
            labels = {"tpu/chips": str(int(rng.choice([1, 2, 4, 64])))}
            if rng.random() < 0.3:
                labels["tpu/priority"] = str(int(rng.integers(0, 12)))
            ns = str(rng.choice(["team-a", "team-b"]))
            pods.append((f"w{w}s{j}", ns, labels))
        for g in range(int(rng.integers(1, 3))):
            size = int(rng.integers(2, 4))
            labels = {"tpu/gang": f"w{w}g{g}", "tpu/gang-size": str(size),
                      "tpu/chips": str(int(rng.choice([2, 4])))}
            pods += [(f"w{w}g{g}-{i}", "team-b", dict(labels)) for i in range(size)]
        if w == 1:
            pods += [(f"topo-{i}", "team-a", {"tpu/gang": "topo",
                      "tpu/topology": "2x2x1", "tpu/chips": "4"}) for i in range(4)]
        order = rng.permutation(len(pods))
        waves.append([pods[i] for i in order])
    deletes = [int(i) for i in rng.choice(12, size=3, replace=False)]
    return hosts, waves, deletes


# Families whose VALUES are wall-clock readings in both packages; their
# sample counts are still compared.
_WALL = ("yoda_bind_wall_ms", "yoda_delta_apply_ms")


def run_sweep(pkg: str, seed: int, batch: int):
    standalone, config, agent_mod, types = SIDES[pkg]
    clock = SteppedClock()
    stack = standalone.build_stack(
        config=config.SchedulerConfig(
            kernel_platform="cpu", batch_requests=batch, bind_workers=0,
        ),
        clock=clock,
    )
    agent = agent_mod.FakeTpuAgent(stack.cluster)
    hosts, waves, deletes = sweep_script(seed)
    for name, chips in hosts:
        agent.add_host(name, generation="v5e", chips=chips)
    agent.add_slice("s", generation="v5p", host_topology=(2, 2, 1))
    agent.publish_all()
    stack.reconciler.resync()
    evals = []
    for w, pods in enumerate(waves):
        for name, ns, labels in pods:
            stack.cluster.create_pod(types.PodSpec(name, namespace=ns, labels=labels))
            clock.now += 0.25
        stack.scheduler.run_until_idle(max_wall_s=5)
        clock.now += 3.0
        stack.framework.expire_waiting(now=clock.now + 1e6)
        stack.scheduler.run_until_idle(max_wall_s=5)
        if w == 0:
            live = sorted(p.key for p in stack.cluster.list_pods())
            for i in deletes:
                if i < len(live):
                    stack.cluster.delete_pod(live[i])
            stack.scheduler.run_until_idle(max_wall_s=5)
        clock.now += 10.0
        evals.append(stack.metrics.slo.evaluate(now=clock.now))
    m = stack.metrics
    types_, samples = scrape(m.registry.render_prometheus())
    port = pkg == "yoda_tpu_torch"
    values = {}
    for (name, labels), v in samples.items():
        fam = family_of(name, types_)
        if fam in _WALL and not name.endswith("_count"):
            continue
        if port and (fam in PORT_ONLY or dict(labels).get("phase", "").strip('"')
                     in PORT_ONLY):
            continue
        values[(name, labels)] = v
    recs = [r for r in m.tracer.records() if not (port and r.name in PORT_ONLY)]
    by_id = {r.span_id: r for r in recs}
    spans = Counter(
        (r.subject, r.name, by_id[r.parent_id].name if r.parent_id in by_id else None)
        for r in recs
        if r.name != "bind"  # inline binds pass a wall-time gate
    )
    summary = m.pending.summary()
    # The listing is ordered by wall-clock recency; compare it by key.
    summary["pending"].sort(key=lambda row: row["key"])
    explains = {
        row["key"]: _no_wall(m.pending.explain(row["key"]))
        for row in summary["pending"]
    }
    traces = [
        (t.pod_key, t.outcome, t.node, t.nodes_total, t.nodes_feasible, t.message,
         sorted(ph for ph in t.phases_ms if not (port and ph in PORT_ONLY)))
        for t in m.recent_traces(10_000)
    ]
    bindings = sorted(
        (p.key, p.node_name) for p in stack.cluster.list_pods() if p.node_name
    )
    phases = {
        ph: m.latency.count(phase=ph)
        for ph in ("prefilter", "filter", "score", "reserve", "permit",
                   "postfilter", "spec", "total")
    }
    return dict(
        bindings=bindings, values=values, phases=phases, traces=traces,
        summary=_no_wall(summary), explains=explains, slo=evals, spans=spans,
    )


def _no_wall(obj):
    if isinstance(obj, dict):
        return {k: _no_wall(v) for k, v in obj.items() if not k.endswith("_wall_unix")}
    if isinstance(obj, list):
        return [_no_wall(v) for v in obj]
    return obj


class TestSeededSweep:
    @pytest.mark.parametrize("seed,batch", [(0, 1), (1, 4), (2, 16)])
    def test_everything_observable_is_equal(self, seed, batch):
        ref = run_sweep("yoda_tpu", seed, batch)
        port = run_sweep("yoda_tpu_torch", seed, batch)
        for key in ref:
            assert port[key] == ref[key], key
        # The script exercises what it claims to.
        assert port["bindings"] and port["summary"]["count"] > 0
        assert port["phases"]["total"] > 0 and port["phases"]["filter"] > 0
        assert any(name == "gang-release" for _s, name, _p in port["spans"])


# --- threaded drive ---------------------------------------------------------


class TestThreadedDrive:
    def test_background_loops_and_scrapes_beside_serve_no_deadlock(self):
        """Default config (but the ladder's pace and its wall-time cycle
        signal), tracing on: the serve loop drains waves of
        singletons and gangs while the rebalancer (with its speculation
        tick), the node health monitor, the overload ladder and a scraper
        (``/metrics``, ``/debug/traces`` Perfetto, ``/debug/pending``,
        ``/debug/slo``) run on their own threads. Everything binds, every
        thread stops on time."""
        # The ladder ticks every 20 ms on its own thread; its cycle signal
        # (the total p99 in wall ms) is off, so a loaded test machine
        # cannot brown the serve loop out and make the bind count depend
        # on the machine's speed.
        stack = port_standalone.build_stack(
            config=port_config.SchedulerConfig(
                kernel_platform="cpu", batch_requests=8,
                overload_period_s=0.02, overload_queue_high=64,
                overload_cycle_ms_high=0,
            )
        )
        agent = port_agent.FakeTpuAgent(stack.cluster)
        for i in range(8):
            agent.add_host(f"h{i}", generation="v5e", chips=8)
        agent.publish_all()
        stack.reconciler.resync()
        server = port_server.MetricsServer(stack.metrics, host="127.0.0.1", port=0)
        server.start()
        stop = threading.Event()
        errors: list = []
        scrapes = [0]

        def scraper():
            base = f"http://127.0.0.1:{server.port}"
            try:
                while not stop.is_set():
                    for path in ("/metrics", "/debug/traces?format=perfetto",
                                 "/debug/pending", "/debug/slo"):
                        urllib.request.urlopen(base + path, timeout=10).read()
                    scrapes[0] += 1
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [
            threading.Thread(
                target=stack.rebalancer.run_forever, args=(stop,),
                kwargs=dict(period_s=0.05, spec_period_s=0.01), name="rebalancer",
            ),
            threading.Thread(
                target=stack.nodehealth.run_forever, args=(stop,),
                kwargs=dict(period_s=0.05), name="nodehealth",
            ),
            threading.Thread(
                target=stack.metrics.overload.run_forever, args=(stop,),
                name="overload",
            ),
            threading.Thread(target=scraper, name="scraper"),
        ]
        for t in threads:
            t.start()
        try:
            pod = port_types.PodSpec
            for w in range(3):
                for i in range(12):
                    stack.cluster.create_pod(pod(f"w{w}s{i}", labels={"tpu/chips": "1"}))
                for i in range(2):
                    stack.cluster.create_pod(pod(
                        f"w{w}g-{i}",
                        labels={"tpu/gang": f"w{w}g", "tpu/gang-size": "2",
                                "tpu/chips": "2"},
                    ))
                stack.scheduler.run_until_idle(max_wall_s=10)
                time.sleep(0.1)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
            server.stop()
        assert not [t.name for t in threads if t.is_alive()]
        assert not errors, errors
        assert scrapes[0] > 0
        bound = [p for p in stack.cluster.list_pods() if p.node_name]
        assert len(bound) == 42
        assert stack.metrics.binds.value() == 42
        assert stack.metrics.tracer.records()


class TestRunJ:
    def test_small_run_j_passes_its_checks_on_the_cpu(self):
        """chip_smoke's run (j) parts that the card run is compared on,
        (j1) and (j2), at OBSERVABILITY_SMALL on the CPU: the script's
        own checks hold (the ladder's full climb and step-down, SHED's
        parks and the in-flight gang, BROWNOUT's cap, the reload report,
        the span kinds, no split gang), so the card's run (j) fails only
        on what the card changes."""
        from chip_smoke import (
            OBSERVABILITY_SMALL,
            check_observability_run,
            run_observability,
        )

        run = run_observability("cpu", OBSERVABILITY_SMALL, reported=False)
        check_observability_run(run, OBSERVABILITY_SMALL)
        assert run["j1"]["launches"] == {"fleet_eval": 0, "joint_fit": 0}
        assert run["j2"]["steps"][-1]["level"] == "NOMINAL"
