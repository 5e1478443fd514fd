"""The port's speculative placement cache (yoda_tpu_torch/framework/
speculation.py and the scheduler's consume chain) held against the JAX
package's on the CPU, tolerance 0.

Every case of tests/test_speculation.py that needs only ported parts runs
as one script on both packages — ``yoda_tpu`` with its host mirror, the
port with ``TorchFleetKernel`` on the CPU (``device="cpu"``,
``kernel_platform: cpu``) — and the two runs must agree on what the
script observes: key equality, the invalidation matrix and the consume
contract on stub feeds, then bindings and ``stats()`` through whole
stacks. Left out: the reload cases (``apply_reloadable`` is not ported;
``configure`` itself is held here), the shard-resize flush drill (shards
are not ported) and the metrics-registry assertions (no registry in the
port).

Also here: a seeded stack script that drives ``speculate_once`` between
waves of hot-shape singletons under churn, at K = 1 and 16, both scoring
strategies and two seeds, comparing every binding, the plan node of every
shape after each tick and ``stats()``."""

import dataclasses
import random
import threading
import time
from types import SimpleNamespace

import pytest

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.types as ref_types
import yoda_tpu.cluster.informer as ref_informer
import yoda_tpu.config as ref_config
import yoda_tpu.framework.speculation as ref_spec
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent.fake_publisher as port_agent
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.cluster.informer as port_informer
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.framework.speculation as port_spec
import yoda_tpu_torch.standalone as port_standalone

REF = SimpleNamespace(
    name="ref", types=ref_types, spec=ref_spec, Agent=ref_agent.FakeTpuAgent,
    FleetDelta=ref_informer.FleetDelta, Config=ref_config.SchedulerConfig,
    build_stack=ref_standalone.build_stack, cache_kw={},
)
PORT = SimpleNamespace(
    name="port", types=port_types, spec=port_spec,
    Agent=port_agent.FakeTpuAgent, FleetDelta=port_informer.FleetDelta,
    Config=port_config.SchedulerConfig, build_stack=port_standalone.build_stack,
    cache_kw={"device": "cpu"},
)


def both(case, *args):
    """Runs ``case(side, *args)`` on the reference and on the port; their
    observations must be equal. Returns the port's."""
    want = case(REF, *args)
    got = case(PORT, *args)
    assert got == want
    return got


def chip_pod(side, name, chips=1, **labels):
    return side.types.PodSpec(name, labels={"tpu/chips": str(chips), **labels})


def make_cache(side, **over):
    """A cache with clean stub feeds: epochs never move, nothing ever
    changes, every node shows zero reserved chips."""
    kw = dict(
        changes_fn=lambda e: side.FleetDelta(
            epoch=e, changed=frozenset(), structural=False
        ),
        admission_changes_fn=lambda e: (e, frozenset()),
        reserved_fn=lambda node: 0,
        **side.cache_kw,
    )
    kw.update(over)
    return side.spec.SpeculativeCache(**kw)


def plant(side, cache, node="n0", base_reserved=0, key=("shape",)):
    plan = side.spec.SpecPlan(
        key=key, node=node, epoch_m=1, epoch_a=1, base_reserved=base_reserved,
        score=5,
    )
    cache._plans[key] = plan
    return plan


def counters(cache) -> dict:
    return cache.stats() | {"plan_keys": sorted(map(repr, cache._plans))}


# --- speculation_key ---


def key_view(key):
    """A key as plain values (the two packages' KernelRequest types are
    distinct classes)."""
    if key is None:
        return None
    adm, reqk = key
    return (repr(adm), dataclasses.astuple(reqk))


KEY_PODS = {
    "plain-1": ({"tpu/chips": "1"}, {}),
    "plain-2": ({"tpu/chips": "2"}, {}),
    "hbm-clock": ({"tpu/chips": "4", "tpu/hbm": "8Gi", "tpu/clock": "900"}, {}),
    "generation": ({"tpu/chips": "2", "tpu/generation": "v5p"}, {}),
    "gang": ({"tpu/chips": "4", "tpu/gang": "g", "tpu/gang-size": "2"}, {}),
    "topology": ({"tpu/chips": "4", "tpu/gang": "t", "tpu/topology": "2x2x1"}, {}),
    "cpu-request": ({"tpu/chips": "1"}, {"cpu_milli_request": 500}),
    "memory-request": ({"tpu/chips": "1"}, {"memory_request": 1 << 30}),
    "host-port": ({"tpu/chips": "1"}, {"host_ports": (8080,)}),
    "pvc": ({"tpu/chips": "1"}, {"pvc_names": ("claim",)}),
    "selector": ({"tpu/chips": "1"}, {"node_selector": {"pool": "a"}}),
    "bad-labels": ({"tpu/chips": "many"}, {}),
}


class TestSpeculationKey:
    @pytest.mark.parametrize("name", sorted(KEY_PODS))
    def test_same_key_or_scope(self, name):
        labels, kw = KEY_PODS[name]

        def case(side):
            return key_view(side.spec.speculation_key(
                side.types.PodSpec("p", labels=dict(labels), **kw)
            ))

        got = both(case)
        in_scope = name not in (
            "gang", "topology", "cpu-request", "memory-request", "host-port",
            "pvc", "bad-labels",
        )
        assert (got is not None) == in_scope

    def test_plain_chip_pod_is_in_scope_and_shape_stable(self):
        def case(side):
            a = side.spec.speculation_key(chip_pod(side, "a", 2))
            b = side.spec.speculation_key(chip_pod(side, "b", 2))
            c = side.spec.speculation_key(chip_pod(side, "c", 4))
            assert a is not None
            assert a == b, "same shape must key identically"
            assert a != c
            return key_view(a), key_view(c)

        both(case)


# --- the invalidation matrix ---


def clean_feeds_restamp(side):
    cache = make_cache(
        side,
        changes_fn=lambda e: side.FleetDelta(epoch=9, changed=frozenset(), structural=False),
        admission_changes_fn=lambda e: (7, frozenset()),
    )
    plan = plant(side, cache)
    assert cache.epoch_valid(plan)
    assert plan.epoch_m == 9 and plan.epoch_a == 7
    assert cache._plans[plan.key] is plan
    return counters(cache)


def touched_node(side):
    cache = make_cache(
        side,
        changes_fn=lambda e: side.FleetDelta(epoch=2, changed=frozenset({"n0"}), structural=False),
    )
    plan = plant(side, cache, node="n0")
    assert not cache.epoch_valid(plan)
    assert plan.key not in cache._plans
    assert cache.invalidations == 1
    return counters(cache)


def untouched_node(side):
    cache = make_cache(
        side,
        changes_fn=lambda e: side.FleetDelta(epoch=2, changed=frozenset({"n1"}), structural=False),
        admission_changes_fn=lambda e: (3, frozenset({"n2"})),
    )
    plan = plant(side, cache, node="n0")
    assert cache.epoch_valid(plan)
    return counters(cache)


def admission_touch(side):
    cache = make_cache(side, admission_changes_fn=lambda e: (3, frozenset({"n0"})))
    plan = plant(side, cache, node="n0")
    assert not cache.epoch_valid(plan)
    assert cache.invalidations == 1
    return counters(cache)


def structural_delta(side):
    cache = make_cache(
        side,
        changes_fn=lambda e: side.FleetDelta(epoch=2, changed=frozenset(), structural=True),
    )
    assert not cache.epoch_valid(plant(side, cache))
    return counters(cache)


def ring_behind(side):
    # A feed that can no longer answer must invalidate: unknown history is
    # stale history.
    out = []
    for over in ({"changes_fn": lambda e: None},
                 {"admission_changes_fn": lambda e: (4, None)}):
        cache = make_cache(side, **over)
        assert not cache.epoch_valid(plant(side, cache))
        out.append(counters(cache))
    return out


def unwired_feeds(side):
    out = []
    for over in ({"changes_fn": None}, {"admission_changes_fn": None}):
        cache = make_cache(side, **over)
        assert not cache.epoch_valid(plant(side, cache))
        out.append(counters(cache))
    return out


MATRIX = {
    f.__name__: f
    for f in (clean_feeds_restamp, touched_node, untouched_node, admission_touch,
              structural_delta, ring_behind, unwired_feeds)
}


class TestEpochValidity:
    @pytest.mark.parametrize("name", sorted(MATRIX))
    def test_matrix_case(self, name):
        both(MATRIX[name])


# --- the consume contract and the cache's lifecycle ---


def consume_once(side):
    cache = make_cache(side)
    plan = plant(side, cache)
    assert cache.consume_plan(plan) == "n0"
    assert cache.consume_plan(plan) is None
    assert cache.hits == 1
    return counters(cache)


def consume_replaced(side):
    # Identity, not key equality, is the win condition.
    cache = make_cache(side)
    stale = plant(side, cache)
    fresh = plant(side, cache)
    assert cache.consume_plan(stale) is None
    assert cache.consume_plan(fresh) == "n0"
    return counters(cache)


def reserve_rejected(side):
    cache = make_cache(side)
    plan = plant(side, cache)
    cache.consume_plan(plan)
    cache.reserve_rejected(plan)
    assert cache.reserve_rejects == 1
    assert cache.invalidations == 1
    return counters(cache)


def revalidate_fails_closed(side):
    """The spot check: a node missing from the snapshot, and a reserved
    reading that moved, both invalidate; no reserved source fails closed."""
    stack = side.build_stack(config=side.Config(kernel_platform="cpu"))
    agent = side.Agent(stack.cluster)
    agent.add_host("n0", generation="v5e", chips=8)
    agent.publish_all()
    snap = stack.informer.snapshot()
    pod = chip_pod(side, "p")
    out = []
    for node, reserved_fn in (("n0", lambda n: 0), ("gone", lambda n: 0),
                              ("n0", lambda n: 3), ("n0", None)):
        cache = make_cache(side, reserved_fn=reserved_fn)
        plan = plant(side, cache, node=node)
        out.append((cache.revalidate(plan, pod, snap), counters(cache)))
    return out


def flush_drops_all(side):
    cache = make_cache(side)
    plant(side, cache, key=("a",))
    plant(side, cache, key=("b",))
    cache._shapes[("a",)] = chip_pod(side, "a")
    assert cache.flush() == 2
    assert cache._plans == {} and cache._shapes == {}
    assert cache.invalidations == 2
    return counters(cache)


def configure_shrink(side):
    cache = make_cache(side)
    for i in range(4):
        plant(side, cache, key=(f"k{i}",))
    cache.configure(size=2)
    assert set(cache._plans) == {("k2",), ("k3",)}
    assert cache.invalidations == 2
    return counters(cache)


def configure_disable(side):
    cache = make_cache(side)
    plant(side, cache)
    cache.configure(enabled=False)
    assert not cache.enabled and cache._plans == {}
    assert cache.lookup(chip_pod(side, "p")) is None  # disabled: no tracking
    assert cache._shapes == {}
    return counters(cache)


def lookup_bounded(side):
    cache = make_cache(side)
    cache.configure(shapes_max=2)
    for i in range(5):
        cache.lookup(chip_pod(side, f"p{i}", chips=i + 1))
    assert len(cache._shapes) == 2
    assert cache.misses == 5
    return counters(cache)


CONTRACT = {
    f.__name__: f
    for f in (consume_once, consume_replaced, reserve_rejected,
              revalidate_fails_closed, flush_drops_all, configure_shrink,
              configure_disable, lookup_bounded)
}


class TestConsumeContract:
    @pytest.mark.parametrize("name", sorted(CONTRACT))
    def test_contract_case(self, name):
        both(CONTRACT[name])


# --- the serve path through whole stacks ---


def make_stack(side, **cfg):
    stack = side.build_stack(config=side.Config(kernel_platform="cpu", **cfg))
    agent = side.Agent(stack.cluster)
    return stack, agent


def node_of(stack, name):
    pod = stack.cluster.get_pod(f"default/{name}")
    return pod.node_name if pod is not None else "gone"


def hot_shape(side):
    stack, agent = make_stack(side)
    agent.add_host("h0", generation="v5e", chips=8)
    agent.publish_all()
    spec = stack.speculation
    stack.cluster.create_pod(chip_pod(side, "cold"))
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert node_of(stack, "cold") == "h0"
    assert spec.misses >= 1 and spec.hits == 0
    assert spec.speculate_once() == 1
    stack.cluster.create_pod(chip_pod(side, "hot"))
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert node_of(stack, "hot") == "h0"
    assert spec.hits == 1
    return spec.stats(), stack.accountant.chips_by_node()


def single_use(side):
    stack, agent = make_stack(side)
    agent.add_host("h0", generation="v5e", chips=8)
    agent.publish_all()
    spec = stack.speculation
    stack.cluster.create_pod(chip_pod(side, "cold"))
    stack.scheduler.run_until_idle(max_wall_s=5)
    spec.speculate_once()
    stack.cluster.create_pod(chip_pod(side, "hot-1"))
    stack.cluster.create_pod(chip_pod(side, "hot-2"))
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert node_of(stack, "hot-1") == "h0" and node_of(stack, "hot-2") == "h0"
    assert spec.hits == 1
    return spec.stats()


def cordon_invalidates(side):
    stack, agent = make_stack(side)
    agent.add_host("h0", generation="v5e", chips=8)
    agent.publish_all()
    spec = stack.speculation
    stack.cluster.create_pod(chip_pod(side, "cold"))
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert spec.speculate_once() == 1
    stack.cluster.put_node(side.types.K8sNode("h0", unschedulable=True))
    stack.cluster.create_pod(chip_pod(side, "hot"))
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert node_of(stack, "hot") is None
    assert spec.hits == 0 and spec.invalidations >= 1
    return spec.stats()


def reserved_drift(side):
    stack, agent = make_stack(side)
    agent.add_host("h0", generation="v5e", chips=8)
    agent.publish_all()
    spec = stack.speculation
    stack.cluster.create_pod(chip_pod(side, "cold"))
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert spec.speculate_once() == 1
    # A foreign claim the epoch feeds cannot see: the consume-time
    # equality against the live accountant must fail closed, and the pod
    # still binds through the full path.
    spec.reserved_fn = lambda node: 999
    stack.cluster.create_pod(chip_pod(side, "hot"))
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert node_of(stack, "hot") == "h0"
    assert spec.hits == 0 and spec.invalidations >= 1
    return spec.stats()


def disabled_cache(side):
    stack, agent = make_stack(side, spec_enabled=False)
    agent.add_host("h0", generation="v5e", chips=8)
    agent.publish_all()
    spec = stack.speculation
    stack.cluster.create_pod(chip_pod(side, "p"))
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert node_of(stack, "p") == "h0"
    assert spec.hits == 0 and spec.misses == 0
    assert spec.speculate_once() == 0
    return spec.stats()


def fenced_skips_plans(side):
    stack, agent = make_stack(side)
    agent.add_host("h0", generation="v5e", chips=8)
    agent.publish_all()
    spec = stack.speculation
    stack.cluster.create_pod(chip_pod(side, "cold"))
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert spec.speculate_once() == 1
    stack.scheduler.fence_fn = lambda: False
    stack.cluster.create_pod(chip_pod(side, "hot"))
    stack.scheduler.run_until_idle(max_wall_s=1)
    assert node_of(stack, "hot") is None
    stack.scheduler.fence_fn = None
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert node_of(stack, "hot") == "h0"
    return spec.stats()


def most_allocated_weights(side):
    """The cache evaluates with config.weights, not the strategy's
    effective weights the batch plugin gets — as the reference wires it:
    under most-allocated the plan's node is the least-allocated one."""
    stack, agent = make_stack(side, scoring_strategy="most-allocated")
    agent.add_host("h0", generation="v5e", chips=8)
    agent.add_host("h1", generation="v5e", chips=8)
    agent.publish_all()
    spec = stack.speculation
    for i in range(3):
        stack.cluster.create_pod(chip_pod(side, f"c{i}", 2))
        stack.scheduler.run_until_idle(max_wall_s=5)
    agent.publish_all()  # the agent reports the chips the pods use
    spec.speculate_once()
    plans = {repr(k): p.node for k, p in spec._plans.items()}
    stack.cluster.create_pod(chip_pod(side, "hot", 2))
    stack.scheduler.run_until_idle(max_wall_s=5)
    return plans, {n: node_of(stack, n) for n in ("c0", "c1", "c2", "hot")}, spec.stats()


SERVE = {
    f.__name__: f
    for f in (hot_shape, single_use, cordon_invalidates, reserved_drift,
              disabled_cache, fenced_skips_plans, most_allocated_weights)
}


class TestServeFastPath:
    @pytest.mark.parametrize("name", sorted(SERVE))
    def test_serve_case(self, name):
        both(SERVE[name])

    def test_most_allocated_plan_differs_from_full_path(self):
        plans, nodes, _ = most_allocated_weights(PORT)
        # The full path packed c0..c2 on one host; the plan for the shape
        # (config.weights: least-allocated) names the other.
        (plan_node,) = plans.values()
        assert len({nodes["c0"], nodes["c1"], nodes["c2"]}) == 1
        assert plan_node != nodes["c0"]
        assert nodes["hot"] == plan_node  # bound from the plan


class TestRebalancerSubTick:
    def test_subtick_speculates_between_rebalance_passes(self):
        stack, agent = make_stack(PORT)
        agent.add_host("h0", generation="v5e", chips=8)
        agent.publish_all()
        rb = stack.rebalancer
        rb.gate_fn = None  # leadership/resync gating is not under test
        calls = {"spec": 0, "run": 0}
        rb.speculator = SimpleNamespace(
            speculate_once=lambda: calls.__setitem__("spec", calls["spec"] + 1)
        )
        rb.run_once = lambda: calls.__setitem__("run", calls["run"] + 1)
        stop = threading.Event()
        t = threading.Thread(
            target=rb.run_forever, args=(stop,),
            kwargs={"period_s": 0.08, "spec_period_s": 0.02}, daemon=True,
        )
        t.start()
        time.sleep(0.6)
        stop.set()
        t.join(timeout=2)
        assert not t.is_alive()
        assert calls["run"] >= 1, "rebalance pass starved by sub-ticks"
        assert calls["spec"] > calls["run"], calls

    def test_gate_holds_both_ticks_until_resync(self):
        stack, agent = make_stack(PORT)
        agent.add_host("h0", generation="v5e", chips=8)
        agent.publish_all()
        rb = stack.rebalancer
        assert rb.speculator is stack.speculation
        assert not rb.gate_fn()  # not resynced yet
        stack.reconciler.resync()
        assert rb.gate_fn()
        stack.scheduler.fence_fn = lambda: False
        assert not rb.gate_fn()


def churn_script(side, seed: int, burst: int, strategy: str) -> dict:
    """Seeded churn (cordons, republishes, mixed shapes) racing speculative
    binds: after every round no node is above capacity and accounting
    equals the chips of bound pods. Returns what both packages must agree
    on: every binding, each tick's plan nodes, and the counters."""
    rng = random.Random(seed)
    stack, agent = make_stack(side, batch_requests=burst, scoring_strategy=strategy)
    hosts = [f"h{i}" for i in range(6)]
    for h in hosts:
        agent.add_host(h, generation="v5e", chips=8)
    agent.publish_all()
    spec = stack.speculation
    cordoned: set[str] = set()
    made, ticks = 0, []
    for rnd in range(25):
        for _ in range(rng.randint(1, 3)):
            stack.cluster.create_pod(
                chip_pod(side, f"p{made}", chips=rng.choice([1, 1, 1, 2]))
            )
            made += 1
        if rng.random() < 0.7:
            produced = spec.speculate_once()
            ticks.append((rnd, produced, sorted(
                (repr(k[1].number), p.node, p.base_reserved)
                for k, p in spec._plans.items()
            )))
        if rng.random() < 0.3:
            h = rng.choice(hosts)
            if h in cordoned:
                cordoned.discard(h)
                stack.cluster.put_node(side.types.K8sNode(h))
            else:
                cordoned.add(h)
                stack.cluster.put_node(side.types.K8sNode(h, unschedulable=True))
        if rng.random() < 0.3:
            agent.publish_all()
        stack.scheduler.run_until_idle(max_wall_s=10)
        by_node = stack.accountant.chips_by_node()
        for node, used in by_node.items():
            assert used <= 8, (rnd, node, used)
        bound_chips = sum(
            int(p.labels["tpu/chips"])
            for p in stack.cluster.list_pods()
            if p.node_name is not None
        )
        assert sum(by_node.values()) == bound_chips, rnd
    return dict(
        bindings={f"p{i}": node_of(stack, f"p{i}") for i in range(made)},
        ticks=ticks,
        stats=spec.stats(),
        outcomes=[(r.pod_key, r.outcome, r.node) for r in stack.scheduler.stats.results],
    )


class TestSeededStalenessSweep:
    @pytest.mark.parametrize("seed", [17, 29])
    @pytest.mark.parametrize("burst", [1, 16])
    @pytest.mark.parametrize("strategy", ["least-allocated", "most-allocated"])
    def test_churn_racing_cache_hits(self, seed, burst, strategy):
        got = both(churn_script, seed, burst, strategy)
        # Both sides of the race ran: plans were consumed and invalidated.
        assert got["stats"]["hits"] >= 1, got["stats"]
        assert got["stats"]["invalidations"] >= 1, got["stats"]
