"""The port's rebalancer (yoda_tpu_torch/rebalance: fragmentation score,
priority preemption, elastic resize, repack moves) and the elastic gang
surface it drives, held against the JAX package's on the CPU, tolerance 0.

Every case of tests/test_rebalance.py that needs only ported parts runs as
one script on both packages (``kernel_platform: cpu``, preemption off, a
repack gain threshold of 0.01, as there) and the two runs must agree on
every binding, every RebalanceReport field, the effective sizes, the
fragmentation scores and the binder's unbind count. Left out: the crash
mid-migration case and the seeded chaos sweep (the chaos harness and
``serve_forever`` are not ported) and the metrics-registry assertions (no
registry in the port). The aborted move refuses every unbind through a
cluster whose ``unbind_pod`` raises, in place of the chaos plan. Every
case of that file, those left out here included, also runs whole on both
packages from its own source in test_torch_parity_rebalance.py.

Also here: a seeded whole-stack script over a mixed fleet (v5p slices and
v5e hosts) that drives ``reconciler.resync``, ``rebalancer.run_once``,
``speculation.speculate_once`` and ``reconciler.reconcile`` at the same
points on both packages, across seeds, both scoring strategies and K = 1
and 16: bindings, unbinds, reports, plan nodes and ``stats()`` equal."""

import dataclasses
import random
import time
from types import SimpleNamespace

import pytest

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.requests as ref_requests
import yoda_tpu.api.types as ref_types
import yoda_tpu.cluster.fake as ref_fake
import yoda_tpu.config as ref_config
import yoda_tpu.rebalance as ref_rebalance
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent.fake_publisher as port_agent
import yoda_tpu_torch.api.requests as port_requests
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.cluster.fake as port_fake
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.rebalance as port_rebalance
import yoda_tpu_torch.standalone as port_standalone

REF = SimpleNamespace(
    name="ref", types=ref_types, requests=ref_requests, fake=ref_fake,
    rebalance=ref_rebalance, Agent=ref_agent.FakeTpuAgent,
    Config=ref_config.SchedulerConfig, build_stack=ref_standalone.build_stack,
)
PORT = SimpleNamespace(
    name="port", types=port_types, requests=port_requests, fake=port_fake,
    rebalance=port_rebalance, Agent=port_agent.FakeTpuAgent,
    Config=port_config.SchedulerConfig, build_stack=port_standalone.build_stack,
)


def both(case, *args):
    """Runs ``case(side, *args)`` on the reference and on the port; their
    observations must be equal. Returns the port's."""
    want = case(REF, *args)
    got = case(PORT, *args)
    assert got == want
    return got


def make_stack(side, cluster=None, **cfg):
    cfg.setdefault("kernel_platform", "cpu")
    cfg.setdefault("enable_preemption", False)
    cfg.setdefault("rebalance_min_gain", 0.01)
    stack = side.build_stack(cluster=cluster, config=side.Config(**cfg))
    return stack, side.Agent(stack.cluster)


def pod(side, name, **labels):
    return side.types.PodSpec(name, labels=dict(labels))


def topo_gang(side, tag, shape, chips=4):
    size = 1
    for d in shape.split("x"):
        size *= int(d)
    labels = {"tpu/gang": tag, "tpu/topology": shape, "tpu/chips": str(chips)}
    return [side.types.PodSpec(f"{tag}-{i}", labels=dict(labels)) for i in range(size)]


def plain_gang(side, tag, n, chips=4, prio=0, **extra):
    labels = {
        "tpu/gang": tag, "tpu/gang-size": str(n), "tpu/chips": str(chips),
        "tpu/priority": str(prio), **extra,
    }
    return [side.types.PodSpec(f"{tag}-{i}", labels=dict(labels)) for i in range(n)]


def elastic(side, tag, size, lo, hi, chips=2, prio=0, n=None):
    labels = {
        "tpu/gang": tag, "tpu/gang-size": str(size),
        "tpu/min-members": str(lo), "tpu/max-members": str(hi),
        "tpu/chips": str(chips), "tpu/priority": str(prio),
    }
    return [
        side.types.PodSpec(f"{tag}-{i}", labels=dict(labels))
        for i in range(n if n is not None else hi)
    ]


def create(stack, pods, run_s=30):
    for p in pods:
        stack.cluster.create_pod(p)
    stack.scheduler.run_until_idle(max_wall_s=run_s)


def bound_map(stack):
    return {p.name: p.node_name for p in stack.cluster.list_pods() if p.node_name}


def frag(side, stack):
    return side.rebalance.fragmentation_score(
        stack.informer.snapshot(), stack.accountant.chips_by_node()
    )


def report_view(report) -> dict:
    """A report's fields, less its wall time."""
    out = dataclasses.asdict(report)
    out.pop("duration_ms", None)
    return out


def check_invariants(side, stack):
    """No host above its healthy chips (bound pods and accounting), and
    every gang bound 0 or within [floor, ceiling]."""
    caps = {t.name: len(t.healthy_chips()) for t in stack.cluster.list_tpu_metrics()}
    used: dict[str, int] = {}
    members: dict[str, list] = {}
    for p in stack.cluster.list_pods():
        req = side.requests.pod_request(p)
        if p.node_name:
            used[p.node_name] = used.get(p.node_name, 0) + req.effective_chips
        if req.gang is not None:
            members.setdefault(req.gang.name, []).append((req.gang, p.node_name))
    for host, n in used.items():
        assert n <= caps.get(host, 0), f"{host}: {n}/{caps.get(host, 0)}"
    for host, cap in caps.items():
        assert stack.accountant.chips_in_use(host) <= cap
    for g, ms in members.items():
        spec = ms[0][0]
        bound = sum(1 for _, n in ms if n)
        floor = spec.floor if spec.elastic else spec.size
        ceiling = spec.ceiling if spec.elastic else spec.size
        assert bound == 0 or floor <= bound <= ceiling, (g, bound, floor, ceiling)


# --- elastic gang labels ---


ELASTIC_LABELS = {
    "min-max": {"tpu/gang": "e", "tpu/gang-size": "4", "tpu/min-members": "2",
                "tpu/max-members": "6"},
    "rigid": {"tpu/gang": "g", "tpu/gang-size": "3"},
    "min-above-size": {"tpu/gang": "e", "tpu/gang-size": "2", "tpu/min-members": "3"},
    "max-below-size": {"tpu/gang": "e", "tpu/gang-size": "4", "tpu/max-members": "3"},
    "elastic-topology": {"tpu/gang": "e", "tpu/topology": "2x2x1",
                         "tpu/min-members": "2"},
    "bounds-without-gang": {"tpu/min-members": "2"},
}


class TestElasticSpec:
    @pytest.mark.parametrize("name", sorted(ELASTIC_LABELS))
    def test_parse(self, name):
        def case(side):
            try:
                g = side.requests.parse_request(dict(ELASTIC_LABELS[name])).gang
            except side.requests.LabelParseError:
                return "rejected"
            return (g.elastic, g.floor, g.size, g.ceiling)

        got = both(case)
        want = {"min-max": (True, 2, 4, 6), "rigid": (False, 3, 3, 3)}
        assert got == want.get(name, "rejected")


# --- fragmentation ---


def slice_stack(side):
    stack, agent = make_stack(side)
    agent.add_slice("s", generation="v5p", host_topology=(6, 1, 1))
    agent.publish_all()
    return stack, agent


def frag_empty(side):
    stack, _ = slice_stack(side)
    assert frag(side, stack) == 0.0
    return frag(side, stack)


def frag_contiguous(side):
    stack, _ = slice_stack(side)
    create(stack, topo_gang(side, "a", "2x1x1"))
    assert frag(side, stack) == 0.0
    return bound_map(stack), frag(side, stack)


def fragmented(side, cluster=None):
    """Gang b bound mid-slice with free islands on both sides."""
    stack, agent = make_stack(side, cluster=cluster)
    agent.add_slice("s", generation="v5p", host_topology=(6, 1, 1))
    agent.publish_all()
    create(stack, topo_gang(side, "a", "2x1x1"))
    create(stack, topo_gang(side, "b", "2x1x1"))
    for p in list(stack.cluster.list_pods()):
        if p.name.startswith("a-"):
            stack.cluster.delete_pod(p.key)
    stack.scheduler.run_until_idle(max_wall_s=5)
    return stack


def frag_hole(side):
    stack = fragmented(side)
    assert frag(side, stack) == pytest.approx(0.25)
    return bound_map(stack), frag(side, stack)


def frag_stranded(side):
    stack, agent = make_stack(side)
    agent.add_host("h0", generation="v5e", chips=8)
    agent.add_host("h1", generation="v5e", chips=8)
    agent.publish_all()
    create(stack, [pod(side, "p", **{"tpu/chips": "4"})])
    assert frag(side, stack) == pytest.approx(0.5 * 4 / 12)
    return frag(side, stack)


def frag_edits(side):
    stack, _ = slice_stack(side)
    occ = side.rebalance.FleetOccupancy.from_snapshot(stack.informer.snapshot(), {})
    before = occ.score()
    occ.occupy("s-2", 4)
    assert occ.free_chips("s-2") == 0
    after = occ.score()
    assert after > before
    occ.release("s-2", 4)
    assert occ.score() == before
    return before, after


FRAG = {f.__name__: f for f in (frag_empty, frag_contiguous, frag_hole,
                                frag_stranded, frag_edits)}


class TestFragmentationScore:
    @pytest.mark.parametrize("name", sorted(FRAG))
    def test_score_case(self, name):
        both(FRAG[name])


# --- repack ---


def repack_moves(side):
    stack = fragmented(side)
    report = stack.rebalancer.run_once()
    assert report.moves == ["b"]
    stack.scheduler.run_until_idle(max_wall_s=30)
    check_invariants(side, stack)
    bound = bound_map(stack)
    assert sorted(bound) == ["b-0", "b-1"]
    assert sorted(bound.values()) == ["s-0", "s-1"]
    assert frag(side, stack) == 0.0
    return report_view(report), bound, stack.binder.unbinds


def repack_converges(side):
    stack = fragmented(side)
    first = stack.rebalancer.run_once()
    stack.scheduler.run_until_idle(max_wall_s=30)
    report = stack.rebalancer.run_once()
    assert report.moves == [] and report.fragmentation_before == 0.0
    return report_view(first), report_view(report), stack.rebalancer.passes


def repack_gain_threshold(side):
    stack = fragmented(side)
    stack.rebalancer.min_gain = 0.9
    report = stack.rebalancer.run_once()
    assert report.moves == []
    assert sorted(bound_map(stack).values()) == ["s-2", "s-3"]
    return report_view(report)


def repack_aborted(side):
    # Every unbind refuses: the move aborts, membership is restored, and
    # the gang must end whole where it was.
    def refuse(self, pod_key, node_name):
        raise ValueError(f"unbind of {pod_key} refused")

    refusing = type("RefusingUnbind", (side.fake.FakeCluster,), {"unbind_pod": refuse})
    stack = fragmented(side, cluster=refusing())
    report = stack.rebalancer.run_once()
    assert report.moves == [] and report.aborted_moves == ["b"]
    stack.scheduler.run_until_idle(max_wall_s=30)
    check_invariants(side, stack)
    assert sorted(bound_map(stack)) == ["b-0", "b-1"]
    return report_view(report), bound_map(stack), stack.gang.gang_status("b")


def repack_fenced(side):
    stack = fragmented(side)
    stack.scheduler.fence_fn = lambda: False
    report = stack.rebalancer.run_once()
    assert report.moves == [] and report.aborted_moves == ["b"]
    assert sorted(bound_map(stack).values()) == ["s-2", "s-3"]
    return report_view(report)


REPACK = {f.__name__: f for f in (repack_moves, repack_converges,
                                  repack_gain_threshold, repack_aborted,
                                  repack_fenced)}


class TestRepack:
    @pytest.mark.parametrize("name", sorted(REPACK))
    def test_repack_case(self, name):
        both(REPACK[name])


# --- priority preemption ---


def v5e_stack(side, hosts=2, chips=8):
    stack, agent = make_stack(side)
    for i in range(hosts):
        agent.add_host(f"h{i}", generation="v5e", chips=chips)
    agent.publish_all()
    return stack


def preempt_singletons(side):
    stack = v5e_stack(side)
    create(stack, [pod(side, f"low-{i}", **{"tpu/chips": "4", "tpu/priority": "1"})
                   for i in range(4)])
    create(stack, plain_gang(side, "hi", 2, chips=8, prio=10), run_s=10)
    assert not any(n.startswith("hi") for n in bound_map(stack))
    report = stack.rebalancer.run_once()
    assert report.admitted_gangs == ["hi"] and len(report.preempted) == 4
    assert report.preempted_weight > 0
    stack.scheduler.run_until_idle(max_wall_s=30)
    bound = bound_map(stack)
    assert sorted(n for n in bound if n.startswith("hi")) == ["hi-0", "hi-1"]
    low = [p for p in stack.cluster.list_pods() if p.name.startswith("low")]
    assert len(low) == 4 and all(p.node_name is None for p in low)
    check_invariants(side, stack)
    return report_view(report), bound, stack.binder.unbinds


def preempt_gang_whole(side):
    stack = v5e_stack(side)
    create(stack, plain_gang(side, "lowg", 4, chips=4, prio=1))
    create(stack, plain_gang(side, "hig", 2, chips=8, prio=10), run_s=10)
    report = stack.rebalancer.run_once()
    assert report.admitted_gangs == ["hig"]
    assert sorted(report.preempted) == [f"default/lowg-{i}" for i in range(4)]
    stack.scheduler.run_until_idle(max_wall_s=30)
    check_invariants(side, stack)
    after_admit = bound_map(stack)
    for p in list(stack.cluster.list_pods()):
        if p.name.startswith("hig"):
            stack.cluster.delete_pod(p.key)
    stack.scheduler.run_until_idle(max_wall_s=30)
    bound = bound_map(stack)
    assert sorted(bound) == [f"lowg-{i}" for i in range(4)]
    check_invariants(side, stack)
    return report_view(report), after_admit, bound


def preempt_never_equal(side):
    stack = v5e_stack(side)
    create(stack, [pod(side, f"eq-{i}", **{"tpu/chips": "4", "tpu/priority": "10"})
                   for i in range(4)])
    create(stack, plain_gang(side, "hi", 2, chips=8, prio=10), run_s=10)
    report = stack.rebalancer.run_once()
    assert report.preempted == [] and report.admitted_gangs == []
    assert len(bound_map(stack)) == 4
    return report_view(report)


def preempt_min_weight(side):
    stack = v5e_stack(side)
    create(stack, [pod(side, "mid", **{"tpu/chips": "8", "tpu/priority": "5"})]
           + [pod(side, f"low-{i}", **{"tpu/chips": "4", "tpu/priority": "1"})
              for i in range(2)])
    create(stack, plain_gang(side, "hi", 1, chips=8, prio=10), run_s=10)
    report = stack.rebalancer.run_once()
    assert report.admitted_gangs == ["hi"]
    assert sorted(report.preempted) == ["default/low-0", "default/low-1"]
    assert stack.cluster.get_pod("default/mid").node_name
    return report_view(report), bound_map(stack)


PREEMPT = {f.__name__: f for f in (preempt_singletons, preempt_gang_whole,
                                   preempt_never_equal, preempt_min_weight)}


class TestPreemption:
    @pytest.mark.parametrize("name", sorted(PREEMPT))
    def test_preemption_case(self, name):
        both(PREEMPT[name])


# --- elastic resize ---


def elastic_desired_size(side):
    stack = v5e_stack(side)
    create(stack, elastic(side, "e", 4, 2, 6))
    assert len(bound_map(stack)) == 4
    assert stack.gang.effective_size("e") == 4
    return bound_map(stack), stack.gang.gang_status("e")


def elastic_grows(side):
    stack = v5e_stack(side)
    create(stack, elastic(side, "e", 4, 2, 6))
    report = stack.rebalancer.run_once()
    assert report.resizes == {"e": (4, 6)}
    stack.scheduler.run_until_idle(max_wall_s=30)
    assert len(bound_map(stack)) == 6
    check_invariants(side, stack)
    return report_view(report), bound_map(stack), stack.gang.effective_size("e")


def elastic_shrinks(side):
    stack = v5e_stack(side, hosts=1)
    create(stack, elastic(side, "e", 4, 2, 4, chips=2, prio=0, n=4))
    assert len(bound_map(stack)) == 4
    create(stack, plain_gang(side, "hi", 2, chips=2, prio=10), run_s=10)
    report = stack.rebalancer.run_once()
    assert report.resizes.get("e", (0, 0))[1] == 2
    stack.scheduler.run_until_idle(max_wall_s=30)
    bound = bound_map(stack)
    assert sorted(n for n in bound if n.startswith("hi")) == ["hi-0", "hi-1"]
    assert len([n for n in bound if n.startswith("e-")]) == 2
    assert stack.gang.effective_size("e") == 2
    check_invariants(side, stack)
    return report_view(report), bound


def elastic_shrink_refused(side):
    stack = v5e_stack(side, hosts=1)
    create(stack, elastic(side, "e", 4, 2, 4, chips=2, prio=10, n=4))
    create(stack, plain_gang(side, "hi", 2, chips=2, prio=10), run_s=10)
    report = stack.rebalancer.run_once()
    assert report.preempted == []
    assert len([n for n in bound_map(stack) if n.startswith("e-")]) == 4
    return report_view(report)


def elastic_parked_shrunk(side):
    stack = v5e_stack(side, hosts=1)
    create(stack, [pod(side, "pin", **{"tpu/chips": "4", "tpu/priority": "50"})], run_s=10)
    create(stack, elastic(side, "e", 4, 2, 4, chips=2, prio=1, n=4), run_s=10)
    assert not any(n.startswith("e-") for n in bound_map(stack))
    report = stack.rebalancer.run_once()
    assert report.resizes.get("e") == (4, 2)
    stack.scheduler.run_until_idle(max_wall_s=30)
    assert len([n for n in bound_map(stack) if n.startswith("e-")]) == 2
    check_invariants(side, stack)
    return report_view(report), bound_map(stack)


def elastic_surplus_message(side):
    """A surplus member parks with the effective-size message, and a
    rigid gang cannot be resized."""
    stack = v5e_stack(side)
    create(stack, elastic(side, "e", 2, 1, 3, n=3) + plain_gang(side, "r", 2, chips=2))
    msgs = sorted({r.message for r in stack.scheduler.stats.results
                   if r.outcome == "unschedulable"})
    return (msgs, stack.gang.set_effective_size("r", 1),
            stack.gang.set_effective_size("e", 9), stack.gang.set_effective_size("e", 0),
            stack.gang.effective_size("nope"))


ELASTIC = {f.__name__: f for f in (elastic_desired_size, elastic_grows,
                                   elastic_shrinks, elastic_shrink_refused,
                                   elastic_parked_shrunk, elastic_surplus_message)}


class TestElasticResize:
    @pytest.mark.parametrize("name", sorted(ELASTIC))
    def test_elastic_case(self, name):
        both(ELASTIC[name])


# --- the queue's transactional take ---


def take_and_find(side):
    stack = v5e_stack(side, hosts=1, chips=2)
    create(stack, plain_gang(side, "g", 4, chips=2) + [pod(side, "s", **{"tpu/chips": "1"})],
           run_s=2)
    q = stack.queue
    taken = q.take_gang("g")
    names = [t.pod.name for t in taken]
    assert q.take_gang("g") == []
    assert q.find(taken[0].pod.uid) is None
    for t in taken:
        q.readd(t)
    found = q.find(taken[0].pod.uid)
    return names, found.name if found else None, q.find("nope"), q.depths()


class TestQueueTake:
    def test_take_gang_and_find(self):
        names, found, missing, _ = both(take_and_find)
        assert sorted(names) == [f"g-{i}" for i in range(4)]
        assert found == names[0] and missing is None


# --- whole-stack parity with every background part driven ---


def background_script(side, seed: int, burst: int, strategy: str) -> dict:
    """One seeded script: a v5p slice fleet and v5e hosts, priority-1
    fillers, topology gangs that get holes punched around them, a parked
    high-priority plain gang, an elastic gang, hot singleton shapes, and at
    fixed points resync / speculate_once / run_once / reconcile. Returns
    everything both packages must agree on."""
    rng = random.Random(seed)
    stack, agent = make_stack(
        side, batch_requests=burst, scoring_strategy=strategy,
        rebalance_max_victims=16,
    )
    for s in range(2):
        agent.add_slice(f"s{s}", generation="v5p", host_topology=(6, 1, 1))
    for h in range(6):
        agent.add_host(f"e{h}", generation="v5e", chips=8)
    agent.publish_all()
    out: dict = {"reports": []}
    made: list[str] = []

    def add(pods, run_s=10):
        made.extend(p.name for p in pods)
        create(stack, pods, run_s)

    rec, rb, spec = stack.reconciler, stack.rebalancer, stack.speculation
    out["reports"].append(("resync", report_view(rec.resync())))
    # Fill: singletons at priority 1 over the v5e hosts, topology gangs on
    # the slices.
    add([pod(side, f"f{i}", **{"tpu/chips": str(rng.choice([2, 4])),
                               "tpu/priority": "1", "tpu/generation": "v5e"})
         for i in range(16)])
    for g in range(3):
        add(topo_gang(side, f"t{g}", "2x1x1"))
    # Punch holes: delete the outer gangs, so the middle one sits between
    # free islands.
    for p in list(stack.cluster.list_pods()):
        if p.name.startswith(("t0-", "t2-")):
            stack.cluster.delete_pod(p.key)
    stack.scheduler.run_until_idle(max_wall_s=5)
    # Hot shapes: seen once, then planned, then served.
    add([pod(side, f"h{i}", **{"tpu/chips": str(c), "tpu/priority": "2"})
         for i, c in enumerate((1, 2, 1, 2))])
    out["produced"] = [spec.speculate_once()]
    out["plans"] = [sorted((repr(k[1].number), p.node) for k, p in spec._plans.items())]
    add([pod(side, f"hot{i}", **{"tpu/chips": str(rng.choice([1, 2])), "tpu/priority": "2"})
         for i in range(6)])
    # A parked high-priority gang and an elastic one.
    add(plain_gang(side, "hi", 2, chips=8, prio=100, **{"tpu/generation": "v5e"}), run_s=5)
    add(elastic(side, "el", 2, 1, 4, chips=2, prio=5), run_s=5)
    for _ in range(3):
        out["produced"].append(spec.speculate_once())
        out["plans"].append(sorted((repr(k[1].number), p.node) for k, p in spec._plans.items()))
        out["reports"].append(("rebalance", report_view(rb.run_once())))
        stack.scheduler.run_until_idle(max_wall_s=10)
        check_invariants(side, stack)
    # Drift: a dropped deletion and a leaked claim.
    victim = next(
        p for p in stack.cluster.list_pods()
        if p.node_name and "tpu/gang" not in p.labels
    )
    stack.cluster.suppress_kinds.add("Pod")
    stack.cluster.delete_pod(victim.key)
    stack.cluster.suppress_kinds.clear()
    stack.accountant._claim("leak-uid", "e0", 1)
    out["reports"].append(("reconcile", report_view(rec.reconcile(relist=False))))
    stack.scheduler.run_until_idle(max_wall_s=10)
    check_invariants(side, stack)
    out["bindings"] = {
        n: (p.node_name if (p := stack.cluster.get_pod(f"default/{n}")) else "gone")
        for n in made
    }
    out["unbinds"] = stack.binder.unbinds
    out["stats"] = spec.stats()
    out["effective"] = stack.gang.effective_size("el")
    out["frag"] = frag(side, stack)
    return out


class TestBackgroundStackParity:
    @pytest.mark.parametrize("seed", [3, 11])
    @pytest.mark.parametrize("burst", [1, 16])
    @pytest.mark.parametrize("strategy", ["least-allocated", "most-allocated"])
    def test_same_bindings_reports_and_plans(self, seed, burst, strategy):
        got = both(background_script, seed, burst, strategy)
        kinds = [kind for kind, _ in got["reports"]]
        assert kinds == ["resync"] + ["rebalance"] * 3 + ["reconcile"]
        rebalance = [r for kind, r in got["reports"] if kind == "rebalance"]
        # The script exercises the passes it claims to.
        assert any(r["preempted"] for r in rebalance) or any(r["admitted_gangs"] for r in rebalance)
        assert got["stats"]["hits"] >= 1
        drift = got["reports"][-1][1]
        assert drift["ghost_pods"] == 1 and drift["leaked_reservations"] == 1


class TestRunH:
    """chip_smoke.py's run (h) at the tests' size on the CPU (the card runs
    it at full size and against this same script): every check of the run
    holds — hits, preemption, resize and repack passes that settle, the
    adopted half-bound gang, the drift repairs, and the threaded run's
    invariants."""

    def test_background_run_holds_its_checks(self):
        from chip_smoke import (
            BACKGROUND_SMALL,
            check_background_run,
            print_background,
            run_background,
        )

        run = run_background("cpu", BACKGROUND_SMALL)
        check_background_run(run, BACKGROUND_SMALL)
        print_background(run, "cpu")
        assert run["h4"]["rebalance_passes"] >= 1 and run["h4"]["consumed"] >= 1
        assert any(p["moves"] for p in run["h2"]["passes"])

    def test_rerun_in_a_second_process_equals_the_run(self):
        """chip_smoke reruns (h1)-(h3) on the CPU in a spawned process beside
        the card's phases: its result equals the same run in this process
        in every field the card run is held to."""
        from chip_smoke import BACKGROUND_PARITY, BACKGROUND_SMALL, CpuRerun, run_background

        rerun = CpuRerun(BACKGROUND_SMALL)
        try:
            got = rerun.result(timeout_s=300)
        finally:
            rerun.stop()
        want = run_background("cpu", BACKGROUND_SMALL, threaded=False)
        assert got["h4"] is None
        for part, keys in BACKGROUND_PARITY.items():
            assert {k: got[part][k] for k in keys} == {k: want[part][k] for k in keys}

    def test_rebalance_dispatches_do_not_follow_the_host_speed(self, monkeypatch):
        """(h2) runs on a held scheduling clock: with the victims' retry
        backoff cut to 1 ms (a host a thousand times slower, as the backoff
        sees it) the run takes the same dispatches and passes. On the wall
        clock every expired backoff was retried until the drain's deadline,
        so the card's dispatch count could leave the CPU's."""
        from chip_smoke import BACKGROUND_SMALL, run_rebalance
        from yoda_tpu_torch.framework import queue as queue_mod

        want, stack = run_rebalance("cpu", BACKGROUND_SMALL)
        held = stack.scheduler.clock()
        time.sleep(0.01)
        assert stack.scheduler.clock() == held
        monkeypatch.setattr(queue_mod, "INITIAL_BACKOFF_S", 1e-3)
        monkeypatch.setattr(queue_mod, "MAX_BACKOFF_S", 1e-3)
        got, _ = run_rebalance("cpu", BACKGROUND_SMALL)
        keys = ("dispatch_count", "passes", "unbinds", "hi_bound", "el_bound", "effective_el")
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
