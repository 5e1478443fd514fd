"""The port's preemption (yoda_tpu_torch/plugins/yoda/preemption.py and its
wiring) held against the JAX package's on the CPU, tolerance 0.

Every scenario is one script run against yoda_tpu.standalone.build_stack
and the port's, both with kernel_platform "cpu", preemption on (unless the
case turns it off), the speculative placement cache built (as by default)
and a hand-driven scheduling clock. The script asserts what tests/test_preemption.py asserts
of the reference (batch mode; loop mode is not ported), and then the two
runs must agree on every pod's binding (or its eviction), the nominated
node on every surviving pod's status, ``preempted_total``,
``preempt_nominations``, the sequence of cycle outcomes and the speculative
cache's ``stats()``. Pods are
created in the same order on both sides: victims are ordered by
``creation_seq``.

Also here: the _avail_after capacity model's four unit cases on both
plugins, and the seeded mixed fleet of tests/test_torch_stack.py with
preemption on."""

import time

import numpy as np
import pytest

import yoda_tpu.api.types as ref_types
import yoda_tpu_torch.api.types as port_types
from test_torch_stack import fleet_script, run_script
from yoda_tpu.agent import FakeTpuAgent as RefAgent
from yoda_tpu.api.requests import parse_request as ref_parse_request
from yoda_tpu.config import SchedulerConfig as RefConfig
from yoda_tpu.framework.interfaces import NodeInfo as RefNodeInfo
from yoda_tpu.plugins.yoda.preemption import TpuPreemption as RefPreemption
from yoda_tpu.standalone import build_stack as ref_build_stack
from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
from yoda_tpu_torch.api.requests import parse_request
from yoda_tpu_torch.config import SchedulerConfig
from yoda_tpu_torch.framework.interfaces import NodeInfo
from yoda_tpu_torch.plugins.yoda.preemption import TpuPreemption
from yoda_tpu_torch.standalone import build_stack

GIB = 1 << 30
PORTS = ((8471, "TCP", "0.0.0.0"),)

SIDES = {
    "ref": (ref_build_stack, RefConfig, ref_types, RefAgent),
    "port": (build_stack, SchedulerConfig, port_types, FakeTpuAgent),
}


class FakeClock:
    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


class Ctx:
    """One side's stack, agent and clock, and the pods the script made."""

    def __init__(self, side: str, *, fake_clock: bool = False, **cfg) -> None:
        build, config, self.types, agent = SIDES[side]
        self.clock = FakeClock() if fake_clock else time.monotonic
        self.stack = build(
            config=config(kernel_platform="cpu", **cfg),
            clock=self.clock,
        )
        self.agent = agent(self.stack.cluster)
        self.created: list[str] = []

    def pod(self, name: str, labels: dict, **kw) -> None:
        self.stack.cluster.create_pod(self.types.PodSpec(name, labels=dict(labels), **kw))
        self.created.append(name)

    def gang(self, name: str, size: int, chips: int, priority: int, **extra) -> None:
        for m in range(size):
            self.pod(f"{name}-{m}", {
                "tpu/gang": name, "tpu/gang-size": str(size), "tpu/chips": str(chips),
                "tpu/priority": str(priority), **extra,
            })

    def run(self, max_wall_s: float = 5) -> None:
        self.stack.scheduler.run_until_idle(max_wall_s=max_wall_s)

    def get(self, name: str):
        return self.stack.cluster.get_pod(f"default/{name}")

    def node(self, name: str) -> "str | None":
        return self.get(name).node_name

    def bound(self, prefix: str = "") -> list[str]:
        return [p.name for p in self.stack.cluster.list_pods()
                if p.node_name and p.name.startswith(prefix)]

    @property
    def preempted(self) -> int:
        return self.stack.preemption.preempted_total

    def observe(self) -> dict:
        st = self.stack
        pods = {n: self.get(n) for n in self.created}
        return dict(
            bindings={n: p.node_name if p else "evicted" for n, p in pods.items()},
            nominated={n: p.nominated_node_name for n, p in pods.items() if p},
            preempted_total=st.preemption.preempted_total if st.preemption else None,
            nominations=st.scheduler.stats.preempt_nominations,
            outcomes=[(r.pod_key, r.outcome, r.node) for r in st.scheduler.stats.results],
            speculation=st.speculation.stats(),
        )


def both(script, **cfg) -> dict:
    """Runs ``script(ctx)`` on the reference and on the port; their
    observations must be equal. Returns the port's."""
    want = Ctx("ref", **cfg)
    script(want)
    got = Ctx("port", **cfg)
    script(got)
    assert got.observe() == want.observe()
    assert (got.stack.preemption is None) == (want.stack.preemption is None)
    return got.observe()


# --- single pods ---


def evicts_lower(ctx):
    ctx.agent.add_host("host", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("infer", {"tpu/chips": "2", "tpu/priority": "1"})
    ctx.run()
    assert ctx.node("infer") == "host"
    ctx.pod("train", {"tpu/chips": "2", "tpu/priority": "10"})
    ctx.run()
    assert ctx.get("infer") is None
    assert ctx.node("train") == "host"
    assert ctx.preempted == 1
    assert ctx.stack.scheduler.stats.preempt_nominations >= 1


def evicts_after_usage_visible(ctx):
    ctx.agent.add_host("host", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("infer", {"tpu/chips": "2", "tpu/priority": "1"})
    ctx.run()
    ctx.agent.publish_all()  # the victim's usage is now metrics-visible
    ctx.pod("train", {"tpu/chips": "2", "tpu/priority": "10"})
    ctx.run()
    assert ctx.get("infer") is None
    ctx.agent.publish_all()
    ctx.run()
    assert ctx.node("train") == "host"
    assert ctx.preempted == 1


def equal_priority_kept(ctx):
    ctx.agent.add_host("host", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("a", {"tpu/chips": "2", "tpu/priority": "5"})
    ctx.run()
    ctx.pod("b", {"tpu/chips": "2", "tpu/priority": "5"})
    ctx.run()
    assert ctx.node("a") == "host" and ctx.node("b") is None
    assert ctx.preempted == 0


def lowest_priority_victims(ctx):
    ctx.agent.add_host("host-a", generation="v5e", chips=2)
    ctx.agent.add_host("host-b", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("mid", {"tpu/chips": "2", "tpu/priority": "5"})
    ctx.run()
    ctx.pod("low", {"tpu/chips": "2", "tpu/priority": "1"})
    ctx.run()
    mid, low = ctx.node("mid"), ctx.node("low")
    assert {mid, low} == {"host-a", "host-b"}
    ctx.pod("train", {"tpu/chips": "2", "tpu/priority": "10"})
    ctx.run()
    assert ctx.get("low") is None and ctx.node("mid") == mid
    assert ctx.node("train") == low


def fewest_victims(ctx):
    ctx.agent.add_host("host-a", generation="v5e", chips=2)
    ctx.agent.add_host("host-b", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("big", {"tpu/chips": "2", "tpu/priority": "1"})
    ctx.run()
    big = ctx.node("big")
    for i in range(2):
        ctx.pod(f"small-{i}", {"tpu/chips": "1", "tpu/priority": "1"})
    ctx.run()
    ctx.pod("train", {"tpu/chips": "2", "tpu/priority": "10"})
    ctx.run()
    assert ctx.get("big") is None and len(ctx.bound("small")) == 2
    assert ctx.node("train") == big


def no_lower_priority(ctx):
    ctx.agent.add_host("host", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("top", {"tpu/chips": "2", "tpu/priority": "100"})
    ctx.run()
    ctx.pod("mid", {"tpu/chips": "2", "tpu/priority": "50"})
    ctx.run()
    assert ctx.node("top") == "host" and ctx.node("mid") is None
    assert ctx.preempted == 0


def wrong_generation(ctx):
    ctx.agent.add_host("v5e-host", generation="v5e", chips=4)
    ctx.agent.publish_all()
    ctx.pod("infer", {"tpu/chips": "4", "tpu/priority": "1"})
    ctx.run()
    ctx.pod("train", {"tpu/chips": "4", "tpu/priority": "10", "tpu/generation": "v5p"})
    ctx.run()
    assert ctx.node("infer") == "v5e-host" and ctx.node("train") is None
    assert ctx.preempted == 0


def gang_wrong_generation_capacity(ctx):
    ctx.agent.add_host("v5e-free", generation="v5e", chips=8)
    ctx.agent.add_host("v5p-host", generation="v5p", chips=4)
    ctx.agent.publish_all()
    ctx.pod("infer", {"tpu/chips": "4", "tpu/priority": "1", "tpu/generation": "v5p"})
    ctx.run()
    assert ctx.node("infer") == "v5p-host"
    ctx.gang("train", 1, 4, 10, **{"tpu/generation": "v5p"})
    ctx.run()
    assert ctx.get("infer") is None and ctx.node("train-0") == "v5p-host"


def disabled_never_evicts(ctx):
    ctx.agent.add_host("host", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("infer", {"tpu/chips": "2", "tpu/priority": "1"})
    ctx.run()
    ctx.pod("train", {"tpu/chips": "2", "tpu/priority": "10"})
    ctx.run()
    assert ctx.node("infer") == "host" and ctx.node("train") is None
    assert ctx.stack.preemption is None


def policy_never(ctx):
    ctx.agent.add_host("host", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("infer", {"tpu/chips": "2", "tpu/priority": "1"})
    ctx.run()
    ctx.pod("polite", {"tpu/chips": "2", "tpu/priority": "10"},
            preemption_policy="Never")
    ctx.run()
    assert ctx.get("infer") is not None and ctx.node("polite") is None
    assert ctx.preempted == 0


def eviction_refused(ctx):
    ctx.agent.add_host("host", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("guarded", {"tpu/chips": "2", "tpu/priority": "1"})
    ctx.run()
    ctx.stack.cluster.eviction_blocked.add("default/guarded")
    ctx.pod("train", {"tpu/chips": "2", "tpu/priority": "9"})
    ctx.run()
    # Every eviction refused: no nomination, the preemptor stays pending.
    assert ctx.node("guarded") == "host" and ctx.node("train") is None
    assert ctx.preempted == 0 and ctx.stack.scheduler.stats.preempt_nominations == 0


def refused_victim_routed_around(ctx):
    ctx.agent.add_host("host-a", generation="v5e", chips=2)
    ctx.agent.add_host("host-b", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("cheap", {"tpu/chips": "2", "tpu/priority": "1"})
    ctx.pod("pricey", {"tpu/chips": "2", "tpu/priority": "3"})
    ctx.run()
    ctx.stack.cluster.eviction_blocked.add("default/cheap")
    ctx.pod("train", {"tpu/chips": "2", "tpu/priority": "9"})
    ctx.run()
    # The cheapest set is refused; with no budget watch the plan keeps
    # choosing it, so the preemptor stays pending and nothing is evicted.
    assert ctx.get("cheap") is not None and ctx.get("pricey") is not None
    assert ctx.node("train") is None and ctx.preempted == 0


def port_holder_evicted(ctx):
    ctx.agent.add_host("host", generation="v5e", chips=4)
    ctx.agent.publish_all()
    ctx.pod("holder", {"tpu/chips": "1", "tpu/priority": "1"}, host_ports=PORTS)
    ctx.run()
    ctx.pod("train", {"tpu/chips": "1", "tpu/priority": "9"}, host_ports=PORTS)
    ctx.run()
    assert ctx.get("holder") is None and ctx.node("train") == "host"


def port_holder_higher_priority(ctx):
    ctx.agent.add_host("host", generation="v5e", chips=4)
    ctx.agent.publish_all()
    ctx.pod("holder", {"tpu/chips": "1", "tpu/priority": "9"}, host_ports=PORTS)
    ctx.run()
    ctx.pod("late", {"tpu/chips": "1", "tpu/priority": "5"}, host_ports=PORTS)
    ctx.run()
    assert ctx.node("holder") == "host" and ctx.node("late") is None
    assert ctx.preempted == 0


def port_cure_buys_chips(ctx):
    ctx.agent.add_host("host", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("holder", {"tpu/chips": "1", "tpu/priority": "2"}, host_ports=PORTS)
    ctx.pod("filler", {"tpu/chips": "1", "tpu/priority": "1"})
    ctx.run()
    ctx.pod("train", {"tpu/chips": "2", "tpu/priority": "9"}, host_ports=PORTS)
    ctx.run()
    assert ctx.node("train") == "host"
    assert ctx.get("holder") is None and ctx.get("filler") is None


def nomination_shown(ctx):
    ctx.agent.add_host("host", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("infer", {"tpu/chips": "2", "tpu/priority": "1"})
    ctx.run()
    ctx.pod("train", {"tpu/chips": "2", "tpu/priority": "10"})
    ctx.run()
    assert ctx.get("train").nominated_node_name == "host"


def stale_nomination_cleared(ctx):
    ctx.agent.add_host("host", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("train", {"tpu/chips": "2"})
    ctx.stack.cluster.set_nominated_node("default/train", "other-node")
    live = ctx.get("train")
    ctx.stack.scheduler._nominated[live.uid] = "other-node"
    ctx.run()
    assert ctx.node("train") == "host"
    assert ctx.get("train").nominated_node_name is None
    assert live.uid not in ctx.stack.scheduler._nominated


def permit_path_clears_stale_nomination(ctx):
    ctx.agent.add_host("host", generation="v5e", chips=2)
    ctx.agent.publish_all()
    ctx.pod("g-0", {"tpu/gang": "solo", "tpu/gang-size": "1", "tpu/chips": "1"})
    ctx.stack.cluster.set_nominated_node("default/g-0", "other-node")
    live = ctx.get("g-0")
    ctx.stack.scheduler._nominated[live.uid] = "other-node"
    ctx.run()
    assert ctx.node("g-0") == "host"
    assert ctx.get("g-0").nominated_node_name is None
    assert live.uid not in ctx.stack.scheduler._nominated


SINGLE = {
    "evicts-lower": evicts_lower,
    "after-usage-visible": evicts_after_usage_visible,
    "equal-priority": equal_priority_kept,
    "lowest-priority-victims": lowest_priority_victims,
    "fewest-victims": fewest_victims,
    "no-lower-priority": no_lower_priority,
    "wrong-generation": wrong_generation,
    "gang-wrong-generation": gang_wrong_generation_capacity,
    "policy-never": policy_never,
    "eviction-refused": eviction_refused,
    "refused-cheapest": refused_victim_routed_around,
    "port-holder-evicted": port_holder_evicted,
    "port-holder-higher": port_holder_higher_priority,
    "port-cure-buys-chips": port_cure_buys_chips,
    "nomination-shown": nomination_shown,
    "stale-nomination": stale_nomination_cleared,
    "permit-stale-nomination": permit_path_clears_stale_nomination,
}


@pytest.mark.parametrize("case", list(SINGLE), ids=list(SINGLE))
def test_scenario_equals_reference(case):
    both(SINGLE[case])


def test_disabled_preemption_equals_reference():
    both(disabled_never_evicts, enable_preemption=False)


# --- gangs ---


def plain_gang_clears_hosts(ctx):
    for h in range(3):
        ctx.agent.add_host(f"host-{h}", generation="v5e", chips=4)
    ctx.agent.publish_all()
    for i in range(12):
        ctx.pod(f"infer-{i}", {"tpu/chips": "1", "tpu/priority": "1"})
    ctx.run()
    assert len(ctx.bound("infer")) == 12
    ctx.gang("train", 2, 4, 10)
    ctx.run(10)
    trained = ctx.bound("train")
    assert len(trained) == 2 and len({ctx.node(n) for n in trained}) == 2
    assert ctx.preempted == 8 and len(ctx.bound("infer")) == 4


def topology_gang_block(ctx):
    ctx.agent.add_slice("v5p", generation="v5p", host_topology=(2, 2, 1))
    ctx.agent.add_host("v5e-spill", generation="v5e", chips=8)
    ctx.agent.publish_all()
    for i in range(4):
        ctx.pod(f"infer-{i}", {"tpu/chips": "4", "tpu/priority": "1",
                               "tpu/generation": "v5p"})
    ctx.run()
    assert len(ctx.bound("infer")) == 4
    for m in range(4):
        ctx.pod(f"train-{m}", {"tpu/gang": "slice-job", "tpu/topology": "2x2x1",
                               "tpu/chips": "4", "tpu/priority": "10"})
    ctx.run(10)
    hosts = {ctx.node(n) for n in ctx.bound("train")}
    assert len(hosts) == 4 and all(h.startswith("v5p-") for h in hosts)
    assert ctx.preempted == 4


def gang_timeout_then_recovers(ctx):
    ctx.agent.add_host("host-a", generation="v5e", chips=4)
    ctx.agent.add_host("host-b", generation="v5e", chips=4)
    ctx.agent.publish_all()
    ctx.pod("infer", {"tpu/chips": "4", "tpu/priority": "1"})
    ctx.run()
    ctx.pod("train-0", {"tpu/gang": "job", "tpu/gang-size": "2", "tpu/chips": "4",
                        "tpu/priority": "10"})
    # The lone member reserves the free host and waits at Permit for a
    # sibling that has not arrived: its window expires, nothing stays held.
    ctx.run(0.5)
    assert ctx.stack.framework.waiting_pods()
    ctx.clock.now += 1.0
    ctx.stack.framework.expire_waiting(now=ctx.clock())
    assert not ctx.stack.framework.waiting_pods()
    ctx.pod("train-1", {"tpu/gang": "job", "tpu/gang-size": "2", "tpu/chips": "4",
                        "tpu/priority": "10"})
    ctx.run(2)
    assert len(ctx.bound("train")) == 2 and ctx.get("infer") is None


def gang_evicts_minimally(ctx):
    for i in range(2):
        ctx.agent.add_host(f"host-{i}", chips=8)
    ctx.agent.publish_all()
    for i in range(10):
        ctx.pod(f"inf-{i}", {"tpu/chips": "1", "tpu/priority": "1"})
    ctx.run()
    ctx.agent.publish_all()  # metrics reflect the inference usage
    ctx.gang("train", 2, 4, 9)
    ctx.run(10)
    assert len(ctx.bound("train")) == 2
    assert ctx.preempted == 2, "one eviction per host, no cascade"


def config5(ctx, gangs: int):
    """BASELINE config 5: a v5e-64 pool (8 hosts x 8 chips) saturated by 32
    inference pods of 2 chips; ``gangs`` training gangs of 4 x 8 chips
    arrive at higher priority and displace them."""
    for h in range(8):
        ctx.agent.add_host(f"v5e-{h}", generation="v5e", chips=8)
    ctx.agent.publish_all()
    for i in range(32):
        ctx.pod(f"infer-{i}", {"tpu/chips": "2", "tpu/priority": "1"})
    ctx.run(10)
    assert len(ctx.bound("infer")) == 32
    for g in range(gangs):
        ctx.gang(f"train{g}", 4, 8, 100)
    ctx.run(30)
    for g in range(gangs):
        members = ctx.bound(f"train{g}")
        assert len(members) == 4 and len({ctx.node(n) for n in members}) == 4
    assert ctx.preempted == 16 * gangs
    assert len(ctx.bound("infer")) == 32 - 16 * gangs


GANGS = {
    "plain-clears-hosts": plain_gang_clears_hosts,
    "topology-block": topology_gang_block,
    "evicts-minimally": gang_evicts_minimally,
    "config5-full": lambda ctx: config5(ctx, 2),
    "config5-partial": lambda ctx: config5(ctx, 1),
}


@pytest.mark.parametrize("case", list(GANGS), ids=list(GANGS))
def test_gang_scenario_equals_reference(case):
    both(GANGS[case])


RESIDENT_COUNTERS = (
    "restacks", "sets_retained", "burst_served", "burst_invalidated",
    "gang_burst_served", "gang_burst_invalidated", "admission_reuse",
    "admission_patched", "admission_rebuilds", "dispatch_count", "joint_dispatches",
)


def test_evictions_reach_the_resident_state_as_in_reference():
    """Config 5 with the agent republishing every host between waves: the
    victims' deletions reach the accountant's delta feed, the informer's
    admission feed and the cached sets, and the retries see the freed chips
    without a re-stack — with the reference's counters — and afterwards
    the resident tensors equal a cold lowering of the final snapshot."""
    from yoda_tpu_torch.ops.arrays import FleetArrays
    from yoda_tpu_torch.ops.kernel import stack_static

    def script(ctx):
        config5(ctx, 2)
        ctx.agent.publish_all()
        ctx.pod("late", {"tpu/chips": "2", "tpu/priority": "1"})
        ctx.run()

    sides = {}
    for side in ("ref", "port"):
        ctx = Ctx(side, batch_requests=8)
        script(ctx)
        (yb,) = ctx.stack.framework.batch_plugins
        sides[side] = (ctx, yb, {c: getattr(yb, c) for c in RESIDENT_COUNTERS} | {
            "delta_syncs": yb._resident.delta_syncs,
            "rows_applied": yb._resident.rows_applied,
        })
    (ref, _, want), (port, yb, got) = sides["ref"], sides["port"]
    assert port.observe() == ref.observe()
    assert got == want
    assert got["restacks"] == 1 and port.preempted == 32
    snap = port.stack.informer.snapshot()
    yb._refresh_static(snap)
    chips, nodes = stack_static(FleetArrays.from_snapshot(snap))
    assert np.array_equal(yb._kern._chips.numpy(), chips)
    assert np.array_equal(yb._kern._nodes.numpy(), nodes)


def test_gang_timeout_then_recovery_equals_reference():
    both(gang_timeout_then_recovers, fake_clock=True, gang_permit_timeout_s=0.2)


# --- units ---


def test_malformed_label_victim_ranking():
    """A parseable tpu/priority still ranks a victim whose other labels are
    malformed, on both plugins."""
    got = []
    for types, plugin in ((ref_types, RefPreemption), (port_types, TpuPreemption)):
        pod = types.PodSpec(
            "foreign", labels={"tpu/priority": "100", "tpu/hbm": "8 Gi"},
            scheduler_name="default-scheduler", node_name="h1", tpu_resource_limit=4,
        )
        v = plugin(lambda key: True)._victim_of(pod, "h1")
        got.append((v.priority, v.chips, v.node))
    assert got[0] == got[1] == (100, 4, "h1")


def four_chip_node(types, hbm_total=16 * GIB):
    return types.TpuNodeMetrics(
        name="host", generation="v5e",
        chips=[types.TpuChip(index=i, hbm_free=hbm_total, hbm_total=hbm_total,
                             clock_mhz=940, hbm_bandwidth_gbps=819, tflops_bf16=197,
                             power_w=170) for i in range(4)],
    )


def visible_victim_invisible_bystander(tpu):
    for c in tpu.chips[:2]:  # the victim's usage, already visible
        c.hbm_free = c.hbm_total // 2
    return 4, {"tpu/chips": "4", "tpu/priority": "10"}, [(2, 2)]


def steady_state_visible(tpu):
    for c in tpu.chips:
        c.hbm_free = 0
    return 4, {"tpu/chips": "4", "tpu/priority": "10"}, [(4, 4)]


def just_bound_invisible(tpu):
    return 4, {"tpu/chips": "4", "tpu/priority": "10"}, [(4, 4), (2, 2)]


def unqualifiable_visible(tpu):
    for c in tpu.chips[:2]:  # small chips, in use
        c.hbm_total = GIB
        c.hbm_free = 0
    return 2, {"tpu/chips": "2", "tpu/hbm": "8Gi", "tpu/priority": "10"}, [(2, 2)]


AVAIL_CASES = {
    "visible-victim-invisible-bystander": visible_victim_invisible_bystander,
    "steady-state-visible": steady_state_visible,
    "just-bound-invisible": just_bound_invisible,
    "unqualifiable-visible": unqualifiable_visible,
}


@pytest.mark.parametrize("case", list(AVAIL_CASES), ids=list(AVAIL_CASES))
def test_avail_after_model(case):
    """The eviction capacity model (tests/test_preemption.py
    TestAvailAfterModel): each occupied chip is charged exactly once, and
    eviction credits one claimable chip per freed chip — on both plugins,
    with and without an accounting source."""
    sides = (
        (ref_types, RefPreemption, RefNodeInfo, ref_parse_request),
        (port_types, TpuPreemption, NodeInfo, parse_request),
    )
    results = []
    for types, plugin_cls, node_info, parse in sides:
        tpu = four_chip_node(types)
        reserved, labels, want = AVAIL_CASES[case](tpu)
        req = parse(labels)
        ni = node_info("host", tpu=tpu)
        with_acct = plugin_cls(lambda key: None, reserved_fn=lambda n, r=reserved: r)
        metrics_only = plugin_cls(lambda key: None)
        row = []
        for freed, expected in want:
            assert with_acct._avail_after(ni, req, freed) == expected
            row.append((freed, with_acct._avail_after(ni, req, freed)))
        # The branch without accounting (metrics-only worst case).
        row += [(f, metrics_only._avail_after(ni, req, f)) for f in range(5)]
        results.append(row)
    assert results[0] == results[1]


# --- the seeded mixed fleet with preemption on ---


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("batch_requests", [1, 8])
@pytest.mark.parametrize("strategy", ["least-allocated", "most-allocated"])
def test_fleet_script_equals_reference(seed, batch_requests, strategy):
    """tests/test_torch_stack.py's seeded fleet and singleton script (pods
    of priority 0-2, some unschedulable), preemption on in both packages."""
    hosts, pods = fleet_script(seed=seed)
    knobs = dict(batch_requests=batch_requests, scoring_strategy=strategy)
    ref = ref_build_stack(config=RefConfig(kernel_platform="cpu", **knobs))
    want = run_script(ref_types, ref, hosts, pods)
    port = build_stack(config=SchedulerConfig(kernel_platform="cpu", **knobs))
    got = run_script(port_types, port, hosts, pods)
    assert got == want
    assert port.preemption.preempted_total == ref.preemption.preempted_total
    assert (port.scheduler.stats.preempt_nominations
            == ref.scheduler.stats.preempt_nominations)
    nominated = {p.name: p.nominated_node_name for p in port.cluster.list_pods()}
    assert nominated == {p.name: p.nominated_node_name for p in ref.cluster.list_pods()}
    for h in hosts:
        healthy = sum(c["health"] == "Healthy" for c in h["chips"])
        assert port.accountant.chips_in_use(h["name"]) <= healthy
