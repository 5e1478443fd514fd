"""The port's node health monitor (yoda_tpu_torch/nodehealth: the health
ladder, fencing through the snapshot's fence set, ghost release, gang-whole
repair and drains), the bind executor its unbinds fan out on, and the fence
vetoes of the gang plugin, held against the JAX package on the CPU,
tolerance 0.

Every test of tests/test_node_health.py has a counterpart here that runs
one script on both packages' ``build_stack`` (``kernel_platform: cpu``,
preemption off, ``bind_workers`` 0 so every unbind runs inline and in
order, a fake wall clock shared by the agent and the monitor, and a fake
scheduling clock): node states after every monitor pass, fence sets,
``RepairReport`` lists (less their wall times), bindings, reservations and
Permit waiters must be equal, and each test's own assertions hold on both.
The reference's metric and trace assertions have no counterpart (the port
has no registry); the binds count comes from the scheduler's stats. The
wire-format round trip of a NotReady Node becomes the same condition
carried through the informer's snapshot (the port has no wire format), and
the chaos plan of the seeded sweep becomes a numpy-seeded fault script
applied to both packages alike. ``TestDownDuringBindFanout`` (a host
killed while a gang's binds are in flight on the pipeline, ``bind_pipeline:
on``) is timing-dependent by design, so it runs from the reference's own
source on both packages (``torch_refcases.run_case``) with its own
whole-or-nothing assertions instead of a compared script.

Also here: a pure fence flip moves neither the resident fleet's re-stacks
nor its row updates and patches exactly the flipped admission rows; a
default-config stack (``bind_workers`` 8: unbinds fan out on executor
threads, so requeue order is thread-dependent in both packages) agrees
with the reference on everything no order can change; the repair deferral
in both orders against the gang plugin's own host-death cascade; and
chip_smoke.py's run (i) at its small size.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.requests as ref_requests
import yoda_tpu.api.types as ref_types
import yoda_tpu.config as ref_config
import yoda_tpu.nodehealth as ref_nodehealth
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent.fake_publisher as port_agent
import yoda_tpu_torch.api.requests as port_requests
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.nodehealth as port_nodehealth
import yoda_tpu_torch.standalone as port_standalone
from chip_smoke import NODEHEALTH_SMALL, check_nodehealth_run, run_nodehealth
from torch_refcases import PACKAGES, run_case
from yoda_tpu_torch.framework.runtime import BindExecutor

REF = SimpleNamespace(
    name="ref", types=ref_types, requests=ref_requests,
    Agent=ref_agent.FakeTpuAgent, Config=ref_config.SchedulerConfig,
    build_stack=ref_standalone.build_stack, NodeState=ref_nodehealth.NodeState,
)
PORT = SimpleNamespace(
    name="port", types=port_types, requests=port_requests,
    Agent=port_agent.FakeTpuAgent, Config=port_config.SchedulerConfig,
    build_stack=port_standalone.build_stack, NodeState=port_nodehealth.NodeState,
)


class FakeClock:
    """A clock advanced by hand: the wall clock of the agents' publish
    stamps (the monitor's ``now_fn``), or the stack's scheduling clock."""

    def __init__(self, t: float) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def both(case, *args):
    """Runs ``case(side, *args)`` on the reference and on the port; their
    observations must be equal. Returns the port's."""
    want = case(REF, *args)
    got = case(PORT, *args)
    assert got == want
    return got


def make_stack(side, cluster=None, **cfg):
    """A stack on ``side`` with the reference tests' thresholds (suspect
    10 s, down 30 s), its agent, the shared fake wall clock and the fake
    scheduling clock."""
    cfg.setdefault("kernel_platform", "cpu")
    cfg.setdefault("enable_preemption", False)
    cfg.setdefault("node_suspect_after_s", 10.0)
    cfg.setdefault("node_down_after_s", 30.0)
    cfg.setdefault("bind_workers", 0)
    clock = FakeClock(1000.0)
    now = FakeClock(1_000_000.0)
    stack = side.build_stack(cluster=cluster, config=side.Config(**cfg), clock=clock)
    stack.nodehealth.now_fn = now
    return stack, side.Agent(stack.cluster, now_fn=now), now, clock


def pod(side, name, **labels):
    return side.types.PodSpec(name, labels=dict(labels))


def plain_gang(side, tag, n, chips=4, extra=None):
    labels = {"tpu/gang": tag, "tpu/gang-size": str(n), "tpu/chips": str(chips)}
    labels.update(extra or {})
    return [side.types.PodSpec(f"{tag}-{i}", labels=dict(labels)) for i in range(n)]


def topo_gang(side, tag, shape, chips=4):
    size = 1
    for d in shape.split("x"):
        size *= int(d)
    labels = {"tpu/gang": tag, "tpu/topology": shape, "tpu/chips": str(chips)}
    return [side.types.PodSpec(f"{tag}-{i}", labels=dict(labels)) for i in range(size)]


def create(stack, pods, run_s=5.0):
    for p in pods:
        stack.cluster.create_pod(p)
    stack.scheduler.run_until_idle(max_wall_s=run_s)


def bound_map(stack) -> dict:
    return {p.name: p.node_name for p in stack.cluster.list_pods() if p.node_name}


def report_view(report) -> dict:
    """A RepairReport's fields, its wall times reduced to their keys."""
    out = dataclasses.asdict(report)
    out["durations_ms"] = sorted(out["durations_ms"])
    return out


def view(stack) -> dict:
    """Everything a monitor pass or a drain may change."""
    return dict(
        bound=bound_map(stack),
        states={n: s.value for n, s in sorted(stack.nodehealth.states().items())},
        fenced=sorted(stack.nodehealth.fenced_nodes()),
        reserved={n: c for n, c in sorted(stack.accountant.chips_by_node().items()) if c},
        waiting=sorted(w.pod.key for w in stack.framework.waiting_pods()),
        binds=stack.scheduler.stats.binds,
        pods=len(stack.cluster.list_pods()),
    )


def pass_view(stack) -> dict:
    """One monitor pass: its report and the state it leaves."""
    return dict(report=report_view(stack.nodehealth.run_once()), **view(stack))


def assert_no_oversubscription(side, stack):
    caps = {t.name: len(t.chips) for t in stack.cluster.list_tpu_metrics()}
    used: dict = {}
    for p in stack.cluster.list_pods():
        if not p.node_name:
            continue
        try:
            chips = side.requests.pod_request(p).effective_chips
        except side.requests.LabelParseError:
            chips = 0
        used[p.node_name] = used.get(p.node_name, 0) + chips
    for host, n in used.items():
        assert n <= caps.get(host, 0), f"{host}: {n}/{caps.get(host, 0)}"
    for host, cap in caps.items():
        assert stack.accountant.chips_in_use(host) <= cap


def assert_no_split_gangs(side, stack):
    by_gang: dict = {}
    for p in stack.cluster.list_pods():
        g = side.requests.gang_name_of(p.labels)
        if g:
            by_gang.setdefault(g, []).append(p)
    for g, members in by_gang.items():
        spec = next(
            (side.requests.pod_request(p).gang for p in members
             if side.requests.pod_request(p).gang is not None),
            None,
        )
        if spec is None:
            continue
        bound = sum(1 for p in members if p.node_name)
        floor = spec.floor if spec.elastic else spec.size
        ceiling = spec.ceiling if spec.elastic else spec.size
        assert bound == 0 or floor <= bound <= ceiling, (g, bound, floor, ceiling)


class TestLadder:
    def test_flapping_heartbeat_debounces_no_repair(self):
        def case(side):
            stack, agent, now, _ = make_stack(side)
            agent.add_host("h0", generation="v5e", chips=8)
            agent.add_host("h1", generation="v5e", chips=8)
            agent.publish_all()
            create(stack, [pod(side, "p0", **{"tpu/chips": "2"})])
            victim = bound_map(stack)["p0"]
            spared = "h1" if victim == "h0" else "h0"
            agent.stop_heartbeat(victim)
            trace = []
            now.advance(5.0)
            agent.publish_all()
            trace.append(pass_view(stack))
            assert stack.nodehealth.state_of(victim) is side.NodeState.HEALTHY
            now.advance(10.0)
            agent.publish_all()
            trace.append(pass_view(stack))
            assert stack.nodehealth.state_of(victim) is side.NodeState.SUSPECT
            assert victim in stack.nodehealth.fenced_nodes()
            create(stack, [pod(side, "p1", **{"tpu/chips": "2"})])
            assert bound_map(stack)["p1"] == spared
            agent.resume_heartbeat(victim)
            trace.append(pass_view(stack))
            assert stack.nodehealth.state_of(victim) is side.NodeState.HEALTHY
            assert bound_map(stack)["p0"] == victim
            assert all(t["report"]["patched"] == t["report"]["singles"] == [] for t in trace)
            return trace

        both(case)

    def test_continuous_silence_is_down_and_repairs_singleton(self):
        def case(side):
            stack, agent, now, _ = make_stack(side)
            agent.add_host("h0", generation="v5e", chips=8)
            agent.add_host("h1", generation="v5e", chips=8)
            agent.publish_all()
            create(stack, [pod(side, "p0", **{"tpu/chips": "2"})])
            victim = bound_map(stack)["p0"]
            spared = "h1" if victim == "h0" else "h0"
            agent.stop_heartbeat(victim)
            now.advance(15.0)
            agent.publish_all()
            now.advance(16.0)
            agent.publish_all()
            trace = [pass_view(stack)]
            assert stack.nodehealth.state_of(victim) is side.NodeState.DOWN
            assert stack.nodehealth.state_of(spared) is side.NodeState.HEALTHY
            assert trace[0]["report"]["singles"] == ["default/p0"]
            stack.scheduler.run_until_idle(max_wall_s=5)
            assert bound_map(stack)["p0"] == spared
            assert_no_oversubscription(side, stack)
            return trace + [view(stack)]

        both(case)

    def test_chip_degrade_is_observational_not_fenced(self):
        def case(side):
            stack, agent, _, _ = make_stack(side)
            agent.add_host("h0", generation="v5e", chips=8)
            agent.publish_all()
            agent.fail_chips("h0", [0, 1])
            trace = [view(stack)]
            assert stack.nodehealth.state_of("h0") is side.NodeState.DEGRADED
            assert "h0" not in stack.nodehealth.fenced_nodes()
            create(stack, [pod(side, "p", **{"tpu/chips": "2"})])
            assert bound_map(stack)["p"] == "h0"
            agent.heal_chips("h0", [0, 1])
            assert stack.nodehealth.state_of("h0") is side.NodeState.HEALTHY
            return trace + [view(stack)]

        both(case)

    def test_not_ready_is_down_at_event_time_and_recovers(self):
        def case(side):
            stack, agent, _, _ = make_stack(side)
            agent.add_host("h0", generation="v5e", chips=8)
            agent.publish_all()
            stack.cluster.set_node_ready("h0", False)
            trace = [view(stack)]
            assert stack.nodehealth.state_of("h0") is side.NodeState.DOWN
            assert "h0" in stack.nodehealth.fenced_nodes()
            stack.cluster.set_node_ready("h0", True)
            agent.refresh("h0")
            trace.append(pass_view(stack))
            assert stack.nodehealth.state_of("h0") is side.NodeState.HEALTHY
            return trace

        both(case)

    def test_deletion_is_down_and_readd_recovers(self):
        def case(side):
            stack, agent, _, _ = make_stack(side)
            agent.add_host("h0", generation="v5e", chips=8)
            agent.publish_all()
            stack.cluster.delete_tpu_metrics("h0")
            trace = [view(stack)]
            assert stack.nodehealth.state_of("h0") is side.NodeState.DOWN
            agent.refresh("h0")
            trace.append(pass_view(stack))
            assert stack.nodehealth.state_of("h0") is side.NodeState.HEALTHY
            return trace

        both(case)


class TestGhostRelease:
    def test_deleted_node_releases_bound_claims_at_event_time(self):
        def case(side):
            stack, agent, _, _ = make_stack(side)
            agent.add_host("h0", generation="v5e", chips=8)
            agent.publish_all()
            create(stack, [pod(side, "p", **{"tpu/chips": "3"})])
            uid = stack.cluster.list_pods()[0].uid
            assert stack.accountant.has_claim(uid)
            stack.cluster.kill_node("h0")
            assert not stack.accountant.has_claim(uid)
            assert stack.accountant.chips_in_use("h0") == 0
            return view(stack)

        both(case)


class TestGangRepair:
    def test_topology_patch_keeps_healthy_members_bound(self):
        def case(side):
            stack, agent, _, _ = make_stack(side)
            agent.add_slice("s", generation="v5p", host_topology=(4, 1, 1))
            agent.publish_all()
            create(stack, topo_gang(side, "g", "2"), run_s=10)
            bound = bound_map(stack)
            assert sorted(bound.values()) == ["s-0", "s-1"]
            binds_before = stack.scheduler.stats.binds
            survivor_pod = next(n for n, h in bound.items() if h == "s-1")
            stack.cluster.kill_node("s-0")
            trace = [pass_view(stack)]
            assert trace[0]["report"]["patched"] == ["g"]
            assert trace[0]["report"]["requeued"] == []
            stack.scheduler.run_until_idle(max_wall_s=10)
            after = bound_map(stack)
            assert after[survivor_pod] == "s-1"
            assert set(after.values()) == {"s-1", "s-2"}
            assert stack.scheduler.stats.binds == binds_before + 1
            assert len(stack.cluster.list_pods()) == 2
            assert_no_oversubscription(side, stack)
            assert_no_split_gangs(side, stack)
            return trace + [view(stack)]

        both(case)

    def test_plain_gang_patch_requeues_only_lost_member(self):
        def case(side):
            stack, agent, _, _ = make_stack(side)
            for h in ("h0", "h1", "h2"):
                agent.add_host(h, generation="v5e", chips=4)
            agent.publish_all()
            create(stack, plain_gang(side, "g", 2, chips=4), run_s=10)
            bound = bound_map(stack)
            victim_host = bound["g-0"]
            survivor, survivor_host = next((n, h) for n, h in bound.items() if n != "g-0")
            stack.cluster.kill_node(victim_host)
            trace = [pass_view(stack)]
            assert trace[0]["report"]["patched"] == ["g"]
            stack.scheduler.run_until_idle(max_wall_s=10)
            after = bound_map(stack)
            assert after[survivor] == survivor_host
            assert after["g-0"] not in (victim_host, None)
            assert_no_split_gangs(side, stack)
            return trace + [view(stack)]

        both(case)

    def test_fallback_whole_requeue_when_no_replacement_capacity(self):
        def case(side):
            stack, agent, _, _ = make_stack(side)
            agent.add_host("h0", generation="v5e", chips=4)
            agent.add_host("h1", generation="v5e", chips=4)
            agent.publish_all()
            create(stack, plain_gang(side, "g", 2, chips=4), run_s=10)
            assert len(bound_map(stack)) == 2
            agent.remove_host("h1")
            stack.cluster.delete_node("h1")
            trace = [pass_view(stack)]
            assert trace[0]["report"]["requeued"] == ["g"]
            assert trace[0]["report"]["patched"] == []
            assert bound_map(stack) == {}
            assert len(stack.cluster.list_pods()) == 2
            agent.add_host("h2", generation="v5e", chips=4)
            agent.publish_all()
            stack.scheduler.run_until_idle(max_wall_s=10)
            assert sorted(bound_map(stack).values()) == ["h0", "h2"]
            assert_no_oversubscription(side, stack)
            assert_no_split_gangs(side, stack)
            return trace + [view(stack)]

        both(case)

    def test_elastic_gang_shrinks_toward_floor_instead_of_requeue(self):
        def case(side):
            stack, agent, _, _ = make_stack(side)
            for h in ("h0", "h1", "h2"):
                agent.add_host(h, generation="v5e", chips=4)
            agent.publish_all()
            create(stack, plain_gang(
                side, "e", 3, chips=4,
                extra={"tpu/min-members": "2", "tpu/max-members": "3"},
            ), run_s=10)
            assert len(bound_map(stack)) == 3
            victim_host = bound_map(stack)["e-2"]
            stack.cluster.kill_node(victim_host)
            trace = [pass_view(stack)]
            assert trace[0]["report"]["shrunk"] == ["e"]
            assert trace[0]["report"]["requeued"] == []
            assert stack.gang.effective_size("e") == 2
            survivors = bound_map(stack)
            assert len(survivors) == 2 and victim_host not in survivors.values()
            assert_no_split_gangs(side, stack)
            return trace + [stack.gang.effective_size("e")]

        both(case)

    def test_repair_defers_while_members_wait_at_permit(self):
        def case(side):
            stack, agent, _, _ = make_stack(side)
            agent.add_host("h0", generation="v5e", chips=4)
            agent.add_host("h1", generation="v5e", chips=4)
            agent.publish_all()
            pods = plain_gang(side, "g", 3, chips=2)
            pods[0].node_name = "h0"
            pods[0].phase = "Running"
            stack.cluster.create_pod(pods[0])
            create(stack, [pods[1]], run_s=0.2)
            assert stack.gang.gang_status("g")[1] >= 1
            stack.cluster.set_node_ready("h0", False)
            trace = [pass_view(stack)]
            assert trace[0]["report"]["deferred"] == ["g"]
            assert trace[0]["report"]["patched"] == trace[0]["report"]["requeued"] == []
            return trace

        both(case)

    @pytest.mark.parametrize("order", ["monitor_first", "cascade_first"])
    def test_deferral_and_the_gang_cascade_in_both_orders(self, order):
        """A host dies under a gang with members bound and waiting at
        Permit. monitor_first: the pass defers while a member waits, then
        the gang plugin's host-death cascade (the host's CR deleted)
        rejects the waiter and the next pass repairs the bound member;
        cascade_first: the cascade runs before any pass, so the first pass
        finds nothing waiting and repairs at once. Either way the gang
        ends whole or unbound, never split."""

        def case(side):
            stack, agent, _, _ = make_stack(side)
            for h in ("h0", "h1", "h2"):
                agent.add_host(h, generation="v5e", chips=4)
            agent.publish_all()
            pods = plain_gang(side, "g", 3, chips=4)
            pods[0].node_name = "h0"
            pods[0].phase = "Running"
            stack.cluster.create_pod(pods[0])
            create(stack, [pods[1]], run_s=0.2)
            waiter = [w.pod.name for w in stack.framework.waiting_pods()]
            assert waiter == ["g-1"]
            trace = []
            if order == "monitor_first":
                stack.cluster.set_node_ready("h0", False)
                trace.append(pass_view(stack))
                assert trace[-1]["report"]["deferred"] == ["g"]
                stack.cluster.kill_node("h0")
            else:
                stack.cluster.kill_node("h0")
            assert not stack.framework.waiting_pods()
            trace.append(pass_view(stack))
            assert trace[-1]["report"]["deferred"] == []
            create(stack, [pods[2]], run_s=0.2)
            trace.append(pass_view(stack))
            stack.scheduler.run_until_idle(max_wall_s=0.2)
            assert "h0" not in bound_map(stack).values()
            assert_no_oversubscription(side, stack)
            return trace + [view(stack)]

        both(case)


class TestDrain:
    def test_drain_fences_and_rebalancer_migrates_gang_off(self):
        def case(side):
            stack, agent, _, _ = make_stack(side)
            agent.add_slice("s", generation="v5p", host_topology=(4, 1, 1))
            agent.publish_all()
            create(stack, topo_gang(side, "g", "2"), run_s=10)
            assert sorted(bound_map(stack).values()) == ["s-0", "s-1"]
            stack.nodehealth.drain("s-0")
            assert stack.nodehealth.state_of("s-0") is side.NodeState.DRAINING
            assert "s-0" in stack.nodehealth.fenced_nodes()
            report = stack.rebalancer.run_once()
            assert report.drained == ["g"]
            stack.scheduler.run_until_idle(max_wall_s=10)
            after = bound_map(stack)
            assert "s-0" not in after.values()
            assert len(after) == 2
            assert_no_split_gangs(side, stack)
            assert_no_oversubscription(side, stack)
            create(stack, [pod(side, "p", **{"tpu/chips": "1"})])
            assert bound_map(stack)["p"] != "s-0"
            return [report.drained, report.moves, view(stack)]

        both(case)

    def test_drain_deadline_force_evacuates(self):
        def case(side):
            stack, agent, _, _ = make_stack(side)
            agent.add_host("h0", generation="v5e", chips=4)
            agent.add_host("h1", generation="v5e", chips=4)
            agent.publish_all()
            create(stack, [pod(side, "p", **{"tpu/chips": "2"})])
            host = bound_map(stack)["p"]
            stack.nodehealth.drain(host, deadline_s=0.0)
            trace = [pass_view(stack)]
            assert trace[0]["report"]["singles"] == ["default/p"]
            stack.scheduler.run_until_idle(max_wall_s=5)
            assert bound_map(stack)["p"] != host
            return trace + [view(stack)]

        both(case)

    def test_cancel_drain_reopens_the_node(self):
        def case(side):
            stack, agent, _, _ = make_stack(side)
            agent.add_host("h0", generation="v5e", chips=4)
            agent.publish_all()
            stack.nodehealth.drain("h0")
            assert "h0" in stack.nodehealth.fenced_nodes()
            stack.nodehealth.cancel_drain("h0")
            assert "h0" not in stack.nodehealth.fenced_nodes()
            create(stack, [pod(side, "p", **{"tpu/chips": "1"})])
            assert bound_map(stack)["p"] == "h0"
            return view(stack)

        both(case)

    def test_drain_deadline_reads_the_stack_clock(self):
        """The drain window runs on the stack's scheduling clock, not the
        agents' wall clock: advancing the wall clock alone never
        force-evacuates, advancing the scheduling clock past the window
        does."""

        def case(side):
            stack, agent, now, clock = make_stack(side)
            agent.add_host("h0", generation="v5e", chips=4)
            agent.add_host("h1", generation="v5e", chips=4)
            agent.publish_all()
            create(stack, [pod(side, "p", **{"tpu/chips": "2"})])
            host = bound_map(stack)["p"]
            stack.nodehealth.drain(host, deadline_s=60.0)
            now.advance(5.0)
            agent.publish_all()
            trace = [pass_view(stack)]
            assert trace[0]["report"]["singles"] == []
            clock.advance(61.0)
            trace.append(pass_view(stack))
            assert trace[1]["report"]["singles"] == ["default/p"]
            return trace

        both(case)


class TestFenceVetoes:
    """The gang plugin's fence vetoes: a fenced host counts toward no plain
    gang's slots and enters no topology plan, and the fence opening
    reactivates the parked gang."""

    @pytest.mark.parametrize("kind", ["plain", "topology"])
    def test_gangs_avoid_fenced_hosts(self, kind):
        def case(side):
            stack, agent, now, _ = make_stack(side)
            agent.add_slice("s", generation="v5p", host_topology=(3, 1, 1))
            agent.publish_all()
            agent.stop_heartbeat("s-0")
            now.advance(12.0)
            agent.publish_all()
            trace = [pass_view(stack)]
            assert stack.nodehealth.fenced_nodes() == frozenset({"s-0"})
            pods = (plain_gang(side, "g", 3, chips=4) if kind == "plain"
                    else topo_gang(side, "g", "3"))
            create(stack, pods, run_s=0.2)
            trace.append(view(stack))
            assert "s-0" not in bound_map(stack).values()
            assert bound_map(stack) == {}  # 2 unfenced hosts for 3 members
            # A timestamp-only republish reaches no watcher batch: the
            # recovery is the next pass's tick, which opens the fence and
            # reactivates the parked gang.
            agent.resume_heartbeat("s-0")
            trace.append(pass_view(stack))
            assert not stack.nodehealth.fenced_nodes()
            stack.scheduler.run_until_idle(max_wall_s=10)
            trace.append(view(stack))
            assert sorted(bound_map(stack).values()) == ["s-0", "s-1", "s-2"]
            return trace

        both(case)

    def test_topology_plan_steers_around_a_fenced_host(self):
        def case(side):
            stack, agent, _, _ = make_stack(side)
            agent.add_slice("s", generation="v5p", host_topology=(4, 1, 1))
            agent.publish_all()
            stack.nodehealth.drain("s-1")
            create(stack, topo_gang(side, "g", "2"), run_s=10)
            assert sorted(bound_map(stack).values()) == ["s-2", "s-3"]
            return view(stack)

        both(case)


class TestFakeHelpers:
    def test_stop_heartbeat_freezes_last_updated(self):
        def case(side):
            stack, agent, now, _ = make_stack(side)
            agent.add_host("h0", generation="v5e", chips=4)
            agent.publish_all()
            t0 = stack.informer.last_updated_map()["h0"]
            agent.stop_heartbeat("h0")
            now.advance(100.0)
            agent.publish_all()
            assert stack.informer.last_updated_map()["h0"] == t0
            agent.resume_heartbeat("h0")
            assert stack.informer.last_updated_map()["h0"] == t0 + 100.0
            return t0

        both(case)

    def test_node_ready_reaches_the_snapshot(self):
        """The reference round-trips a NotReady Node through its wire
        format; the port has none, so the condition is followed through
        the informer instead: set_node_ready stores it, the snapshot's
        NodeInfo carries it, and it flips back."""

        def case(side):
            stack, agent, _, _ = make_stack(side)
            agent.add_host("n", generation="v5e", chips=4)
            agent.publish_all()
            stack.cluster.set_node_ready("n", False)
            seen = [stack.informer.snapshot().get("n").node.ready]
            stack.cluster.set_node_ready("n", True)
            seen.append(stack.informer.snapshot().get("n").node.ready)
            assert seen == [False, True]
            assert [n.ready for n in stack.cluster.list_nodes()] == [True]
            return seen

        both(case)

    def test_remove_host_forgets_a_stopped_heartbeat(self):
        def case(side):
            stack, agent, now, _ = make_stack(side)
            agent.add_host("a", generation="v5e", chips=4)
            agent.publish_all()
            agent.stop_heartbeat("a")
            agent.remove_host("a")
            agent.add_host("a", generation="v5e", chips=4)
            now.advance(7.0)
            agent.publish_all()
            assert stack.informer.last_updated_map()["a"] == 1_000_007.0
            return sorted(stack.informer.last_updated_map().items())

        both(case)


def fault_script(seed: int, rounds: int = 8, rate: float = 0.6):
    """A seeded node-fault script for the sweep, the same for both
    packages: per round, per op (node_death, heartbeat_stop,
    chip_degrade), whether it fires and its kind. Round r strikes
    ``sorted(live hosts)[r % len]``, as the reference's chaos plan does
    with invocation indices."""
    rng = np.random.default_rng(seed)
    kinds = {"node_death": ("death",), "heartbeat_stop": ("stop", "flap"),
             "chip_degrade": ("degrade",)}
    return [
        {op: str(rng.choice(kinds[op])) for op in kinds if rng.random() < rate}
        for _ in range(rounds)
    ]


def apply_faults(agent, cluster, faults: dict, r: int) -> list:
    fired = []
    for op in ("node_death", "heartbeat_stop", "chip_degrade"):
        if op not in faults:
            continue
        targets = sorted(agent._hosts)
        if not targets:
            continue
        name = targets[r % len(targets)]
        if op == "node_death":
            agent.remove_host(name)
            cluster.delete_node(name)
        elif op == "heartbeat_stop":
            agent.stop_heartbeat(name)
        else:
            agent.fail_chips(name, [0])
        fired.append((op, faults[op], name))
    return fired


def sweep(side, seed: int):
    """The reference's seeded node-failure sweep, as one script: three
    4-host slices of 4 chips, per round one plain gang of 2 x 2 chips and
    a singleton, the round's faults, a pass inside the debounce window
    (flaps resume there), then four passes past it. Returns every
    round's view; asserts the sweep's invariants on the way."""
    stack, agent, now, _ = make_stack(side)
    stack.nodehealth.patch_grace_s = 0.0
    for s in range(3):
        agent.add_slice(f"s{s}", generation="v5e", host_topology=(4, 1, 1),
                        chips_per_host=4)
    agent.publish_all()
    flapped: set = set()
    dead: set = set()
    trace = []
    for r, faults in enumerate(fault_script(seed)):
        create(stack, plain_gang(side, f"g{r}", 2, chips=2)
               + [pod(side, f"one-{r}", **{"tpu/chips": "1"})], run_s=10)
        for op, kind, node in apply_faults(agent, stack.cluster, faults, r):
            if op == "heartbeat_stop" and kind == "flap":
                flapped.add(node)
            elif op in ("node_death", "heartbeat_stop"):
                dead.add(node)
        now.advance(15.0)
        agent.publish_all()
        for node in sorted(flapped):
            agent.resume_heartbeat(node)
        flapped.clear()
        passes = [report_view(stack.nodehealth.run_once())]
        now.advance(20.0)
        agent.publish_all()
        for _ in range(4):
            passes.append(report_view(stack.nodehealth.run_once()))
            stack.scheduler.run_until_idle(max_wall_s=10)
        assert_no_oversubscription(side, stack)
        assert_no_split_gangs(side, stack)
        live = {p.uid for p in stack.cluster.list_pods()}
        waiting = {w.pod.uid for w in stack.framework.waiting_pods()}
        assert stack.accountant.claimed_uids() <= (live | waiting)
        trace.append(dict(passes=passes, **view(stack)))
    for _ in range(4):
        stack.nodehealth.run_once()
        stack.scheduler.run_until_idle(max_wall_s=10)
    for p in stack.cluster.list_pods():
        assert p.node_name not in dead, (p.key, p.node_name, seed)
    for node, st in stack.nodehealth.states().items():
        if node not in dead:
            assert st in (side.NodeState.HEALTHY, side.NodeState.DEGRADED), (node, st)
    return trace + [view(stack)]


class TestNodeFailureSweep:
    @pytest.mark.parametrize("seed", [20260804, 7, 11])
    def test_seeded_sweep_holds_invariants_as_the_reference(self, seed):
        trace = both(sweep, seed)
        assert any(p["singles"] or p["patched"] or p["requeued"] or p["shrunk"]
                   for t in trace[:-1] for p in t["passes"])


class TestFenceFlipCounters:
    def test_pure_fence_flip_patches_rows_and_never_restacks(self):
        """Stopped heartbeats fence hosts; the flip bumps the snapshot
        version but not the metrics epoch, so the resident fleet neither
        re-stacks nor syncs rows (on the card: no ``update_rows`` launch,
        which chip_smoke's run (i) counts), and the next dispatch patches
        exactly the flipped rows of its cached admission row."""
        flipped = ["h1", "h4", "h6"]

        def counters(stack):
            batch = stack.framework.batch_plugins[0]
            res = batch._resident
            return dict(restacks=res.restacks, delta_syncs=res.delta_syncs,
                        rows_applied=res.rows_applied,
                        patched=batch.admission_patched,
                        rebuilds=batch.admission_rebuilds)

        def cycle(stack):
            qpi = stack.queue.pop(timeout=0.0)
            stack.scheduler.schedule_one(qpi)

        def case(side):
            stack, agent, now, _ = make_stack(side)
            for h in range(8):
                agent.add_host(f"h{h}", generation="v5e", chips=8)
            agent.publish_all()
            stack.cluster.create_pod(pod(side, "a", **{"tpu/chips": "2"}))
            cycle(stack)
            agent.publish_all()  # a's host republishes its HBM use
            # An unschedulable pod of the same admission key absorbs a's
            # bind (its pod-set and metrics change) into the cached row.
            stack.cluster.create_pod(pod(side, "big", **{"tpu/chips": "64"}))
            cycle(stack)
            before = counters(stack)
            for h in flipped:
                agent.stop_heartbeat(h)
            now.advance(12.0)
            agent.publish_all()
            stack.nodehealth.run_once()
            assert sorted(stack.nodehealth.fenced_nodes()) == flipped
            stack.cluster.create_pod(pod(side, "c", **{"tpu/chips": "2"}))
            cycle(stack)
            after = counters(stack)
            assert bound_map(stack)["c"] not in flipped
            return before, after, view(stack)

        before, after, _ = both(case)
        assert after["patched"] - before["patched"] == len(flipped)
        for key in ("restacks", "delta_syncs", "rows_applied", "rebuilds"):
            assert after[key] == before[key], key


def unbound_by_repair(stack, before: dict) -> list:
    """Pods bound before that a pass unbound (requeued): order-free."""
    now = bound_map(stack)
    return sorted(p for p, h in before.items() if now.get(p) != h)


class TestDefaultConfigStack:
    def test_built_and_wired(self):
        stack = port_standalone.build_stack(
            config=port_config.SchedulerConfig(kernel_platform="cpu"))
        assert isinstance(stack.bind_executor, BindExecutor)
        assert stack.bind_executor.workers == 8
        assert stack.nodehealth.bind_executor is stack.bind_executor
        assert stack.rebalancer.bind_executor is stack.bind_executor
        assert stack.informer.fence_fn == stack.nodehealth.fenced_nodes
        assert stack.rebalancer.draining_fn == stack.nodehealth.draining_nodes
        assert stack.nodehealth.scheduler is stack.scheduler
        assert not stack.nodehealth.gate_fn()  # until the first resync
        stack.reconciler.resync()
        assert stack.nodehealth.gate_fn()
        # Lazily: no worker thread until the first fan-out.
        assert stack.bind_executor._pool is None

    def test_fan_out_outcomes_equal_the_reference(self):
        """Default config (bind_workers 8, preemption on): a whole requeue
        and a drain fan their unbinds out on executor threads in both
        packages. Everything no thread order can change is equal: which
        pods were unbound, each report, node states and fence sets, the
        hosts each gang ends on; and no oversubscription, no split gang."""

        def case(side):
            stack, agent, _, _ = make_stack(
                side, bind_workers=8, enable_preemption=True)
            for h in range(6):
                agent.add_host(f"h{h}", generation="v5e", chips=4)
                stack.cluster.put_node(side.types.K8sNode(f"h{h}", labels={"pool": "e"}))
            for name in agent.add_slice("s", generation="v5p", host_topology=(4, 1, 1)):
                stack.cluster.put_node(side.types.K8sNode(name))
            agent.publish_all()
            gangs = plain_gang(side, "a", 3, chips=4) + plain_gang(side, "b", 3, chips=4)
            for p in gangs:  # only the pool's hosts: a lost member cannot re-place
                p.node_selector = {"pool": "e"}
            create(stack, gangs + topo_gang(side, "t", "2"), run_s=10)
            submitted = []
            if side is PORT:  # count the fan-out's tasks at the executor
                submit = stack.bind_executor.submit
                stack.bind_executor.submit = (
                    lambda fn: submitted.append(fn) or submit(fn))
            before = bound_map(stack)
            victim = before["a-0"]
            agent.remove_host(victim)
            stack.cluster.kill_node(victim)
            rep = report_view(stack.nodehealth.run_once())
            assert rep["requeued"] == ["a"]
            unbound = unbound_by_repair(stack, before)
            assert unbound == ["a-0", "a-1", "a-2"]
            states = view(stack)
            assert_no_split_gangs(side, stack)
            before = bound_map(stack)
            host = next(h for p, h in before.items() if p.startswith("t-"))
            stack.nodehealth.drain(host)
            drained = stack.rebalancer.run_once().drained
            drain_unbound = unbound_by_repair(stack, before)
            agent.add_host("h9", generation="v5e", chips=4)
            stack.cluster.put_node(side.types.K8sNode("h9", labels={"pool": "e"}))
            agent.publish_all()
            stack.scheduler.run_until_idle(max_wall_s=10)
            assert_no_oversubscription(side, stack)
            assert_no_split_gangs(side, stack)
            hosts = {}
            for p, h in bound_map(stack).items():
                hosts.setdefault(p.split("-")[0], set()).add(h)
            assert host not in hosts["t"]
            if side is PORT:
                assert len(submitted) == 3 + len(drain_unbound)
            return dict(report=rep, unbound=unbound, states=states["states"],
                        fenced=states["fenced"], drained=drained,
                        drain_unbound=drain_unbound,
                        hosts={g: sorted(h) for g, h in sorted(hosts.items())})

        both(case)


class TestBindExecutor:
    def test_fans_out_on_lazy_daemon_workers(self):
        import threading

        ex = BindExecutor(3, name="t")
        assert ex._pool is None
        gate = threading.Event()
        futures = [ex.submit(gate.wait) for _ in range(5)]
        workers = [t for t in threading.enumerate() if t.name.startswith("t-worker")]
        assert len(workers) == 3 and all(t.daemon for t in workers)
        assert not any(f.done() for f in futures)
        gate.set()
        for f in futures:
            f.result(timeout=5)
        ex.shutdown()
        assert ex._pool is None
        for t in workers:
            t.join(timeout=5)
        assert not any(t.is_alive() for t in workers)

    def test_a_failing_task_is_logged_and_settles(self, caplog):
        ex = BindExecutor(1, name="f")

        def boom():
            raise RuntimeError("unbind refused")

        assert ex.submit(boom).result(timeout=5) is None
        assert "bind executor task failed" in caplog.text
        ex.shutdown()

    def test_unbind_all_fans_out_only_with_an_executor_and_items(self):
        """The one unbind policy the monitor and the rebalancer share: two
        or more items go to the executor and the caller waits for all of
        them; one item, or no executor, runs inline on the caller."""
        import threading

        from yoda_tpu_torch.framework.runtime import unbind_all

        class Scheduler:
            def __init__(self):
                self.calls = []

            def _rollback_bound(self, pod, host, state, why):
                self.calls.append((pod, host, why, threading.current_thread().name))

        items = [("p0", "h0"), ("p1", "h1"), ("p2", "h2")]
        ex = BindExecutor(2, name="u")
        try:
            for executor, n, on_workers in (
                (ex, 3, True), (ex, 1, False), (None, 3, False)
            ):
                sched = Scheduler()
                unbind_all(sched, executor, items[:n], "why")
                assert sorted(c[:3] for c in sched.calls) == [
                    (p, h, "why") for p, h in items[:n]]
                names = {c[3] for c in sched.calls}
                if on_workers:
                    assert all(name.startswith("u-worker") for name in names)
                else:
                    assert names == {threading.current_thread().name}
        finally:
            ex.shutdown()


class TestRunI:
    def test_node_health_run_holds_its_checks(self):
        """chip_smoke's run (i) at its small size on the CPU: every
        invariant of the run holds (the card test compares the card's run
        with this one)."""
        run = run_nodehealth("cpu", NODEHEALTH_SMALL)
        check_nodehealth_run(run, NODEHEALTH_SMALL)

    def test_rerun_in_a_second_process_equals_the_run(self):
        """chip_smoke reruns run (i) on the CPU in the spawned process that
        also reruns run (h), beside the card's phases: its run (i) equals
        the same run in this process in every field the card run is held
        to."""
        from chip_smoke import BACKGROUND_SMALL, NODEHEALTH_PARITY, CpuRerun

        rerun = CpuRerun(BACKGROUND_SMALL, NODEHEALTH_SMALL)
        try:
            got = rerun.nodehealth(timeout_s=300)
        finally:
            rerun.stop()
        want = run_nodehealth("cpu", NODEHEALTH_SMALL)
        assert {k: got[k] for k in NODEHEALTH_PARITY} == {k: want[k] for k in NODEHEALTH_PARITY}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_down_during_bind_fanout(pkg, request, monkeypatch):
    """The reference's TestDownDuringBindFanout on either package: the
    gang settles whole-or-nothing whatever interleaving lands, and later
    monitor passes repair it whole."""
    case = (
        "TestDownDuringBindFanout::test_node_death_mid_fanout_never_splits_the_gang",
        "TestDownDuringBindFanout",
        "test_node_death_mid_fanout_never_splits_the_gang",
    )
    run_case(pkg, "test_node_health.py", case, request, monkeypatch)
