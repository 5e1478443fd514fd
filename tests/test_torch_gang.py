"""The port's gang path on the CPU: gangs of the four label kinds (plain
``tpu/gang`` + ``tpu/gang-size``, topology ``tpu/topology``, multislice
``tpu/multislice`` + ``tpu/topology``, and the coscheduling aliases) bind
all-or-nothing through yoda_tpu_torch.standalone.build_stack.

- Port-side copies of the tests/test_gang.py and tests/test_gang_fused.py
  scenarios of the batch path (the reference's loop-mode and mesh cases run
  in tests/test_torch_loop.py and tests/test_torch_parallel.py, its bind
  pipeline and serve_forever cases in tests/test_torch_bind_pipeline.py and
  tests/test_torch_cli.py). Permit expiry is
  driven through the stack's injected clock with a small
  ``gang_permit_timeout_s``: no test sleeps on a real timeout.
- Stack parity with yoda_tpu.standalone.build_stack: seeded fleets of v5p
  slices (2x2x1 and 2x2x2 host grids) and v5e hosts with cordons, pool
  labels and random chip health, and scripts that mix the four gang kinds
  with singletons, co-queued and arriving in two waves, at batch_requests
  1 and 16, with preemption off and on in both. Bindings (evictions
  included), per-gang verdicts and the gang counters must be equal. Both
  packages build their speculative placement cache (gang pods are out of
  its scope), as in tests/test_torch_stack.py."""

import itertools
import math
import time
from collections import Counter

import numpy as np
import pytest

import yoda_tpu.api.types as ref_types
import yoda_tpu_torch.api.types as port_types
from yoda_tpu.config import SchedulerConfig as RefConfig
from yoda_tpu.standalone import build_stack as ref_build_stack
from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
from yoda_tpu_torch.api.requests import GangSpec, gang_name_of
from yoda_tpu_torch.api.types import K8sNode, PodSpec, TpuNodeMetrics
from yoda_tpu_torch.cluster.fake import Event
from yoda_tpu_torch.config import SchedulerConfig
from yoda_tpu_torch.framework.interfaces import BindPlugin, Code, Status
from yoda_tpu_torch.framework.queue import QueuedPodInfo, SchedulingQueue
from yoda_tpu_torch.plugins.yoda.gang import GangPlugin, _GangState
from yoda_tpu_torch.standalone import build_stack


class FakeClock:
    """The stack's scheduling clock, advanced by hand: permit deadlines and
    queue backoff move only when a test says so."""

    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


def make_stack(clock=None, extra_plugins=None, **cfg):
    kw = {} if clock is None else {"clock": clock}
    stack = build_stack(
        config=SchedulerConfig(kernel_platform="cpu", **cfg),
        extra_plugins=extra_plugins,
        **kw,
    )
    return stack, FakeTpuAgent(stack.cluster)


def gang_pods(name, n, chips=4, extra=None):
    labels = {"tpu/gang": name, "tpu/gang-size": str(n), "tpu/chips": str(chips)}
    labels.update(extra or {})
    return [PodSpec(f"{name}-{i}", labels=dict(labels)) for i in range(n)]


def topo_pods(name, topology, chips=4, extra=None):
    labels = {"tpu/gang": name, "tpu/topology": topology, "tpu/chips": str(chips)}
    labels.update(extra or {})
    n = math.prod(int(d) for d in topology.split("x"))
    return [PodSpec(f"{name}-{i}", labels=dict(labels)) for i in range(n)]


def gang_pod(gang, i, size=4, chips="2", **labels):
    return PodSpec(
        f"{gang}-{i}",
        labels={"tpu/gang": gang, "tpu/gang-size": str(size), "tpu/chips": chips, **labels},
    )


def expire(stack, clock, seconds=1.0) -> None:
    """Move the clock past every permit deadline and sweep the waitlist."""
    clock.advance(seconds)
    stack.framework.expire_waiting(now=clock())


class FlakyBinder(BindPlugin):
    """Fails the first bind of one pod, then lets the real binder answer."""

    name = "flaky-binder"

    def __init__(self, victim: str):
        self.victim = victim
        self.tripped = False

    def bind(self, state, pod, node_name):
        if not self.tripped and pod.name == self.victim:
            self.tripped = True
            return Status.error("transient bind failure")
        return Status(code=Code.SKIP)


class TestGangAtomicity:
    def test_gang_binds_together(self):
        stack, agent = make_stack()
        for i in range(4):
            agent.add_host(f"host-{i}", generation="v5p", chips=4)
        agent.publish_all()
        for pod in gang_pods("job-a", 4, chips=4):
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=10)
        bound = {p.name: p.node_name for p in stack.cluster.list_pods()}
        assert all(v is not None for v in bound.values()), bound
        assert stack.gang.gang_status("job-a") == (4, 0, 4)

    def test_incomplete_gang_binds_nothing(self):
        # Only 3 of 4 members created: nothing binds, and after the permit
        # deadline the cascade rolls every reservation back.
        clock = FakeClock()
        stack, agent = make_stack(clock, gang_permit_timeout_s=0.3)
        for i in range(4):
            agent.add_host(f"host-{i}", generation="v5p", chips=4)
        agent.publish_all()
        for pod in gang_pods("job-a", 4)[:3]:
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        assert len(stack.framework.waiting_pods()) == 3
        assert sum(stack.accountant.chips_by_node().values()) == 12
        expire(stack, clock)
        assert all(p.node_name is None for p in stack.cluster.list_pods())
        assert stack.framework.waiting_pods() == []
        assert all(
            stack.accountant.chips_in_use(f"host-{i}") == 0 for i in range(4)
        )
        assert stack.gang.gang_status("job-a") == (4, 0, 0)

    def test_late_member_completes_gang(self):
        stack, agent = make_stack()
        for i in range(2):
            agent.add_host(f"host-{i}", generation="v5p", chips=4)
        agent.publish_all()
        pods = gang_pods("job-b", 2)
        stack.cluster.create_pod(pods[0])
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        assert stack.cluster.get_pod(f"default/{pods[0].name}").node_name is None
        stack.cluster.create_pod(pods[1])
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert all(p.node_name for p in stack.cluster.list_pods())

    def test_no_partial_reservation_when_gang_cannot_fit(self):
        # Admission: a 4-member gang on a 2-host fleet (1 slot each)
        # reserves nothing.
        stack, agent = make_stack()
        agent.add_host("host-0", generation="v5p", chips=4)
        agent.add_host("host-1", generation="v5p", chips=4)
        agent.publish_all()
        for pod in gang_pods("too-big", 4, chips=4):
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=2)
        assert all(p.node_name is None for p in stack.cluster.list_pods())
        assert stack.accountant.chips_in_use("host-0") == 0
        assert stack.accountant.chips_in_use("host-1") == 0
        assert any(
            "only 2 slots are free" in r.message for r in stack.scheduler.stats.results
        )

    def test_gang_members_can_share_host(self):
        # Non-topology gang: 4 members x 2 chips fit one v5e-8 host.
        stack, agent = make_stack()
        agent.add_host("big-host", generation="v5e", chips=8)
        agent.publish_all()
        for pod in gang_pods("packed", 4, chips=2):
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert all(p.node_name == "big-host" for p in stack.cluster.list_pods())


class TestBaselineConfig4Topology:
    def test_v5p_slice_gang_with_ici_affinity(self):
        # Config 4: 4 pods, topology 2x2x1, atomically across the 4 hosts
        # of one slice.
        stack, agent = make_stack()
        agent.add_slice("v5p-a", generation="v5p", host_topology=(2, 2, 1))
        agent.publish_all()
        for pod in topo_pods("train", "2x2x1", chips=4):
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=10)
        placements = {p.name: p.node_name for p in stack.cluster.list_pods()}
        assert all(v for v in placements.values()), placements
        assert len(set(placements.values())) == 4  # one member per host
        assert all(v.startswith("v5p-a") for v in placements.values())

    def test_topology_gang_picks_slice_with_room(self):
        stack, agent = make_stack()
        agent.add_slice("slice-a", generation="v5p", host_topology=(2, 2, 1))
        agent.add_slice("slice-b", generation="v5p", host_topology=(2, 2, 1))
        agent.publish_all()
        stack.cluster.create_pod(PodSpec("blocker", labels={"tpu/chips": "4"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        blocked_host = stack.cluster.get_pod("default/blocker").node_name
        other = "slice-b" if blocked_host.startswith("slice-a") else "slice-a"
        for pod in topo_pods("t", "2x2x1", chips=4):
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=10)
        gang_hosts = {
            p.node_name for p in stack.cluster.list_pods() if p.name.startswith("t-")
        }
        assert all(h and h.startswith(other) for h in gang_hosts), gang_hosts

    def test_topology_gang_unschedulable_without_contiguous_block(self):
        stack, agent = make_stack()
        agent.add_slice("s", generation="v5p", host_topology=(2, 2, 1))
        agent.publish_all()
        # Occupy two diagonal hosts: no contiguous 2x2 block remains free.
        for name, host in [("b0", "s-0"), ("b1", "s-3")]:
            p = PodSpec(name, labels={"tpu/chips": "4"})
            p.node_name = host
            p.phase = "Running"
            stack.cluster.create_pod(p)
        agent.publish_all()
        for pod in topo_pods("t", "2x2x1", chips=4):
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=2)
        gang = [p for p in stack.cluster.list_pods() if p.name.startswith("t-")]
        assert all(p.node_name is None for p in gang)
        assert stack.framework.waiting_pods() == []
        assert any(
            "no slice has a free contiguous 2x2x1 host block" in r.message
            for r in stack.scheduler.stats.results
        )


class TestGangConsistency:
    def test_mismatched_gang_size_is_unresolvable(self):
        clock = FakeClock()
        stack, agent = make_stack(clock)
        agent.add_host("h", generation="v5p", chips=4)
        agent.publish_all()
        stack.cluster.create_pod(
            PodSpec("a", labels={"tpu/gang": "g", "tpu/gang-size": "2"})
        )
        stack.cluster.create_pod(
            PodSpec("b", labels={"tpu/gang": "g", "tpu/gang-size": "3"})
        )
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        results = stack.scheduler.stats.results
        assert any("size/topology" in r.message for r in results)

    def test_two_gangs_contending_one_completes(self):
        # Two 2-member gangs, capacity for one: exactly one gang binds.
        clock = FakeClock()
        stack, agent = make_stack(clock, gang_permit_timeout_s=0.5)
        agent.add_host("h0", generation="v5p", chips=4)
        agent.add_host("h1", generation="v5p", chips=4)
        agent.publish_all()
        for pod in gang_pods("gang-a", 2, chips=4) + gang_pods("gang-b", 2, chips=4):
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=5)
        bound_by_gang = Counter(
            p.labels["tpu/gang"] for p in stack.cluster.list_pods() if p.node_name
        )
        assert sorted(bound_by_gang.values()) == [2], bound_by_gang
        assert stack.framework.waiting_pods() == []

    def test_bind_failure_self_heals(self):
        # A bind that fails AFTER Permit released the gang rolls the whole
        # release back; the gang re-admits and completes.
        flaky = FlakyBinder("job-f-1")
        stack, agent = make_stack(extra_plugins=[flaky])
        for i in range(4):
            agent.add_host(f"host-{i}", generation="v5p", chips=4)
        agent.publish_all()
        for pod in gang_pods("job-f", 4, chips=4):
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=10)
        assert flaky.tripped
        bound = {p.name: p.node_name for p in stack.cluster.list_pods()}
        assert all(v is not None for v in bound.values()), bound
        assert stack.gang.gang_status("job-f") == (4, 0, 4)
        assert stack.gang.bind_rollbacks == 1
        for i in range(4):
            assert stack.accountant.chips_in_use(f"host-{i}") == 4

    def test_bind_failure_rolls_landed_members_back_whole(self):
        # The third member to bind fails, after two siblings' binds
        # landed: they are unbound and requeued with it — never a split
        # gang — and with that pod failing for good nothing stays bound or
        # reserved.
        class DeadBinder(BindPlugin):
            name = "dead-binder"

            def __init__(self):
                self.calls = 0
                self.victim = None

            def bind(self, state, pod, node_name):
                self.calls += 1
                if self.calls == 3:
                    self.victim = pod.name
                if pod.name == self.victim:
                    return Status.error("node agent refused the pod")
                return Status(code=Code.SKIP)

        stack, agent = make_stack(extra_plugins=[DeadBinder()])
        for i in range(4):
            agent.add_host(f"host-{i}", generation="v5p", chips=4)
        agent.publish_all()
        for pod in gang_pods("rb", 4, chips=4):
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=2)
        assert all(p.node_name is None for p in stack.cluster.list_pods())
        assert sum(stack.accountant.chips_by_node().values()) == 0
        assert stack.gang.bind_rollbacks >= 1
        assert stack.binder.unbinds >= 2
        assert stack.gang.gang_status("rb") in (None, (4, 0, 0))

    def test_topology_gang_reconstructed_after_restart(self):
        stack, agent = make_stack()
        agent.add_slice("s", generation="v5p", host_topology=(2, 2, 1))
        agent.publish_all()
        pods = topo_pods("resume", "2x2x1", chips=4)
        pods[0].node_name = "s-1"
        pods[0].phase = "Running"
        stack.cluster.create_pod(pods[0])
        agent.publish_all()  # metrics now show s-1's chips consumed
        stack2 = build_stack(
            cluster=stack.cluster, config=SchedulerConfig(kernel_platform="cpu")
        )
        assert stack2.gang.gang_status("resume") == (4, 0, 1)
        for p in pods[1:]:
            stack2.cluster.create_pod(p)
        stack2.scheduler.run_until_idle(max_wall_s=10)
        placements = {p.name: p.node_name for p in stack2.cluster.list_pods()}
        assert all(placements.values()), placements
        assert len(set(placements.values())) == 4

    def test_gang_reconstructed_after_restart(self):
        stack, agent = make_stack()
        for i in range(2):
            agent.add_host(f"h{i}", generation="v5p", chips=4)
        agent.publish_all()
        pods = gang_pods("resume", 2)
        pods[0].node_name = "h0"
        pods[0].phase = "Running"
        stack.cluster.create_pod(pods[0])
        stack2 = build_stack(
            cluster=stack.cluster, config=SchedulerConfig(kernel_platform="cpu")
        )
        assert stack2.gang.gang_status("resume") == (2, 0, 1)
        stack2.cluster.create_pod(pods[1])
        stack2.scheduler.run_until_idle(max_wall_s=5)
        assert stack2.cluster.get_pod(f"default/{pods[1].name}").node_name is not None


class TestGangBatchedDispatch:
    """ONE evaluation places the whole gang: siblings are served host-side
    from the dispatch's claimable-chips rows."""

    @staticmethod
    def _warm(stack):
        stack.cluster.create_pod(PodSpec("warm", labels={"tpu/chips": "1"}))
        stack.scheduler.run_until_idle(max_wall_s=5.0)
        stack.cluster.delete_pod("default/warm")
        stack.scheduler.run_until_idle(max_wall_s=5.0)

    def test_one_dispatch_per_topology_gang(self):
        stack, agent = make_stack()
        agent.add_slice("s", host_topology=(2, 2, 1))
        agent.add_slice("t", host_topology=(2, 2, 1))
        agent.publish_all()
        self._warm(stack)
        batch = stack.batch
        d0 = batch.dispatch_count
        for p in topo_pods("tg", "2x2x1", chips=4):
            stack.cluster.create_pod(p)
        stack.scheduler.run_until_idle(max_wall_s=10.0)
        placed = {p.name: p.node_name for p in stack.cluster.list_pods()}
        assert all(placed.values()), placed
        hosts = set(placed.values())
        assert len(hosts) == 4
        assert len({h.rsplit("-", 1)[0] for h in hosts}) == 1
        assert batch.dispatch_count == d0 + 1
        # All four members (gathered co-queued) answered from the single
        # gang-fused dispatch; the lazy plan path never needed to build.
        assert batch.gang_burst_served == 4
        assert batch.gang_burst_dispatches == 1
        assert not batch._gang_bursts  # fully-served set released
        assert not batch._gang_plans

    def test_one_dispatch_per_plain_gang_sharing_hosts(self):
        stack, agent = make_stack()
        agent.add_host("h0", generation="v5p", chips=4)
        agent.add_host("h1", generation="v5p", chips=4)
        agent.publish_all()
        self._warm(stack)
        d0 = stack.batch.dispatch_count
        for p in gang_pods("pg", 4, chips=2):  # 2 members per 4-chip host
            stack.cluster.create_pod(p)
        stack.scheduler.run_until_idle(max_wall_s=10.0)
        placed = {p.name: p.node_name for p in stack.cluster.list_pods()}
        assert all(placed.values()), placed
        assert all(c <= 2 for c in Counter(placed.values()).values())
        assert stack.batch.dispatch_count == d0 + 1

    def test_foreign_interference_invalidates_plan(self):
        """A foreign pod reserving onto a planned node between member
        cycles invalidates the lazy plan; the siblings fall back to fresh
        dispatches and the gang still binds with no oversubscription."""
        stack, agent = make_stack(gang_permit_timeout_s=300.0)
        hosts = [f"h{i}" for i in range(4)]
        for h in hosts:
            agent.add_host(h, generation="v5p", chips=4)
        agent.publish_all()
        self._warm(stack)
        batch = stack.batch
        pods = gang_pods("fg", 3, chips=4)
        stack.cluster.create_pod(pods[0])
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        assert stack.gang.gang_status("fg")[1] == 1
        assert "fg" in batch._gang_plans
        planned = batch._gang_plans["fg"].picks[1]
        stack.cluster.create_pod(
            PodSpec("foreign", labels={"tpu/chips": "4", "tpu/priority": "9"})
        )
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        foreign = stack.cluster.get_pod("default/foreign")
        assert foreign is not None and foreign.node_name == planned
        for p in pods[1:]:
            stack.cluster.create_pod(p)
        stack.scheduler.run_until_idle(max_wall_s=10.0)
        placed = {
            p.name: p.node_name
            for p in stack.cluster.list_pods()
            if p.name.startswith("fg")
        }
        assert all(placed.values()), placed
        assert all(c <= 1 for c in Counter(placed.values()).values())
        assert planned not in placed.values()
        for h in hosts:
            assert stack.accountant.chips_in_use(h) <= 4, h


class TestDeleteEventFastPath:
    def test_deleting_parked_member_cancels_gang_wait_immediately(self):
        clock = FakeClock()
        stack, agent = make_stack(clock)
        for i in range(4):
            agent.add_host(f"h{i}", generation="v5p", chips=4)
        agent.publish_all()
        for pod in gang_pods("g", 3)[:2]:
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        assert len(stack.framework.waiting_pods()) == 2
        assert sum(stack.accountant.chips_by_node().values()) == 8
        # The deletion alone resolves the deleted member's wait and
        # cascades the sibling, releasing every reservation.
        stack.cluster.delete_pod("default/g-0")
        assert stack.framework.waiting_pods() == []
        assert sum(stack.accountant.chips_by_node().values()) == 0
        for pod in gang_pods("g", 3)[1:]:
            if stack.cluster.get_pod(f"default/{pod.name}") is None:
                stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        # g-0 is gone; g-1 and g-2 alone cannot complete a size-3 gang.
        assert [p for p in stack.cluster.list_pods() if p.node_name] == []

    def test_deleting_backoff_member_removes_queue_entry(self):
        stack, agent = make_stack()
        agent.add_host("tiny", generation="v5p", chips=2)
        agent.publish_all()
        stack.cluster.create_pod(gang_pods("big", 4)[0])
        stack.scheduler.run_until_idle(max_wall_s=2)
        assert len(stack.queue) == 1
        cycles = len(stack.scheduler.stats.results)
        stack.cluster.delete_pod("default/big-0")
        assert len(stack.queue) == 0
        stack.scheduler.run_until_idle(max_wall_s=2)
        assert len(stack.scheduler.stats.results) == cycles

    def test_deleting_queued_member_fuses_remaining_gang(self):
        stack, agent = make_stack()
        for i in range(2):
            agent.add_host(f"h{i}", generation="v5p", chips=4)
        agent.publish_all()
        pods = gang_pods("q", 2)
        stack.cluster.create_pod(pods[0])
        stack.cluster.delete_pod("default/q-0")
        assert len(stack.queue) == 0
        for pod in gang_pods("q", 2):
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=10)
        placements = {
            p.name: p.node_name for p in stack.cluster.list_pods() if p.node_name
        }
        assert sorted(placements) == ["q-0", "q-1"]


class TestNodeFailureMidGang:
    """A planned host dies while members wait at the Permit barrier: the
    event rejects them, the cascade rolls EVERY reservation back, and the
    gang re-plans onto an intact slice and completes."""

    def test_host_death_during_permit_wait(self):
        clock = FakeClock()
        stack, agent = make_stack(clock, gang_permit_timeout_s=300.0)
        a_hosts = agent.add_slice("slice-a", host_topology=(2, 2, 1))
        b_hosts = agent.add_slice("slice-b", host_topology=(2, 2, 1))
        agent.publish_all()
        pods = topo_pods("g", "2x2", chips=4)
        for p in pods[:3]:
            stack.cluster.create_pod(p)
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        status = stack.gang.gang_status("g")
        assert status is not None and status[1] == 3, f"want 3 waiting: {status}"
        reserved_hosts = [
            h for h in a_hosts + b_hosts if stack.accountant.chips_in_use(h) > 0
        ]
        assert len(reserved_hosts) == 3
        (planned_slice,) = {h.rsplit("-", 1)[0] for h in reserved_hosts}
        agent.remove_host(reserved_hosts[0])  # one reserved host dies
        stack.cluster.create_pod(pods[3])
        stack.scheduler.run_until_idle(max_wall_s=10.0)
        bound = [stack.cluster.get_pod(p.key) for p in pods]
        assert all(p is not None and p.node_name for p in bound), (
            f"{[(p.name, p.node_name) for p in bound if p]}"
        )
        hosts = {p.node_name for p in bound}
        other_slice = {"slice-a": "slice-b", "slice-b": "slice-a"}[planned_slice]
        assert len(hosts) == 4
        assert {h.rsplit("-", 1)[0] for h in hosts} == {other_slice}
        for h in a_hosts + b_hosts:
            if h.rsplit("-", 1)[0] == planned_slice and h != reserved_hosts[0]:
                assert stack.accountant.chips_in_use(h) == 0, h

    def test_free_planned_host_death_cancels_waiters(self):
        clock = FakeClock()
        stack, agent = make_stack(clock, gang_permit_timeout_s=300.0)
        agent.add_slice("slice-a", host_topology=(2, 2, 1))
        agent.add_slice("slice-b", host_topology=(2, 2, 1))
        agent.publish_all()
        pods = topo_pods("g", "2x2", chips=4)
        for p in pods[:3]:
            stack.cluster.create_pod(p)
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        assert stack.gang.gang_status("g")[1] == 3
        free = stack.gang.planned_unassigned_hosts("g")
        assert free is not None and len(free) == 1
        agent.remove_host(free[0])  # the un-reserved planned slot dies
        stack.cluster.create_pod(pods[3])
        stack.scheduler.run_until_idle(max_wall_s=10.0)
        bound = [stack.cluster.get_pod(p.key) for p in pods]
        assert all(p is not None and p.node_name for p in bound)
        hosts = {p.node_name for p in bound}
        assert len(hosts) == 4
        assert len({h.rsplit("-", 1)[0] for h in hosts}) == 1

    def test_plain_gang_recovers_when_dead_host_returns(self):
        clock = FakeClock()
        stack, agent = make_stack(clock, gang_permit_timeout_s=300.0)
        agent.add_host("h1", generation="v5p", chips=4)
        agent.add_host("h2", generation="v5p", chips=4)
        agent.publish_all()
        pods = gang_pods("pg", 2, chips=4)
        stack.cluster.create_pod(pods[0])
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        assert stack.gang.gang_status("pg")[1] == 1  # waiting
        host = next(h for h in ("h1", "h2") if stack.accountant.chips_in_use(h) > 0)
        agent.remove_host(host)           # dies mid-wait -> cascade
        assert stack.framework.waiting_pods() == []
        assert stack.accountant.chips_in_use(host) == 0
        agent.add_host(host, generation="v5p", chips=4)
        agent.publish_all()               # host rejoins -> un-blacklisted
        stack.cluster.create_pod(pods[1])
        stack.scheduler.run_until_idle(max_wall_s=10.0)
        bound = [stack.cluster.get_pod(p.key) for p in pods]
        assert all(p is not None and p.node_name for p in bound)

    def test_dead_mark_cleared_only_by_same_kind(self):
        g = GangPlugin()
        g._gangs["x"] = _GangState(spec=GangSpec(name="x", size=2, topology=None))
        g.handle(Event("deleted", "Node", K8sNode("h1")))
        assert "h1" in g._gangs["x"].dead_hosts
        g.handle(Event("modified", "TpuNodeMetrics", TpuNodeMetrics(name="h1")))
        assert "h1" in g._gangs["x"].dead_hosts  # CR republish: still dead
        g.handle(Event("added", "Node", K8sNode("h1")))
        assert "h1" not in g._gangs["x"].dead_hosts

    def test_zombie_pod_watch_event_cannot_resurrect_membership(self):
        g = GangPlugin()
        gs = _GangState(spec=GangSpec(name="z", size=2, topology=None))
        g._gangs["z"] = gs
        zombie = PodSpec("z-0", labels={"tpu/gang": "z", "tpu/gang-size": "2"})
        zombie.node_name = "h-dead"
        gs.bound.add(zombie.key)
        gs.assigned[zombie.key] = "h-dead"
        g._on_host_gone("h-dead", "Node")
        gs.bound.discard(zombie.key)
        gs.assigned.pop(zombie.key, None)
        g.handle(Event("modified", "Pod", zombie))
        assert zombie.key not in gs.bound  # not resurrected
        g.handle(Event("added", "Node", K8sNode("h-dead")))
        g.handle(Event("modified", "Pod", zombie))
        assert zombie.key in gs.bound

    def test_bound_member_host_death_unwedges_replan(self):
        clock = FakeClock()
        stack, agent = make_stack(clock, gang_permit_timeout_s=300.0)
        a_hosts = agent.add_slice("slice-a", host_topology=(2, 2, 1))
        agent.add_slice("slice-b", host_topology=(2, 2, 1))
        agent.publish_all()
        pods = topo_pods("resume", "2x2x1", chips=4)
        pods[0].node_name = a_hosts[1]
        pods[0].phase = "Running"
        stack.cluster.create_pod(pods[0])
        agent.publish_all()
        stack2 = build_stack(
            cluster=stack.cluster,
            config=SchedulerConfig(kernel_platform="cpu", gang_permit_timeout_s=300.0),
            clock=clock,
        )
        assert stack2.gang.gang_status("resume") == (4, 0, 1)
        agent.remove_host(a_hosts[1])  # the bound member's host dies
        for p in pods[1:]:
            stack2.cluster.create_pod(p)
        stack2.scheduler.run_until_idle(max_wall_s=0.3)
        # The lost member was dropped and the survivors planned a fresh
        # block: they park at the permit barrier.
        assert stack2.gang.gang_status("resume") == (4, 3, 0)
        stack2.cluster.delete_pod(pods[0].key)
        stack2.cluster.create_pod(PodSpec("resume-0r", labels=dict(pods[1].labels)))
        stack2.scheduler.run_until_idle(max_wall_s=10.0)
        placements = {p.name: p.node_name for p in stack2.cluster.list_pods()}
        assert all(placements.values()), placements
        hosts = set(placements.values())
        assert len(hosts) == 4
        assert {h.rsplit("-", 1)[0] for h in hosts} == {"slice-b"}


def ms_labels(name, slices=2, chips=4):
    return {
        "tpu/gang": name,
        "tpu/topology": "2x2x1",
        "tpu/multislice": str(slices),
        "tpu/chips": str(chips),
    }


class TestMultislice:
    def test_label_parsing(self):
        from yoda_tpu_torch.api.requests import LabelParseError, parse_request

        req = parse_request(
            {"tpu/gang": "m", "tpu/topology": "2x2", "tpu/multislice": "2"}
        )
        assert req.gang.slices == 2 and req.gang.size == 8
        with pytest.raises(LabelParseError, match="requires tpu/topology"):
            parse_request({"tpu/gang": "m", "tpu/gang-size": "4", "tpu/multislice": "2"})
        with pytest.raises(LabelParseError, match="implies 8"):
            parse_request(
                {
                    "tpu/gang": "m",
                    "tpu/topology": "2x2",
                    "tpu/multislice": "2",
                    "tpu/gang-size": "4",
                }
            )
        with pytest.raises(LabelParseError, match="must be >= 1"):
            parse_request(
                {"tpu/gang": "m", "tpu/topology": "2x2", "tpu/multislice": "0"}
            )

    def test_multislice_gang_binds_atomically_one_dispatch(self):
        stack, agent = make_stack()
        agent.add_slice("ms-a", host_topology=(2, 2, 1))
        agent.add_slice("ms-b", host_topology=(2, 2, 1))
        agent.add_host("edge-0", chips=8)
        agent.publish_all()
        d0 = stack.batch.dispatch_count
        for i in range(8):
            stack.cluster.create_pod(PodSpec(f"ms-{i}", labels=ms_labels("ms")))
        stack.scheduler.run_until_idle(max_wall_s=10.0)
        placed = {p.name: p.node_name for p in stack.cluster.list_pods()}
        assert all(placed.values()), placed
        hosts = set(placed.values())
        assert len(hosts) == 8  # one member per host
        assert {h.rsplit("-", 1)[0] for h in hosts} == {"ms-a", "ms-b"}
        assert stack.batch.dispatch_count == d0 + 1  # ONE dispatch for all 8

    def test_two_multislice_gangs_contend_atomically(self):
        """2 gangs x 2 blocks over 3 slices: only one gang completes; the
        loser holds nothing, then completes after the winner tears down."""
        clock = FakeClock()
        stack, agent = make_stack(clock, gang_permit_timeout_s=1.0)
        for s in ("c-a", "c-b", "c-c"):
            agent.add_slice(s, host_topology=(2, 2, 1))
        agent.publish_all()
        for name in ("g1", "g2"):
            for i in range(8):
                stack.cluster.create_pod(PodSpec(f"{name}-{i}", labels=ms_labels(name)))
        stack.scheduler.run_until_idle(max_wall_s=10.0)

        def bound(g):
            return [
                p for p in stack.cluster.list_pods()
                if p.labels.get("tpu/gang") == g and p.node_name
            ]

        counts = sorted(len(bound(g)) for g in ("g1", "g2"))
        assert counts == [0, 8], counts
        assert stack.framework.waiting_pods() == []
        winner = next(g for g in ("g1", "g2") if len(bound(g)) == 8)
        loser = "g2" if winner == "g1" else "g1"
        for p in bound(winner):
            stack.cluster.delete_pod(p.key)
        stack.scheduler.run_until_idle(max_wall_s=10.0)
        assert len(bound(loser)) == 8

    def test_multislice_restart_reconstruction(self):
        stack, agent = make_stack()
        a_hosts = agent.add_slice("rs-a", host_topology=(2, 2, 1))
        agent.add_slice("rs-b", host_topology=(2, 2, 1))
        agent.publish_all()
        pods = [PodSpec(f"rms-{i}", labels=ms_labels("rms")) for i in range(8)]
        pods[0].node_name = a_hosts[0]
        pods[0].phase = "Running"
        stack.cluster.create_pod(pods[0])
        agent.publish_all()
        stack2 = build_stack(
            cluster=stack.cluster, config=SchedulerConfig(kernel_platform="cpu")
        )
        assert stack2.gang.gang_status("rms") == (8, 0, 1)
        for p in pods[1:]:
            stack2.cluster.create_pod(p)
        stack2.scheduler.run_until_idle(max_wall_s=10.0)
        placed = {p.name: p.node_name for p in stack2.cluster.list_pods()}
        assert all(placed.values()), placed
        assert len(set(placed.values())) == 8
        assert placed["rms-0"] == a_hosts[0]  # the pinned member stayed put


class TestCoschedulingCompat:
    def test_pod_group_labels_gang_binds_atomically(self):
        stack, agent = make_stack()
        agent.add_host("h1", chips=8)
        agent.add_host("h2", chips=8)
        agent.publish_all()
        labels = {
            "pod-group.scheduling.sigs.k8s.io/name": "pg",
            "pod-group.scheduling.sigs.k8s.io/min-available": "3",
            "tpu/chips": "4",
        }
        for i in range(2):
            stack.cluster.create_pod(PodSpec(f"pg-{i}", labels=dict(labels)))
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        assert all(
            stack.cluster.get_pod(f"default/pg-{i}").node_name is None
            for i in range(2)
        )
        stack.cluster.create_pod(PodSpec("pg-2", labels=dict(labels)))
        stack.scheduler.run_until_idle(max_wall_s=5)
        bound = [stack.cluster.get_pod(f"default/pg-{i}").node_name for i in range(3)]
        assert all(bound), bound

    def test_alias_only_member_deletion_cascades(self):
        clock = FakeClock()
        stack, agent = make_stack(clock)
        agent.add_host("h1", chips=8)
        agent.publish_all()
        labels = {
            "pod-group.scheduling.sigs.k8s.io/name": "pg-del",
            "pod-group.scheduling.sigs.k8s.io/min-available": "3",
            "tpu/chips": "1",
        }
        for i in range(2):
            stack.cluster.create_pod(PodSpec(f"pgd-{i}", labels=dict(labels)))
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        assert stack.accountant.chips_in_use("h1") == 2
        stack.cluster.delete_pod("default/pgd-0")
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        # The deletion is SEEN: the deleted member's reservation releases
        # and no ghost remains to satisfy the barrier early.
        assert stack.accountant.chips_in_use("h1") == 1
        gs = stack.gang._gangs.get("pg-del")
        assert gs is not None and "default/pgd-0" not in gs.waiting
        for name in ("pgd-0b", "pgd-2"):
            stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
        stack.scheduler.run_until_idle(max_wall_s=5)
        bound = [p for p in stack.cluster.list_pods() if p.node_name]
        assert len(bound) == 3


class TestGatheredGang:
    def test_scattered_members_fuse_into_one_dispatch(self):
        """Members split around a block of singletons: the first member's
        pop gathers the tail members past the singletons, the gang places
        from ONE dispatch, and the singletons burst behind it."""
        stack, agent = make_stack(batch_requests=8)
        for s in range(2):
            agent.add_slice(f"v5p-{s}", generation="v5p", host_topology=(2, 2, 1))
        for i in range(4):
            agent.add_host(f"v5e-{i}", generation="v5e", chips=8)
        agent.publish_all()
        yb = stack.batch
        topo = {"tpu/gang": "g", "tpu/topology": "2x2x1", "tpu/chips": "4"}
        for i in range(2):
            stack.cluster.create_pod(PodSpec(f"g-{i}", labels=dict(topo)))
        for i in range(16):
            stack.cluster.create_pod(PodSpec(f"s-{i}", labels={"tpu/chips": "1"}))
        for i in range(2, 4):
            stack.cluster.create_pod(PodSpec(f"g-{i}", labels=dict(topo)))
        stack.scheduler.run_until_idle(max_wall_s=10)
        pods = stack.cluster.list_pods()
        assert all(p.node_name for p in pods)
        gang_hosts = {p.node_name for p in pods if p.name.startswith("g-")}
        assert len(gang_hosts) == 4
        assert len({h.rsplit("-", 1)[0] for h in gang_hosts}) == 1
        assert yb.gang_burst_dispatches == 1
        assert yb.gang_burst_served == 4
        assert yb.burst_served >= 8
        for i in range(4):
            assert stack.accountant.chips_in_use(f"v5e-{i}") <= 8

    def test_heterogeneous_members_fuse(self):
        stack, agent = make_stack()
        for i in range(2):
            agent.add_host(f"h{i}", generation="v5p", chips=8)
        agent.publish_all()
        yb = stack.batch
        for i, chips in enumerate(("2", "3", "2", "3")):
            stack.cluster.create_pod(gang_pod("het", i, chips=chips))
        stack.scheduler.run_until_idle(max_wall_s=10)
        assert all(p.node_name for p in stack.cluster.list_pods())
        assert yb.gang_burst_dispatches == 1
        assert yb.gang_burst_served == 4
        for i in range(2):
            assert stack.accountant.chips_in_use(f"h{i}") <= 8

    def test_priority_inversion_bounded_by_gang_size(self):
        stack, agent = make_stack()
        for i in range(4):
            agent.add_host(f"h{i}", generation="v5p", chips=8)
        agent.publish_all()
        for i in range(4):
            stack.cluster.create_pod(gang_pod("pg", i))
        first = stack.queue.pop(timeout=0)
        assert first.pod.name.startswith("pg-")
        stack.cluster.create_pod(
            PodSpec("hp", labels={"tpu/chips": "1", "tpu/priority": "9"})
        )
        batch = stack.scheduler._pop_batch(first)
        assert [q.pod.name for q in batch] == ["pg-0", "pg-1", "pg-2", "pg-3"]
        for q in batch:
            stack.scheduler.schedule_one(q)
        nxt = stack.queue.pop(timeout=0)
        assert nxt is not None and nxt.pod.name == "hp"
        stack.scheduler.schedule_one(nxt)
        assert stack.cluster.get_pod("default/hp").node_name is not None

    def test_partial_gang_does_not_starve_singletons(self):
        clock = FakeClock()
        stack, agent = make_stack(clock, batch_requests=8, gang_permit_timeout_s=300.0)
        for i in range(6):
            agent.add_host(f"h{i}", generation="v5p", chips=8)
        agent.publish_all()
        for i in range(2):
            stack.cluster.create_pod(gang_pod("part", i))
        for i in range(16):
            stack.cluster.create_pod(PodSpec(f"s-{i}", labels={"tpu/chips": "1"}))
        stack.scheduler.run_until_idle(max_wall_s=0.3)
        singles = [p for p in stack.cluster.list_pods() if p.name.startswith("s-")]
        assert all(p.node_name for p in singles), "singletons starved"
        assert stack.gang.gang_status("part") == (4, 2, 0)

    def test_late_member_promotes_parked_siblings(self):
        """Members bounced into timed backoff by a permit-timeout cascade
        are reactivated IMMEDIATELY when a late member arrives: on the
        stack's clock their backoff never ends, so only the gang-arrival
        signal can retry them."""
        clock = FakeClock()
        stack, agent = make_stack(
            clock, gang_permit_timeout_s=0.15, immediate_retry_attempts=0
        )
        for i in range(4):
            agent.add_host(f"h{i}", generation="v5p", chips=4)
        agent.publish_all()
        for i in range(3):
            stack.cluster.create_pod(gang_pod("late", i, chips="4"))
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        expire(stack, clock)
        assert all(p.node_name is None for p in stack.cluster.list_pods())
        assert stack.queue.depths() == (0, 3, 0)  # timed backoff, not ready
        stack.cluster.create_pod(gang_pod("late", 3, chips="4"))
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert all(p.node_name for p in stack.cluster.list_pods()), "gang did not complete"


class TestCrossGangJoint:
    def test_two_gangs_one_dispatch_disjoint_blocks(self):
        stack, agent = make_stack(batch_requests=16)
        for s in range(2):
            agent.add_slice(f"v5p-{s}", generation="v5p", host_topology=(2, 2, 1))
        agent.publish_all()
        yb = stack.batch
        topo = {"tpu/topology": "2x2x1", "tpu/chips": "4"}
        for i in range(4):  # interleave arrivals across the two gangs
            for tag in ("ga", "gb"):
                stack.cluster.create_pod(
                    PodSpec(f"{tag}-{i}", labels={"tpu/gang": tag, **topo})
                )
        stack.scheduler.run_until_idle(max_wall_s=10)
        pods = stack.cluster.list_pods()
        assert all(p.node_name for p in pods)
        hosts = {}
        for tag in ("ga", "gb"):
            hs = {p.node_name for p in pods if p.name.startswith(tag)}
            assert len(hs) == 4
            assert len({h.rsplit("-", 1)[0] for h in hs}) == 1
            hosts[tag] = hs
        assert not (hosts["ga"] & hosts["gb"])
        assert yb.joint_dispatches == 1
        assert yb.dispatch_count == 1
        assert yb.joint_gangs == 2
        assert yb.gang_burst_served == 8
        assert yb.fused_plan_dispatches == 0  # topology gangs: host planner

    def test_unfit_gang_restored_untouched(self):
        stack, agent = make_stack(batch_requests=16)
        agent.add_slice("v5p-0", generation="v5p", host_topology=(2, 2, 1))
        agent.publish_all()
        yb = stack.batch
        topo = {"tpu/topology": "2x2x1", "tpu/chips": "4"}
        for tag in ("win", "lose"):
            for i in range(4):
                stack.cluster.create_pod(
                    PodSpec(f"{tag}-{i}", labels={"tpu/gang": tag, **topo})
                )
        first = stack.queue.pop(timeout=0)
        batch = stack.scheduler._pop_batch(first)
        assert [q.pod.name for q in batch] == [f"win-{i}" for i in range(4)]
        assert yb.joint_parked == 1
        restored = [stack.queue.pop(timeout=0) for _ in range(4)]
        assert {q.pod.name for q in restored} == {f"lose-{i}" for i in range(4)}
        assert all(q.attempts == 1 for q in restored)
        for q in restored:
            stack.queue.restore(q)
        for i in range(4):
            assert stack.accountant.chips_in_use(f"v5p-0-{i}") == 0
        for q in batch:
            stack.scheduler.schedule_one(q)
        stack.scheduler.run_until_idle(max_wall_s=5)
        pods = stack.cluster.list_pods()
        assert all(p.node_name for p in pods if p.name.startswith("win"))
        assert all(p.node_name is None for p in pods if p.name.startswith("lose"))
        assert stack.gang.gang_status("lose") in (None, (4, 0, 0))
        total = sum(stack.accountant.chips_in_use(f"v5p-0-{i}") for i in range(4))
        assert total == 16

    def test_plain_gangs_no_oversubscription(self):
        """Plain gangs through the joint pass: the joint-fit scan (the
        plain version here, the hand kernel on the card) gates the second
        gang, which takes nothing."""
        stack, agent = make_stack(batch_requests=16)
        for i in range(2):
            agent.add_host(f"h{i}", generation="v5p", chips=8)
        agent.publish_all()
        for i in range(4):
            stack.cluster.create_pod(gang_pod("big", i, chips="3"))
        for i in range(4):
            stack.cluster.create_pod(gang_pod("small", i, chips="2"))
        stack.scheduler.run_until_idle(max_wall_s=5)
        pods = stack.cluster.list_pods()
        big = [p for p in pods if p.name.startswith("big") and p.node_name]
        small = [p for p in pods if p.name.startswith("small") and p.node_name]
        assert len(big) == 4
        assert len(small) == 0
        for i in range(2):
            assert stack.accountant.chips_in_use(f"h{i}") <= 8
        assert sum(stack.accountant.chips_in_use(f"h{i}") for i in range(2)) == 12
        assert stack.batch.fused_plan_dispatches >= 1
        assert stack.batch.joint_parked >= 1

    def test_priority_order_between_gangs(self):
        stack, agent = make_stack(batch_requests=16)
        agent.add_slice("v5p-0", generation="v5p", host_topology=(2, 2, 1))
        agent.publish_all()
        topo = {"tpu/topology": "2x2x1", "tpu/chips": "4"}
        for tag, prio in (("lo", "1"), ("hi", "9")):
            for i in range(4):
                stack.cluster.create_pod(
                    PodSpec(
                        f"{tag}-{i}",
                        labels={"tpu/gang": tag, "tpu/priority": prio, **topo},
                    )
                )
        stack.scheduler.run_until_idle(max_wall_s=5)
        pods = stack.cluster.list_pods()
        assert all(p.node_name for p in pods if p.name.startswith("hi"))
        assert all(p.node_name is None for p in pods if p.name.startswith("lo"))

    def test_gather_pulls_still_ticking_backoff_siblings(self):
        now = [0.0]
        q = SchedulingQueue(clock=lambda: now[0], immediate_retry_attempts=0)
        parked = QueuedPodInfo(
            pod=PodSpec("m0", labels={"tpu/gang": "g", "tpu/gang-size": "2"}),
            attempts=3,
        )
        q.add_unschedulable(parked, "no capacity")
        stranger = QueuedPodInfo(pod=PodSpec("o", labels={}), attempts=3)
        q.add_unschedulable(stranger, "no capacity")
        got = q.pop_matching(
            lambda p: gang_name_of(p.labels) == "g", include_backoff=True
        )
        assert [i.pod.name for i in got] == ["m0"]
        assert got[0].attempts == 4
        assert q.pop(timeout=0) is None  # the stranger stays backing off

    def test_bursts_proceed_past_chip_only_parked_members(self):
        clock = FakeClock()
        stack, agent = make_stack(clock, batch_requests=8, gang_permit_timeout_s=300.0)
        for i in range(6):
            agent.add_host(f"h{i}", generation="v5p", chips=8)
        agent.publish_all()
        for i in range(2):
            stack.cluster.create_pod(gang_pod("part", i))
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        assert stack.gang.gang_status("part") == (4, 2, 0)
        yb = stack.batch
        for i in range(16):
            stack.cluster.create_pod(PodSpec(f"s-{i}", labels={"tpu/chips": "1"}))
        stack.scheduler.run_until_idle(max_wall_s=0.3)
        singles = [p for p in stack.cluster.list_pods() if p.name.startswith("s-")]
        assert all(p.node_name for p in singles)
        assert yb.burst_dispatches >= 1
        assert yb.burst_served >= 8
        for i in range(6):
            assert stack.accountant.chips_in_use(f"h{i}") <= 8

    def test_bursts_refused_past_resource_claiming_parked_members(self):
        """A parked member that claims memory not yet visible in the
        snapshot refuses bursts (its claim only admission sees); the
        singletons still bind one dispatch each."""
        clock = FakeClock()
        stack, agent = make_stack(clock, batch_requests=8, gang_permit_timeout_s=300.0)
        for i in range(6):
            agent.add_host(f"h{i}", generation="v5p", chips=8)
        agent.publish_all()
        for i in range(2):
            pod = gang_pod("mem", i)
            pod.memory_request = 1 << 30
            stack.cluster.create_pod(pod)
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        assert stack.gang.gang_status("mem") == (4, 2, 0)
        for i in range(4):
            stack.cluster.create_pod(PodSpec(f"s-{i}", labels={"tpu/chips": "1"}))
        stack.scheduler.run_until_idle(max_wall_s=0.3)
        assert all(
            p.node_name for p in stack.cluster.list_pods() if p.name.startswith("s-")
        )
        assert stack.batch.burst_dispatches == 0


class TestPendingClaims:
    @pytest.mark.parametrize("feed", [True, False], ids=["fed", "unfed"])
    def test_parked_member_claims_steer_later_pods(self, feed):
        """A member parked at Permit is in no snapshot pod list; its memory
        and hostPort claims reach admission only through the pending feed
        (GangPlugin.pending_placements -> YodaPreFilter). With the feed,
        pods that would collide avoid its host; without it they land on
        it, so the feed is what keeps them off."""
        gib = 1 << 30
        stack, agent = make_stack(FakeClock(), gang_permit_timeout_s=300.0)
        if not feed:
            stack.framework.pre_filter_plugins[0].pending_fn = None
        for h in ("h0", "h1"):
            agent.add_host(h, generation="v5p", chips=4)
            stack.cluster.put_node(K8sNode(h, alloc_memory=10 * gib))
        agent.publish_all()
        member = gang_pod("held", 0, size=2, chips="1")
        member.memory_request = 8 * gib
        member.host_ports = ((8080, "TCP", "0.0.0.0"),)
        stack.cluster.create_pod(member)
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        (waiter,) = stack.framework.waiting_pods()
        held = waiter.node_name
        stack.cluster.create_pod(
            PodSpec("port", labels={"tpu/chips": "1"},
                    host_ports=((8080, "TCP", "0.0.0.0"),))
        )
        stack.cluster.create_pod(
            PodSpec("mem", labels={"tpu/chips": "1"}, memory_request=4 * gib)
        )
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        nodes = {n: stack.cluster.get_pod(f"default/{n}").node_name for n in ("port", "mem")}
        if feed:
            assert held not in nodes.values() and all(nodes.values()), nodes
        else:
            assert set(nodes.values()) == {held}, nodes


class TestGangSurfaces:
    def test_install_plan_steers_a_topology_gang(self):
        stack, agent = make_stack()
        agent.add_slice("s-a", host_topology=(2, 2, 1))
        b_hosts = agent.add_slice("s-b", host_topology=(2, 2, 1))
        agent.publish_all()
        pods = topo_pods("steer", "2x2x1", chips=4)
        spec = GangSpec(name="steer", size=4, topology=(2, 2, 1))
        coords = [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
        assert stack.gang.install_plan("steer", spec, dict(zip(b_hosts, coords)))
        assert stack.gang.planned_unassigned_hosts("steer") == sorted(b_hosts)
        for p in pods:
            stack.cluster.create_pod(p)
        stack.scheduler.run_until_idle(max_wall_s=5)
        placed = {stack.cluster.get_pod(p.key).node_name for p in pods}
        assert placed == set(b_hosts)  # the lowest-origin slice was s-a
        assert stack.gang.bound_members("steer") == {
            p.key: stack.cluster.get_pod(p.key).node_name for p in pods
        }

    def test_install_plan_refused_while_members_wait(self):
        stack, agent = make_stack(FakeClock())
        hosts = agent.add_slice("s", host_topology=(2, 2, 1))
        agent.publish_all()
        stack.cluster.create_pod(topo_pods("w", "2x2x1")[0])
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        spec = GangSpec(name="w", size=4, topology=(2, 2, 1))
        assert not stack.gang.install_plan("w", spec, {hosts[0]: (0, 0, 0)})

    def test_drop_membership_and_failed_unbind_restore(self):
        stack, agent = make_stack()
        for i in range(2):
            agent.add_host(f"h{i}", generation="v5p", chips=4)
        agent.publish_all()
        pods = gang_pods("dm", 2)
        for p in pods:
            stack.cluster.create_pod(p)
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.gang.gang_status("dm") == (2, 0, 2)
        member = stack.cluster.get_pod(pods[0].key)
        stack.gang.drop_membership(member)
        assert stack.gang.gang_status("dm") == (2, 0, 1)
        assert pods[0].key not in stack.gang.bound_members("dm")
        stack.gang.on_unbind_failed(stack.framework, member, member.node_name)
        assert stack.gang.gang_status("dm") == (2, 0, 2)
        assert stack.gang.bound_members("dm")[pods[0].key] == member.node_name


class TestQueueGangPrimitives:
    def test_pop_matching_takes_only_matching_in_order(self):
        q = SchedulingQueue()
        q.add(PodSpec("a", labels={"tpu/gang": "g", "tpu/gang-size": "3"}))
        q.add(PodSpec("x", labels={"tpu/chips": "1"}))
        q.add(PodSpec("b", labels={"tpu/gang": "g", "tpu/gang-size": "3"}))
        q.add(PodSpec("y", labels={"tpu/chips": "1"}))
        got = q.pop_matching(lambda p: gang_name_of(p.labels) == "g")
        assert [i.pod.name for i in got] == ["a", "b"]
        assert all(i.attempts == 1 for i in got)
        assert q.pop(timeout=0).pod.name == "x"
        assert q.pop(timeout=0).pod.name == "y"
        assert q.pop(timeout=0) is None

    def test_restore_reverts_attempt_and_requeues(self):
        q = SchedulingQueue()
        q.add(PodSpec("a", labels={}))
        qpi = q.pop(timeout=0)
        assert qpi.attempts == 1
        q.restore(qpi)
        again = q.pop(timeout=0)
        assert again is qpi and again.attempts == 1

    def test_add_promotes_gang_members_past_backoff(self):
        now = [0.0]
        q = SchedulingQueue(clock=lambda: now[0], immediate_retry_attempts=0)
        member = QueuedPodInfo(
            pod=PodSpec("m0", labels={"tpu/gang": "g", "tpu/gang-size": "2"}),
            attempts=3,
        )
        q.add_unschedulable(member, "gang incomplete")
        other = QueuedPodInfo(pod=PodSpec("o", labels={}), attempts=3)
        q.add_unschedulable(other, "no capacity")
        assert q.pop(timeout=0) is None
        q.add(PodSpec("m1", labels={"tpu/gang": "g", "tpu/gang-size": "2"}))
        popped = {q.pop(timeout=0).pod.name, q.pop(timeout=0).pod.name}
        assert popped == {"m0", "m1"}
        assert q.pop(timeout=0) is None

    def test_readd_keeps_attempts_and_pending_gangs_counts(self):
        q = SchedulingQueue()
        labels = {"tpu/gang": "g", "tpu/gang-size": "2"}
        q.add(PodSpec("a", labels=dict(labels)))
        q.add(PodSpec("x", labels={}))
        qpi = q.pop(timeout=0)
        q.readd(qpi)
        assert qpi.attempts == 1
        q.add_unschedulable(QueuedPodInfo(pod=PodSpec("b", labels=dict(labels))))
        assert q.pending_gangs() == {"g": (2, 0)}

    def test_activity_signal_fires_on_arrival_and_removal(self):
        q = SchedulingQueue()
        fired = []
        q.on_activity = lambda: fired.append(1)
        pod = PodSpec("a", labels={})
        q.add(pod)
        q.remove(pod.uid)
        q.move_all_to_active()
        assert len(fired) == 3


# --- stack parity with the JAX package ---

SPECS = {  # generation -> (chips, hbm GiB, clock, bandwidth, tflops, power)
    "v5e": (8, 16, 940, 819, 197, 130),
    "v5p": (4, 95, 1050, 2765, 459, 250),
}
GIB = 1 << 30


def parity_fleet(seed: int):
    """Plain-dict hosts: v5p slices with 2x2x1 and 2x2x2 host grids, v5e
    hosts in pools a/b, random cordons and chip health."""
    rng = np.random.default_rng(seed)
    hosts = []

    def host(name, gen, slice_id="", coords=(0, 0, 0)):
        chips, hbm, clock, bw, tf, pw = SPECS[gen]
        rows = [
            dict(
                index=c,
                health="Unhealthy" if rng.random() < 0.03 else "Healthy",
                hbm_free=hbm * GIB,
                hbm_total=hbm * GIB,
                clock_mhz=int(clock - rng.integers(0, 60)),
                hbm_bandwidth_gbps=bw,
                tflops_bf16=tf,
                power_w=pw,
            )
            for c in range(chips)
        ]
        hosts.append(
            dict(
                name=name, generation=gen, slice_id=slice_id, coords=coords,
                chips=rows, cordoned=rng.random() < 0.05,
                pool="a" if rng.random() < 0.5 else "b",
            )
        )

    for s, shape in enumerate([(2, 2, 1)] * 5 + [(2, 2, 2)] * 2):
        for i, c in enumerate(itertools.product(*(range(d) for d in shape))):
            host(f"p{s}-{i}", "v5p", f"p{s}", c)
    for i in range(16):
        host(f"e{i:02d}", "v5e")
    return hosts


def parity_script(seed: int, kinds=("plain", "topo", "multi", "cosched", "plain")):
    """Two waves of pods: [(name, labels, pool or None)] each. Gangs of the
    given kinds are interleaved with each other and with singletons."""
    rng = np.random.default_rng(seed)
    waves = []
    for wave in range(2):
        members = []
        for g in range(int(rng.integers(2, 5))):
            kind = rng.choice(list(kinds))
            name = f"w{wave}{kind[0]}{g}"
            pool = str(rng.choice(["a", "b"])) if rng.random() < 0.3 else None
            if kind == "plain":
                size = int(rng.integers(2, 13))
                labels = {"tpu/gang": name, "tpu/gang-size": str(size),
                          "tpu/chips": str(int(rng.choice([2, 4, 8])))}
                if rng.random() < 0.5:
                    labels["tpu/generation"] = "v5e"
            elif kind == "topo":
                topo = "2x2x2" if rng.random() < 0.3 else "2x2x1"
                size = math.prod(int(d) for d in topo.split("x"))
                labels = {"tpu/gang": name, "tpu/topology": topo, "tpu/chips": "4"}
                pool = None
            elif kind == "multi":
                size = 8
                labels = {"tpu/gang": name, "tpu/topology": "2x2x1",
                          "tpu/multislice": "2", "tpu/chips": "4"}
                pool = None
            else:
                size = int(rng.integers(2, 5))
                labels = {"pod-group.scheduling.sigs.k8s.io/name": name,
                          "pod-group.scheduling.sigs.k8s.io/min-available": str(size),
                          "tpu/chips": str(int(rng.choice([1, 2])))}
            if rng.random() < 0.2:
                labels["tpu/priority"] = str(int(rng.integers(0, 3)))
            members += [(f"{name}-{i}", dict(labels), pool) for i in range(size)]
        singles = [
            (f"w{wave}s{j}", {"tpu/chips": str(int(rng.choice([1, 2, 4])))},
             str(rng.choice(["a", "b"])) if rng.random() < 0.2 else None)
            for j in range(int(rng.integers(4, 12)))
        ]
        pods = members + singles
        order = rng.permutation(len(pods))  # scattered, co-queued arrival
        waves.append([pods[i] for i in order])
    return waves


def publish(types, cluster, hosts) -> None:
    for h in hosts:
        cluster.put_node(
            types.K8sNode(name=h["name"], unschedulable=h["cordoned"],
                          labels={"pool": h["pool"]})
        )
        cluster.put_tpu_metrics(
            types.TpuNodeMetrics(
                name=h["name"], generation=h["generation"], slice_id=h["slice_id"],
                topology_coords=h["coords"], last_updated_unix=time.time(),
                chips=[types.TpuChip(**c) for c in h["chips"]],
            )
        )


def run_waves(types, stack, hosts, waves) -> dict:
    publish(types, stack.cluster, hosts)
    for wave in waves:
        for name, labels, pool in wave:
            stack.cluster.create_pod(
                types.PodSpec(name, labels=labels,
                              node_selector={"pool": pool} if pool else {})
            )
        stack.scheduler.run_until_idle(max_wall_s=10)
    out = {}
    for wave in waves:
        for name, _, _ in wave:
            pod = stack.cluster.get_pod(f"default/{name}")
            out[name] = pod.node_name if pod is not None else "evicted"
    return out


GANG_COUNTERS = (
    "dispatch_count", "burst_dispatches", "burst_served",
    "gang_burst_dispatches", "gang_burst_served", "gang_burst_invalidated",
    "joint_dispatches", "joint_gangs", "joint_parked", "fused_plan_dispatches",
    "plan_served", "plan_invalidated",
)


class TestGangStackParity:
    # Seeds 0-2 mix all four gang kinds (joint passes with topology gangs
    # take the host block planner); seeds 3-4 hold plain and coscheduling
    # gangs only, so their joint passes run the joint-fit scan and contend
    # at its gate.
    @pytest.mark.parametrize("preemption", [False, True])
    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
    @pytest.mark.parametrize("batch_requests", [1, 16])
    def test_same_bindings_verdicts_and_counters(self, seed, batch_requests, preemption):
        hosts = parity_fleet(seed)
        waves = (
            parity_script(seed, ("plain", "cosched", "plain"))
            if seed >= 3
            else parity_script(seed)
        )
        ref_clock, port_clock = FakeClock(), FakeClock()
        ref = ref_build_stack(
            config=RefConfig(
                kernel_platform="cpu", batch_requests=batch_requests,
                enable_preemption=preemption,
            ),
            clock=ref_clock,
        )
        want = run_waves(ref_types, ref, hosts, waves)
        port, _agent = make_stack(
            port_clock, batch_requests=batch_requests, enable_preemption=preemption
        )
        got = run_waves(port_types, port, hosts, waves)
        assert got == want
        (ref_batch,) = ref.framework.batch_plugins
        assert {c: getattr(port.batch, c) for c in GANG_COUNTERS} == {
            c: getattr(ref_batch, c) for c in GANG_COUNTERS
        }
        assert port.batch.dispatch_errors == 0
        if preemption:
            assert port.preemption.preempted_total == ref.preemption.preempted_total
            assert (port.scheduler.stats.preempt_nominations
                    == ref.scheduler.stats.preempt_nominations)
        # Every gang is all-or-nothing (an evicted member aside: a victim
        # set may take part of a lower-priority gang), the same ones bind
        # in both, and both outcomes occur.
        by_gang: dict[str, list] = {}
        for name, node in got.items():
            if "s" not in name.split("-")[0][2:3] and node != "evicted":
                by_gang.setdefault(name.rsplit("-", 1)[0], []).append(node)
        verdicts = {g: all(v) for g, v in by_gang.items()}
        for g, nodes in by_gang.items():
            assert all(nodes) or not any(nodes), (g, nodes)
        assert any(verdicts.values())
        for g in by_gang:
            assert port.gang.gang_status(g) == ref.gang.gang_status(g)
        assert port.framework.waiting_pods() == []
        for h in hosts:
            healthy = sum(c["health"] == "Healthy" for c in h["chips"])
            assert port.accountant.chips_in_use(h["name"]) <= healthy
