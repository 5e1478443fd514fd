"""Scheduling Events (the Event recorder and the stack's wiring), held
against yoda_tpu.

Every case of ``tests/test_events.py`` that needs no unported part runs on
both packages from the reference's own source
(``torch_refcases.run_case``), with its exact assertions. None is left
out: ``TestWireEvents`` (three cases) runs ``KubeCluster.write_event``
over real HTTP against each package's own fake API server.

Beside them: a default stack (``kernel_platform: cpu``, ``bind_workers``
0) with one 4-chip v5e host, a 2-chip pod and a 64-chip pod writes
``[("FailedScheduling", "big"), ("Scheduled", "ok")]`` in both packages;
and one drive that makes all four reasons (Scheduled, FailedScheduling,
Preempted, GangRollback) writes the same Events with the same counts in
both packages.
"""

from __future__ import annotations

import pytest
from torch_refcases import PACKAGES, cases, run_case

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.types as ref_types
import yoda_tpu.config as ref_config
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent as port_agent
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.standalone as port_standalone

REF = "test_events.py"
SKIP: "dict[str, str]" = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


SIDES = {
    "yoda_tpu": (ref_standalone, ref_config, ref_agent, ref_types),
    "yoda_tpu_torch": (port_standalone, port_config, port_agent, port_types),
}


class SteppedClock:
    """A scheduling clock that moves only when the drive advances it, so
    both packages take the same backoff and Permit decisions."""

    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


def event_rows(stack) -> list:
    assert stack.events.flush()
    return sorted(
        (e["reason"], e["involvedObject"]["name"], e["count"])
        for e in stack.cluster.list_events()
    )


def default_stack_drive(pkg: str) -> list:
    """The default stack on the CPU with inline binds: one 4-chip v5e host,
    a pod that fits and one that never can."""
    standalone, config, agent_mod, types = SIDES[pkg]
    stack = standalone.build_stack(
        config=config.SchedulerConfig(kernel_platform="cpu", bind_workers=0)
    )
    agent = agent_mod.FakeTpuAgent(stack.cluster)
    agent.add_host("h0", generation="v5e", chips=4)
    agent.publish_all()
    stack.cluster.create_pod(types.PodSpec("ok", labels={"tpu/chips": "2"}))
    stack.cluster.create_pod(types.PodSpec("big", labels={"tpu/chips": "64"}))
    stack.scheduler.run_until_idle(max_wall_s=10)
    rows = [(reason, pod) for reason, pod, _count in event_rows(stack)]
    stack.events.close()
    return rows


def four_reasons_drive(pkg: str) -> dict:
    """One stack, every reason: two low-priority pods fill two hosts and a
    higher-priority one preempts one of them (Preempted on the victim,
    FailedScheduling then Scheduled on the preemptor); a pod no host can
    hold (FailedScheduling, again after a republish); then three more
    hosts, two of a three-member gang park at Permit and one waiting
    member's host dies (GangRollback on both)."""
    standalone, config, agent_mod, types = SIDES[pkg]
    stack = standalone.build_stack(
        config=config.SchedulerConfig(
            kernel_platform="cpu", bind_workers=0, gang_permit_timeout_s=300.0
        ),
        clock=SteppedClock(),
    )
    agent = agent_mod.FakeTpuAgent(stack.cluster)
    pod = types.PodSpec
    for i in range(2):
        agent.add_host(f"h{i}", generation="v5e", chips=4)
    agent.publish_all()
    for i in range(2):
        stack.cluster.create_pod(
            pod(f"low-{i}", labels={"tpu/chips": "4", "tpu/priority": "1"})
        )
    stack.scheduler.run_until_idle(max_wall_s=10)
    agent.publish_all()
    stack.cluster.create_pod(
        pod("vip", labels={"tpu/chips": "4", "tpu/priority": "9"})
    )
    stack.cluster.create_pod(pod("greedy", labels={"tpu/chips": "16"}))
    stack.scheduler.run_until_idle(max_wall_s=10)
    agent.publish_all()
    stack.scheduler.run_until_idle(max_wall_s=10)
    for i in range(2, 5):
        agent.add_host(f"h{i}", generation="v5e", chips=4)
    agent.publish_all()
    labels = {"tpu/gang": "g", "tpu/gang-size": "3", "tpu/chips": "4"}
    for i in range(2):
        stack.cluster.create_pod(pod(f"g-{i}", labels=dict(labels)))
    stack.scheduler.run_until_idle(max_wall_s=1.0)
    parked = sorted((w.pod.name, w.node_name) for w in stack.framework.waiting_pods())
    agent.remove_host(parked[0][1])
    stack.scheduler.run_until_idle(max_wall_s=1.0)
    out = {
        "events": event_rows(stack),
        "parked": parked,
        "bindings": sorted((p.name, p.node_name) for p in stack.cluster.list_pods()),
        "dropped": stack.events.dropped_total,
    }
    stack.events.close()
    return out


class TestStackEventsEqual:
    def test_default_stack_writes_the_same_events(self):
        """With default settings both packages record the scheduler's
        Events: the pod that fits is Scheduled, the pod no host holds
        FailedScheduling."""
        want = [("FailedScheduling", "big"), ("Scheduled", "ok")]
        assert default_stack_drive("yoda_tpu") == want
        assert default_stack_drive("yoda_tpu_torch") == want

    def test_every_reason_with_the_same_counts(self):
        ref = four_reasons_drive("yoda_tpu")
        port = four_reasons_drive("yoda_tpu_torch")
        assert port == ref
        reasons = {row[0] for row in port["events"]}
        assert reasons == {"Scheduled", "FailedScheduling", "Preempted", "GangRollback"}
        assert len(port["parked"]) == 2
        rollbacks = {row[1] for row in port["events"] if row[0] == "GangRollback"}
        assert rollbacks == {"g-0", "g-1"}
        assert [r for r in port["events"] if r[0] == "Preempted"] in (
            [("Preempted", "low-0", 1)], [("Preempted", "low-1", 1)]
        )
        assert port["dropped"] == 0
