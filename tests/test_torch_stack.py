"""The port's whole singleton path on the CPU: stack-level parity with
``yoda_tpu.standalone.build_stack``, and port-side copies of the singleton
cases of tests/test_e2e.py (BASELINE configs 1-4).

Parity: one seeded fleet of mixed v5e/v5p hosts (random chip health, HBM
already in use, cordons, taints, node labels) and one script of singleton
pods go through both stacks; every pod must land on the same node (or stay
pending in both), with equal dispatch and burst counters. The reference
runs with the default-on subsystems the port lacks switched off where they
could change a binding (preemption, the speculative placement cache)."""

import dataclasses
import time

import numpy as np
import pytest

import yoda_tpu.api.types as ref_types
import yoda_tpu_torch.api.types as port_types
from yoda_tpu.config import SchedulerConfig as RefConfig
from yoda_tpu.standalone import build_stack as ref_build_stack
from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.config import SchedulerConfig
from yoda_tpu_torch.standalone import build_stack

GIB = 1 << 30
SPECS = {  # generation -> (chips, hbm GiB, clock, bandwidth, tflops, power)
    "v5e": (8, 16, 940, 819, 197, 130),
    "v5p": (4, 95, 1050, 2765, 459, 250),
}


def fleet_script(seed: int, n_hosts: int = 48, n_pods: int = 40):
    """(hosts, pods) as plain dicts, shared by both packages."""
    rng = np.random.default_rng(seed)
    hosts = []
    for i in range(n_hosts):
        gen = "v5p" if i % 3 == 0 else "v5e"
        chips, hbm, clock, bw, tf, pw = SPECS[gen]
        chip_rows = []
        for c in range(chips):
            total = hbm * GIB
            used = rng.random() < 0.15
            free = total - int(rng.integers(1, hbm)) * GIB if used else total
            chip_rows.append(
                dict(
                    index=c,
                    health="Unhealthy" if rng.random() < 0.08 else "Healthy",
                    hbm_free=free,
                    hbm_total=total,
                    clock_mhz=int(clock - rng.integers(0, 80)),
                    hbm_bandwidth_gbps=bw,
                    tflops_bf16=tf,
                    power_w=pw,
                )
            )
        hosts.append(
            dict(
                name=f"host-{i:02d}",
                generation=gen,
                slice_id=f"slice-{i // 4}" if gen == "v5p" and i % 2 else "",
                chips=chip_rows,
                cordoned=rng.random() < 0.06,
                soft_taint=rng.random() < 0.1,
                pool="a" if rng.random() < 0.5 else "b",
            )
        )
    pods = []
    for j in range(n_pods):
        labels = {"tpu/chips": str(int(rng.choice([1, 1, 2, 2, 4, 8])))}
        if rng.random() < 0.6:
            labels["tpu/hbm"] = f"{int(rng.integers(1, 12))}Gi"
        if rng.random() < 0.3:
            labels["tpu/clock"] = str(int(rng.choice([900, 960, 1000])))
        if rng.random() < 0.3:
            labels["tpu/generation"] = str(rng.choice(["v5e", "v5p"]))
        if rng.random() < 0.2:
            labels["tpu/priority"] = str(int(rng.integers(0, 3)))
        pods.append(
            dict(
                name=f"pod-{j:02d}",
                labels=labels,
                pool=str(rng.choice(["a", "b"])) if rng.random() < 0.15 else None,
            )
        )
    return hosts, pods


def publish(types, cluster, hosts, now: float) -> None:
    for h in hosts:
        cluster.put_node(
            types.K8sNode(
                name=h["name"],
                unschedulable=h["cordoned"],
                taints=(
                    [types.Taint("maintenance", "soon", "PreferNoSchedule")]
                    if h["soft_taint"]
                    else []
                ),
                labels={"pool": h["pool"]},
            )
        )
        cluster.put_tpu_metrics(
            types.TpuNodeMetrics(
                name=h["name"],
                generation=h["generation"],
                slice_id=h["slice_id"],
                last_updated_unix=now,
                chips=[types.TpuChip(**c) for c in h["chips"]],
            )
        )


def run_script(types, stack, hosts, pods) -> dict:
    publish(types, stack.cluster, hosts, time.time())
    for p in pods:
        stack.cluster.create_pod(
            types.PodSpec(
                p["name"],
                labels=dict(p["labels"]),
                node_selector={"pool": p["pool"]} if p["pool"] else {},
            )
        )
    stack.scheduler.run_until_idle(max_wall_s=60)
    return {
        p["name"]: stack.cluster.get_pod(f"default/{p['name']}").node_name
        for p in pods
    }


def counters(batch) -> tuple:
    return (
        batch.dispatch_count,
        batch.burst_dispatches,
        batch.burst_served,
        batch.burst_invalidated,
    )


class TestStackParity:
    @pytest.mark.parametrize("batch_requests", [1, 8])
    @pytest.mark.parametrize("strategy", ["least-allocated", "most-allocated"])
    def test_same_bindings_and_counters(self, batch_requests, strategy):
        hosts, pods = fleet_script(seed=batch_requests)
        knobs = dict(batch_requests=batch_requests, scoring_strategy=strategy)
        ref = ref_build_stack(
            config=RefConfig(
                kernel_platform="cpu",
                enable_preemption=False,
                spec_enabled=False,
                **knobs,
            )
        )
        want = run_script(ref_types, ref, hosts, pods)
        port = build_stack(config=SchedulerConfig(kernel_platform="cpu", **knobs))
        got = run_script(port_types, port, hosts, pods)
        assert got == want
        # The script exercises both outcomes.
        assert 0 < sum(v is not None for v in got.values()) < len(pods)
        (ref_batch,) = ref.framework.batch_plugins
        assert counters(port.batch) == counters(ref_batch)
        if batch_requests > 1:
            assert port.batch.burst_served > 0
        assert port.batch.dispatch_errors == 0
        for h in hosts:
            healthy = sum(c["health"] == "Healthy" for c in h["chips"])
            assert port.accountant.chips_in_use(h["name"]) <= healthy


def make_stack(**cfg):
    stack = build_stack(config=SchedulerConfig(kernel_platform="cpu", **cfg))
    return stack, FakeTpuAgent(stack.cluster)


# The singleton cases of tests/test_e2e.py, batch mode, on the port — at
# one pod per dispatch and with multi-pod bursts.
@pytest.mark.parametrize("burst", [1, 8])
class TestBaselineConfigs:
    def test_single_pod_single_node(self, burst):
        # Config 1: a pod requesting per-chip memory lands on the only node.
        stack, agent = make_stack(batch_requests=burst)
        agent.add_host("kind-node", generation="v5e", chips=8)
        agent.publish_all()
        stack.cluster.create_pod(PodSpec("test-pod", labels={"tpu/hbm": "1000"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        pod = stack.cluster.get_pod("default/test-pod")
        assert pod.node_name == "kind-node"
        assert pod.phase == "Running"

    def test_single_jax_pod_one_chip(self, burst):
        # Config 2: tpu/chips=1 on a v5e-1 node.
        stack, agent = make_stack(batch_requests=burst)
        agent.add_host("v5e-1-node", generation="v5e", chips=1)
        agent.publish_all()
        stack.cluster.create_pod(PodSpec("jax-pod", labels={"tpu/chips": "1"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.cluster.get_pod("default/jax-pod").node_name == "v5e-1-node"

    def test_pod_created_before_scheduler_sees_node(self, burst):
        stack, agent = make_stack(batch_requests=burst)
        stack.cluster.create_pod(PodSpec("early", labels={"tpu/chips": "1"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.cluster.get_pod("default/early").node_name is None
        agent.add_host("late-node", generation="v5e")
        agent.publish_all()
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.cluster.get_pod("default/early").node_name == "late-node"

    def test_four_pods_pack_one_host(self, burst):
        # Config 3: 4 pods x 2 chips onto one v5e-8 host.
        stack, agent = make_stack(batch_requests=burst)
        agent.add_host("v5e-8-host", generation="v5e", chips=8)
        agent.publish_all()
        for i in range(4):
            stack.cluster.create_pod(
                PodSpec(f"worker-{i}", labels={"tpu/chips": "2", "tpu/hbm": "8Gi"})
            )
        stack.scheduler.run_until_idle(max_wall_s=5)
        for i in range(4):
            assert stack.cluster.get_pod(f"default/worker-{i}").node_name == "v5e-8-host"
        assert stack.accountant.chips_in_use("v5e-8-host") == 8

    def test_fifth_pod_does_not_overcommit(self, burst):
        stack, agent = make_stack(batch_requests=burst)
        agent.add_host("host", generation="v5e", chips=8)
        agent.publish_all()
        for i in range(5):
            stack.cluster.create_pod(PodSpec(f"w-{i}", labels={"tpu/chips": "2"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        bound = [p for p in stack.cluster.list_pods() if p.node_name]
        assert len(bound) == 4
        assert stack.accountant.chips_in_use("host") == 8

    def test_chips_free_after_pod_delete(self, burst):
        stack, agent = make_stack(batch_requests=burst)
        agent.add_host("host", generation="v5e", chips=2)
        agent.publish_all()
        stack.cluster.create_pod(PodSpec("a", labels={"tpu/chips": "2"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        stack.cluster.create_pod(PodSpec("b", labels={"tpu/chips": "2"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.cluster.get_pod("default/b").node_name is None  # full
        stack.cluster.delete_pod("default/a")  # frees chips + triggers retry
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.cluster.get_pod("default/b").node_name == "host"

    def test_spreads_by_free_capacity(self, burst):
        stack, agent = make_stack(batch_requests=burst)
        agent.add_host("host-a", generation="v5e", chips=8)
        agent.add_host("host-b", generation="v5e", chips=8)
        agent.publish_all()
        stack.cluster.create_pod(PodSpec("p0", labels={"tpu/chips": "4", "tpu/hbm": "8Gi"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        first = stack.cluster.get_pod("default/p0").node_name
        agent.publish_all()
        stack.cluster.create_pod(PodSpec("p1", labels={"tpu/chips": "4", "tpu/hbm": "8Gi"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        second = stack.cluster.get_pod("default/p1").node_name
        assert {first, second} == {"host-a", "host-b"}

    def test_no_double_count_after_agent_refresh(self, burst):
        stack, agent = make_stack(batch_requests=burst)
        agent.add_host("host", generation="v5e", chips=8)
        agent.publish_all()
        stack.cluster.create_pod(PodSpec("a", labels={"tpu/chips": "4", "tpu/hbm": "16Gi"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        agent.publish_all()  # A's consumption now visible
        stack.cluster.create_pod(PodSpec("b", labels={"tpu/chips": "4", "tpu/hbm": "16Gi"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.cluster.get_pod("default/b").node_name == "host"

    def test_stale_node_rejected_even_with_cached_arrays(self, burst):
        stack, agent = make_stack(batch_requests=burst, max_metrics_age_s=0.2)
        agent.add_host("host", generation="v5e", chips=8)
        agent.publish_all()
        stack.cluster.create_pod(PodSpec("fresh-pod", labels={"tpu/chips": "1"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.cluster.get_pod("default/fresh-pod").node_name == "host"
        time.sleep(0.3)  # agent goes silent; metrics now stale
        stack.cluster.create_pod(PodSpec("late-pod", labels={"tpu/chips": "1"}))
        stack.scheduler.run_until_idle(max_wall_s=1)
        assert stack.cluster.get_pod("default/late-pod").node_name is None
        agent.publish_all()  # a relevant refresh reactivates the parked pod
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.cluster.get_pod("default/late-pod").node_name == "host"

    def test_foreign_non_tpu_pod_holds_no_chips(self, burst):
        stack, agent = make_stack(batch_requests=burst)
        agent.add_host("host", generation="v5e", chips=2)
        agent.publish_all()
        daemon = PodSpec("kube-proxy", scheduler_name="default-scheduler")
        daemon.node_name = "host"
        stack.cluster.create_pod(daemon)
        assert stack.accountant.chips_in_use("host") == 0
        stack.cluster.create_pod(PodSpec("p", labels={"tpu/chips": "2"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.cluster.get_pod("default/p").node_name == "host"

    def test_accounting_rebuilt_from_bound_pods(self, burst):
        stack, agent = make_stack(batch_requests=burst)
        agent.add_host("host", generation="v5e", chips=8)
        agent.publish_all()
        for i in range(3):
            stack.cluster.create_pod(PodSpec(f"w-{i}", labels={"tpu/chips": "2"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.accountant.chips_in_use("host") == 6
        stack2 = build_stack(
            cluster=stack.cluster,
            config=SchedulerConfig(kernel_platform="cpu", batch_requests=burst),
        )
        assert stack2.accountant.chips_in_use("host") == 6
        stack2.cluster.create_pod(PodSpec("late", labels={"tpu/chips": "4"}))
        stack2.scheduler.run_until_idle(max_wall_s=5)
        assert stack2.cluster.get_pod("default/late").node_name is None

    def test_unhealthy_chips_reduce_capacity(self, burst):
        stack, agent = make_stack(batch_requests=burst)
        agent.add_host("host", generation="v5e", chips=4)
        agent.set_chip_health("host", 0, False)
        agent.publish_all()
        stack.cluster.create_pod(PodSpec("p", labels={"tpu/chips": "4"}))
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.cluster.get_pod("default/p").node_name is None
        agent.set_chip_health("host", 0, True)
        agent.publish_all()
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.cluster.get_pod("default/p").node_name == "host"

    def test_most_allocated_packs_one_host(self, burst):
        stack, agent = make_stack(
            batch_requests=burst, scoring_strategy="most-allocated"
        )
        for h in ("pack-0", "pack-1"):
            agent.add_host(h, generation="v5e", chips=8)
        agent.publish_all()
        for i in range(3):
            stack.cluster.create_pod(
                PodSpec(f"p{i}", labels={"tpu/chips": "2", "tpu/hbm": "1Gi"})
            )
        stack.scheduler.run_until_idle(max_wall_s=10)
        hosts = {stack.cluster.get_pod(f"default/p{i}").node_name for i in range(3)}
        assert len(hosts) == 1, hosts

    def test_most_allocated_still_respects_capacity(self, burst):
        stack, agent = make_stack(
            batch_requests=burst, scoring_strategy="most-allocated"
        )
        for h in ("full-0", "full-1"):
            agent.add_host(h, generation="v5e", chips=4)
        agent.publish_all()
        for i in range(3):
            stack.cluster.create_pod(PodSpec(f"p{i}", labels={"tpu/chips": "2"}))
        stack.scheduler.run_until_idle(max_wall_s=10)
        placements = [
            stack.cluster.get_pod(f"default/p{i}").node_name for i in range(3)
        ]
        assert all(placements)
        assert sorted(placements.count(h) for h in set(placements)) == [1, 2]


def test_scheduling_gates_hold_until_cleared():
    stack, agent = make_stack()
    agent.add_host("host", generation="v5e", chips=8)
    agent.publish_all()
    labels = {"tpu/chips": "1"}
    stack.cluster.create_pod(PodSpec("gated", labels=labels, scheduling_gates=("quota",)))
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert stack.cluster.get_pod("default/gated").node_name is None
    assert len(stack.queue) == 0  # held out of the queue, not parked in it
    stack.cluster.update_pod(PodSpec("gated", labels=labels))  # gate cleared
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert stack.cluster.get_pod("default/gated").node_name == "host"


def test_pod_deleted_while_queued_is_dropped():
    stack, agent = make_stack()
    agent.add_host("host", generation="v5e", chips=8)
    agent.publish_all()
    stack.cluster.create_pod(PodSpec("doomed", labels={"tpu/chips": "1"}))
    stack.cluster.delete_pod("default/doomed")
    stack.scheduler.run_until_idle(max_wall_s=5)
    assert len(stack.queue) == 0
    assert stack.batch.dispatch_count == 0
    assert stack.accountant.chips_in_use("host") == 0


def test_fleet_arrays_from_numpy_round_trip():
    """The reference's fleet state, as numpy, becomes the port's FleetArrays
    field for field."""
    from yoda_tpu.ops.arrays import FleetArrays as RefArrays
    from yoda_tpu_torch.ops.arrays import FleetArrays as PortArrays

    ref = ref_build_stack(config=RefConfig(kernel_platform="cpu"))
    hosts, _ = fleet_script(seed=3, n_hosts=6)
    publish(ref_types, ref.cluster, hosts, 1000.0)
    arrays = RefArrays.from_snapshot(ref.informer.snapshot(), now=1000.0)
    port = PortArrays.from_numpy(vars(arrays))
    for f in dataclasses.fields(RefArrays):
        np.testing.assert_array_equal(
            np.asarray(getattr(port, f.name)), np.asarray(getattr(arrays, f.name))
        )
