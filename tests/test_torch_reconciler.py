"""The port's reconciler (yoda_tpu_torch/framework/reconciler.py: the
warm-start resync and the periodic drift pass) held against the JAX
package's on the CPU, tolerance 0.

Every case of tests/test_failover.py that needs only ported parts runs as
one script on both packages (``kernel_platform: cpu``) and the two runs
must agree on the ResyncReport and DriftReport fields (less their wall
time), every binding, the accounting, the waiting pods and the adoption
deadlines. The dead leader of the mid-gang cases is a cluster populated
before the stack is built — members already bound, others pending — which
is the state a crash leaves and the stack's list-then-watch replay reads.
Left out: the chaos-driven crash cases (the chaos harness, the bind
pipeline and ``serve_forever`` are not ported), the dead-leader write
refusal (a chaos-cluster property) and the readiness endpoint cases (no
metrics server in the port); the metrics-registry assertions (no registry
in the port). Every case of that file, those left out here included, also
runs whole on both packages from its own source in
test_torch_parity_failover.py."""

import dataclasses
import threading
import time
from types import SimpleNamespace

import pytest

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.types as ref_types
import yoda_tpu.cluster.fake as ref_fake
import yoda_tpu.config as ref_config
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent.fake_publisher as port_agent
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.cluster.fake as port_fake
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.standalone as port_standalone

REF = SimpleNamespace(
    name="ref", types=ref_types, fake=ref_fake, Agent=ref_agent.FakeTpuAgent,
    Config=ref_config.SchedulerConfig, build_stack=ref_standalone.build_stack,
)
PORT = SimpleNamespace(
    name="port", types=port_types, fake=port_fake, Agent=port_agent.FakeTpuAgent,
    Config=port_config.SchedulerConfig, build_stack=port_standalone.build_stack,
)


def both(case, *args):
    """Runs ``case(side, *args)`` on the reference and on the port; their
    observations must be equal. Returns the port's."""
    want = case(REF, *args)
    got = case(PORT, *args)
    assert got == want
    return got


def gang_pods(side, name, n, chips=4):
    labels = {"tpu/gang": name, "tpu/gang-size": str(n), "tpu/chips": str(chips)}
    return [side.types.PodSpec(f"{name}-{i}", labels=dict(labels)) for i in range(n)]


def solo(side, name, chips):
    return side.types.PodSpec(name, labels={"tpu/chips": str(chips)})


def fleet(side, cluster, hosts=4, chips=4):
    agent = side.Agent(cluster)
    for i in range(hosts):
        agent.add_host(f"host-{i}", generation="v5p", chips=chips)
    agent.publish_all()
    return agent


def make_stack(side, hosts=4, chips=4, cluster=None, clock=None, **cfg):
    kw = {"clock": clock} if clock is not None else {}
    stack = side.build_stack(
        cluster=cluster, config=side.Config(kernel_platform="cpu", **cfg), **kw
    )
    if cluster is None:
        fleet(side, stack.cluster, hosts, chips)
    return stack


def bound_pod(pod, node):
    pod.node_name = node
    pod.phase = "Running"
    return pod


def view(report) -> dict:
    out = dataclasses.asdict(report)
    out.pop("duration_ms", None)
    return out


def bound_names(stack):
    return {p.name: p.node_name for p in stack.cluster.list_pods() if p.node_name}


def consistent(stack) -> dict:
    """The standing failover invariants — accounting equals cluster truth
    and no node holds more chips than it has — and the accounting itself."""
    expected: dict[str, int] = {}
    for p in stack.cluster.list_pods():
        if p.node_name:
            expected[p.node_name] = expected.get(p.node_name, 0) + int(
                p.labels.get("tpu/chips", "1")
            )
    actual = {n: c for n, c in stack.accountant.chips_by_node().items() if c}
    assert actual == expected, (actual, expected)
    for ni in stack.informer.snapshot().infos():
        cap = len(ni.tpu.chips) if ni.tpu else 0
        assert stack.accountant.chips_in_use(ni.name) <= cap
    return actual


# --- the warm-start resync ---


def resync_noop(side):
    stack = make_stack(side)
    stack.cluster.create_pod(solo(side, "solo", 2))
    stack.scheduler.run_until_idle(max_wall_s=5)
    report = stack.reconciler.resync()
    assert report.adopted_gangs == [] and report.rolled_back_gangs == []
    assert report.rebuilt_reservations == 0 and report.released_reservations == 0
    assert stack.reconciler.resynced.is_set()
    return view(report), consistent(stack)


def resync_dropped_bind(side):
    stack = make_stack(side)
    stack.cluster.suppress_kinds.add("Pod")
    ghost = bound_pod(solo(side, "ghost", 2), "host-0")
    stack.cluster.create_pod(ghost)
    stack.cluster.suppress_kinds.clear()
    assert stack.accountant.chips_in_use("host-0") == 0
    report = stack.reconciler.resync()
    assert report.rebuilt_reservations == 1
    assert stack.accountant.chips_in_use("host-0") == 2
    assert stack.informer.counts_bound(ghost.uid)
    return view(report), consistent(stack)


def resync_phantom_claim(side):
    stack = make_stack(side)
    phantom = bound_pod(solo(side, "phantom", 4), "host-1")
    stack.accountant.handle(side.fake.Event("modified", "Pod", phantom))
    assert stack.accountant.chips_in_use("host-1") == 4
    report = stack.reconciler.resync()
    assert report.released_reservations == 1
    assert stack.accountant.chips_in_use("host-1") == 0
    return view(report)


def dead_leader_cluster(side, bound=2, members=4, lost_host=False):
    """What a leader that died mid-gang leaves: ``bound`` members bound,
    the rest pending; with ``lost_host`` one bound member's host has no
    TPU metrics any more."""
    cluster = side.fake.FakeCluster()
    fleet(side, cluster)
    for i, p in enumerate(gang_pods(side, "g", members)):
        if i < bound:
            bound_pod(p, f"host-{i}")
        cluster.create_pod(p)
    if lost_host:
        cluster.delete_tpu_metrics("host-0")
    return cluster


def adopt_completes_whole(side):
    stack = make_stack(side, cluster=dead_leader_cluster(side))
    report = stack.reconciler.resync()
    assert report.adopted_gangs == ["g"] and report.rolled_back_gangs == []
    stack.scheduler.run_until_idle(max_wall_s=20)
    assert sorted(bound_names(stack)) == [f"g-{i}" for i in range(4)]
    return view(report), bound_names(stack), consistent(stack)


def rollback_policy(side):
    stack = make_stack(side, cluster=dead_leader_cluster(side, bound=1),
                       failover_adopt_window_s=0)
    report = stack.reconciler.resync()
    assert report.adopted_gangs == [] and report.rolled_back_gangs == ["g"]
    after = consistent(stack)
    stack.scheduler.run_until_idle(max_wall_s=20)
    assert sorted(bound_names(stack)) == [f"g-{i}" for i in range(4)]
    return view(report), after, bound_names(stack), consistent(stack)


def rollback_lost_host(side):
    stack = make_stack(side, cluster=dead_leader_cluster(side, lost_host=True))
    report = stack.reconciler.resync()
    assert report.rolled_back_gangs == ["g"]
    return view(report), bound_names(stack), stack.binder.unbinds


RESYNC = {f.__name__: f for f in (resync_noop, resync_dropped_bind,
                                  resync_phantom_claim, adopt_completes_whole,
                                  rollback_policy, rollback_lost_host)}


class TestWarmStartResync:
    @pytest.mark.parametrize("name", sorted(RESYNC))
    def test_resync_case(self, name):
        both(RESYNC[name])


# --- the adopt window ---


def adopt_window_expires(side):
    clock = [100.0]
    stack = make_stack(side, clock=lambda: clock[0], failover_adopt_window_s=30)
    for i in range(2):
        stack.cluster.create_pod(bound_pod(gang_pods(side, "stuck", 4)[i], f"host-{i}"))
    report = stack.reconciler.resync()
    assert report.adopted_gangs == ["stuck"]
    deadlines = stack.reconciler.adopted_gangs()
    clock[0] += 10.0
    inside = stack.reconciler.reconcile(relist=False)
    assert inside.expired_adoptions == []
    clock[0] += 25.0
    drift = stack.reconciler.reconcile(relist=False)
    assert drift.expired_adoptions == ["stuck"]
    assert bound_names(stack) == {}
    assert "stuck" not in stack.reconciler.adopted_gangs()
    return view(report), deadlines, view(inside), view(drift), consistent(stack)


def adoption_forgotten(side):
    stack = make_stack(side)
    pods = gang_pods(side, "done", 2)
    stack.cluster.create_pod(bound_pod(pods[0], "host-0"))
    report = stack.reconciler.resync()
    assert report.adopted_gangs == ["done"]
    stack.cluster.create_pod(pods[1])
    stack.scheduler.run_until_idle(max_wall_s=10)
    assert len(bound_names(stack)) == 2
    drift = stack.reconciler.reconcile(relist=False)
    assert stack.reconciler.adopted_gangs() == {}
    return view(report), view(drift), bound_names(stack)


class TestAdoptWindow:
    @pytest.mark.parametrize("case", [adopt_window_expires, adoption_forgotten],
                             ids=lambda f: f.__name__)
    def test_window_case(self, case):
        both(case)


# --- the drift pass ---


def drift_ghost_binding(side):
    stack = make_stack(side)
    stack.cluster.suppress_kinds.add("Pod")
    ghost = bound_pod(solo(side, "ghost", 2), "host-0")
    stack.cluster.create_pod(ghost)
    stack.cluster.suppress_kinds.clear()
    drift = stack.reconciler.reconcile()
    assert drift.ghost_pods == 1
    assert stack.informer.counts_bound(ghost.uid)
    assert stack.accountant.chips_in_use("host-0") == 2
    return view(drift), consistent(stack)


def drift_dropped_deletion(side):
    stack = make_stack(side)
    stack.cluster.create_pod(solo(side, "p", 2))
    stack.scheduler.run_until_idle(max_wall_s=5)
    node = bound_names(stack)["p"]
    stack.cluster.suppress_kinds.add("Pod")
    stack.cluster.delete_pod("default/p")
    stack.cluster.suppress_kinds.clear()
    assert stack.accountant.chips_in_use(node) == 2
    drift = stack.reconciler.reconcile()
    assert drift.ghost_pods == 1
    assert stack.accountant.chips_in_use(node) == 0
    return view(drift), node, consistent(stack)


def drift_dropped_add(side):
    """A pod created while the watch was down is replayed as an add and
    schedules."""
    stack = make_stack(side)
    stack.cluster.suppress_kinds.add("Pod")
    stack.cluster.create_pod(solo(side, "late", 1))
    stack.cluster.suppress_kinds.clear()
    drift = stack.reconciler.reconcile()
    stack.scheduler.run_until_idle(max_wall_s=5)
    return view(drift), bound_names(stack), consistent(stack)


def drift_stranded_wait(side):
    stack = make_stack(side)
    for p in gang_pods(side, "g", 3)[:2]:
        stack.cluster.create_pod(p)
    stack.scheduler.run_until_idle(max_wall_s=1)
    assert len(stack.framework.waiting_pods()) == 2
    stack.cluster.suppress_kinds.add("Pod")
    stack.cluster.delete_pod("default/g-0")
    stack.cluster.suppress_kinds.clear()
    drift = stack.reconciler.reconcile()
    assert drift.stranded_waits == 1
    assert stack.framework.waiting_pods() == []
    assert {n: c for n, c in stack.accountant.chips_by_node().items() if c} == {}
    return view(drift)


def drift_leaked_claim(side):
    stack = make_stack(side)
    stack.accountant._claim("leak-uid", "host-2", 3)
    drift = stack.reconciler.reconcile()
    assert drift.leaked_reservations == 1
    assert stack.accountant.chips_in_use("host-2") == 0
    return view(drift)


def drift_clean_untouched(side):
    stack = make_stack(side)
    for p in gang_pods(side, "g", 2, chips=2):
        stack.cluster.create_pod(p)
    stack.cluster.create_pod(solo(side, "solo", 1))
    stack.scheduler.run_until_idle(max_wall_s=10)
    before = bound_names(stack)
    assert len(before) == 3
    drift = stack.reconciler.reconcile()
    assert (drift.leaked_reservations, drift.ghost_pods, drift.stranded_waits) == (0, 0, 0)
    assert bound_names(stack) == before
    return view(drift), before, consistent(stack)


DRIFT = {f.__name__: f for f in (drift_ghost_binding, drift_dropped_deletion,
                                 drift_dropped_add, drift_stranded_wait,
                                 drift_leaked_claim, drift_clean_untouched)}


class TestDriftReconciler:
    @pytest.mark.parametrize("name", sorted(DRIFT))
    def test_drift_case(self, name):
        both(DRIFT[name])


class TestRunForever:
    def test_drift_loop_repairs_and_stops(self):
        stack = make_stack(PORT)
        stack.accountant._claim("leak-uid", "host-2", 3)
        stop = threading.Event()
        t = threading.Thread(
            target=stack.reconciler.run_forever, args=(stop,),
            kwargs={"period_s": 0.02}, daemon=True,
        )
        t.start()
        deadline = time.monotonic() + 5
        while stack.accountant.chips_in_use("host-2") and time.monotonic() < deadline:
            stop.wait(0.01)
        stop.set()
        t.join(timeout=2)
        assert not t.is_alive()
        assert stack.accountant.chips_in_use("host-2") == 0


# --- the re-LIST of a watch-caching backend ---


def relists(side, journal_dir=None):
    """Which passes ask the backend to re-LIST: a FakeCluster given the
    ``resync_pods`` a watch-caching backend (KubeCluster) has, counting its
    calls. The cold resync and every drift pass re-LIST; a drift pass with
    ``relist=False`` and the warm resync (the accountant restored from a
    journal replay) do not."""
    cluster = side.fake.FakeCluster()
    calls: list = []
    cluster.resync_pods = lambda: calls.append(len(calls))
    cfg = {"journal_path": str(journal_dir)} if journal_dir else {}
    stack = make_stack(side, cluster=cluster, **cfg)
    fleet(side, cluster)
    cluster.create_pod(solo(side, "solo", 2))
    stack.scheduler.run_until_idle(max_wall_s=5)
    out = {"resync": (stack.reconciler.resync().warm, len(calls))}
    stack.reconciler.reconcile()
    out["reconcile"] = len(calls)
    stack.reconciler.reconcile(relist=False)
    out["reconcile_no_relist"] = len(calls)
    if journal_dir:
        stack.journal.close()
    return out


class TestRelist:
    def test_cold_resync_and_drift_relist(self):
        got = both(relists)
        assert got == {"resync": (False, 1), "reconcile": 2, "reconcile_no_relist": 2}

    def test_warm_resync_skips_the_relist(self, tmp_path):
        """A restart over a journal: the standby's accountant is replayed,
        so its resync reports warm and asks for no re-LIST."""
        for side in (REF, PORT):
            d = tmp_path / side.name
            relists(side, d)  # the first leader writes the journal
        got = both(lambda side: relists(side, tmp_path / side.name))
        assert got["resync"] == (True, 0) and got["reconcile"] == 1
