"""The port's device-resident fleet state on the CPU, held against the
reference (``yoda_tpu.ops.resident``, tests/test_resident.py) with
tolerance 0.

One seeded event script — CR updates, adds and deletes, reservations and
releases, bound pods, Node-object flips, heartbeats — goes through both
packages' informers and accountants. At every step the port's
``FleetStateCache`` must evaluate exactly as a cold re-stack of the same
snapshot and as the reference's cache over its XLA kernel on the CPU, the
four delta feeds must answer alike, and the wired stacks must bind alike
with equal resident-path counters (re-stacks, delta syncs, rows applied,
retained sets, admission-cache reuse) under agent churn. Every CR is
stamped ``now=0.0`` and staleness is off, so no wall clock can split the
packages.
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import yoda_tpu.api.types as ref_types
import yoda_tpu_torch.api.types as port_types
from yoda_tpu.agent import FakeTpuAgent as RefAgent
from yoda_tpu.cluster import Event as RefEvent
from yoda_tpu.cluster import InformerCache as RefInformer
from yoda_tpu.config import SchedulerConfig as RefConfig
from yoda_tpu.config import Weights as RefWeights
from yoda_tpu.ops.arrays import FleetArrays as RefArrays
from yoda_tpu.ops.kernel import DeviceFleetKernel
from yoda_tpu.ops.kernel import KernelRequest as RefRequest
from yoda_tpu.ops.resident import FleetStateCache as RefCache
from yoda_tpu.plugins.yoda.accounting import ChipAccountant as RefAccountant
from yoda_tpu.standalone import build_stack as ref_build_stack
from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
from yoda_tpu_torch.cluster.fake import Event
from yoda_tpu_torch.cluster.informer import InformerCache
from yoda_tpu_torch.config import SchedulerConfig, Weights
from yoda_tpu_torch.ops.arrays import FleetArrays
from yoda_tpu_torch.ops.kernel import KernelRequest, TorchFleetKernel, stack_static
from yoda_tpu_torch.ops.resident import FleetStateCache
from yoda_tpu_torch.plugins.yoda.accounting import ChipAccountant
from yoda_tpu_torch.standalone import build_stack

GIB = 1 << 30
CPU = torch.device("cpu")

REF = SimpleNamespace(
    types=ref_types, Event=RefEvent, Informer=RefInformer,
    Accountant=RefAccountant, Cache=RefCache, Arrays=RefArrays,
    Request=RefRequest, kernel=lambda: DeviceFleetKernel(RefWeights()),
)
PORT = SimpleNamespace(
    types=port_types, Event=Event, Informer=InformerCache,
    Accountant=ChipAccountant, Cache=FleetStateCache, Arrays=FleetArrays,
    Request=KernelRequest, kernel=lambda: TorchFleetKernel(Weights(), CPU),
)
REQUESTS = [(2, 4 * 1024, 0, 0, 0), (1, 0, 0, 0, 0), (4, 8 * 1024, 900, 0, 0)]


def tpu_cr(pkg, name, *, chips=4, free_gib=16, unhealthy=()):
    """A TpuNodeMetrics CR like the reference's ``make_node``, stamped at
    time 0, for either package."""
    t = pkg.types
    return t.TpuNodeMetrics(
        name=name,
        generation="v5e",
        accel_type=f"v5e-{chips}",
        last_updated_unix=0.0,
        chips=[
            t.TpuChip(
                index=i,
                health="Unhealthy" if i in unhealthy else "Healthy",
                hbm_free=free_gib * GIB,
                hbm_total=16 * GIB,
                clock_mhz=940,
                hbm_bandwidth_gbps=819,
                tflops_bf16=197,
                power_w=170,
            )
            for i in range(chips)
        ],
    )


class Side:
    """One package's informer + accountant (+ resident cache), driven by
    the shared script."""

    def __init__(self, pkg, n: int, chips: int = 4) -> None:
        self.pkg = pkg
        self.informer = pkg.Informer()
        self.accountant = pkg.Accountant()
        for i in range(n):
            self.node("added", f"n{i:04d}")
            self.tpu("added", f"n{i:04d}", chips=chips)
        self.cache = pkg.Cache(
            changes_fn=self.informer.changes_since,
            kern_fn=lambda arrays, _k=pkg.kernel(): _k,
            reserved_delta_fn=self.accountant.reserved_changes_since,
            reserved_map_fn=self.accountant.chips_by_node,
            claimed_delta_fn=self.informer.claimed_changes_since,
            claimed_map_fn=self.informer.claimed_hbm_mib_map,
        )

    def node(self, kind: str, name: str, cordoned: bool = False) -> None:
        self.informer.handle(self.pkg.Event(
            kind, "Node", self.pkg.types.K8sNode(name=name, unschedulable=cordoned)
        ))

    def tpu(self, kind: str, name: str, **cr) -> None:
        self.informer.handle(self.pkg.Event(kind, "TpuNodeMetrics", tpu_cr(self.pkg, name, **cr)))

    def apply(self, op: tuple) -> None:
        kind, *args = op
        t = self.pkg.types
        if kind in ("added", "modified", "deleted"):
            name, cr = args
            if kind != "modified":  # a host joins or leaves: Node and CR
                self.node(kind, name)
            self.tpu(kind, name, **cr)
        elif kind == "reserve":
            self.accountant._claim(*args)
        elif kind == "release":
            self.accountant.release(*args)
        elif kind == "pod":
            step, node = args
            self.informer.handle(self.pkg.Event("added", "Pod", t.PodSpec(
                f"pod-{step}", uid=f"pu-{step}", node_name=node,
                labels={"tpu/chips": "1", "tpu/hbm": "2Gi"},
            )))
        elif kind == "unpod":
            (step,) = args
            self.informer.handle(self.pkg.Event("deleted", "Pod", t.PodSpec(
                f"pod-{step}", uid=f"pu-{step}", labels={"tpu/chips": "1"},
            )))
        elif kind == "node":
            name, cordoned = args
            self.node("modified", name, cordoned)
        elif kind == "overrun":
            # More metrics bumps than the delta ring holds: the consumer's
            # epoch falls out of the ring and the next sync must re-stack.
            (name,) = args
            for j in range(4100):
                self.tpu("modified", name, free_gib=2 + j % 2)
        elif kind == "skew":
            self.cache.epoch += 10_000  # state "inherited" from elsewhere
        else:
            raise ValueError(kind)

    def evaluate(self, req: tuple):
        """One evaluation through the resident cache. Admission (here the
        cordon-only view) is per cycle, as the batch plugin passes it: the
        metrics feed does not carry Node-object flips into the mirror."""
        snap = self.informer.snapshot()
        self.cache.sync(snap)
        host_ok = np.ones(self.cache.arrays.node_valid.shape[0], dtype=bool)
        for i, name in enumerate(self.cache.arrays.names):
            node = snap.get(name).node
            host_ok[i] = node is None or not node.unschedulable
        dyn = self.cache.dyn_packed(host_ok=host_ok)
        return self.cache.kern.evaluate(dyn, self.pkg.Request(*req))


def cold(side: Side, req: tuple):
    """What every cycle paid before the resident cache: a cold re-stack of
    the snapshot and a fresh dynamics vector from the live maps."""
    arrays = FleetArrays.from_snapshot(side.informer.snapshot())
    kern = TorchFleetKernel(Weights(), CPU)
    kern.put_static(arrays)
    dyn = arrays.dyn_packed(
        side.accountant.chips_by_node(), side.informer.claimed_hbm_mib_map()
    )
    return arrays, kern, dyn, kern.evaluate(dyn, KernelRequest(*req))


def assert_identical(got, want) -> None:
    for f in ("feasible", "reasons", "raw_scores", "scores", "claimable"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f
        )
    assert got.best_index == want.best_index


def cache_counts(cache) -> tuple:
    return (cache.restacks, cache.delta_syncs, cache.rows_applied, cache.reuse)


def churn_script(seed: int, n0: int, steps: int) -> list[tuple]:
    """A seeded op script over nodes n0000.. that crosses the 8 -> 16 row
    bucket, with one ring overrun and one ahead-skew."""
    rng = random.Random(seed)
    live = [f"n{i:04d}" for i in range(n0)]
    next_id, uids, pods, ops = n0, [], [], []
    for step in range(steps):
        if step == steps // 2:
            ops.append(("overrun", rng.choice(live)))
            continue
        if step == steps // 3:
            ops.append(("skew",))
            continue
        op = rng.choice(["update", "update", "update", "add", "add", "delete",
                         "reserve", "release", "pod", "unpod", "node"])
        if op == "update":
            ops.append(("modified", rng.choice(live), dict(
                free_gib=rng.choice([2, 4, 8, 16]),
                unhealthy=(0,) if rng.random() < 0.3 else (),
            )))
        elif op == "add":
            name = f"n{next_id:04d}"
            next_id += 1
            live.append(name)
            ops.append(("added", name, {}))
        elif op == "delete" and len(live) > 9:
            name = live.pop(rng.randrange(len(live)))
            ops.append(("deleted", name, {}))
        elif op == "reserve":
            uids.append(f"uid-{step}")
            ops.append(("reserve", uids[-1], rng.choice(live), rng.choice([1, 2])))
        elif op == "release" and uids:
            ops.append(("release", uids.pop(0)))
        elif op == "pod":
            pods.append(step)
            ops.append(("pod", step, rng.choice(live)))
        elif op == "unpod" and pods:
            ops.append(("unpod", pods.pop(rng.randrange(len(pods)))))
        elif op == "node":
            ops.append(("node", rng.choice(live), rng.random() < 0.5))
    return ops


class TestDeltaParity:
    @pytest.mark.parametrize("seed", [1234, 7])
    def test_randomized_churn_parity(self, seed):
        port, ref = Side(PORT, 7), Side(REF, 7)
        ops = churn_script(seed, 7, 48)
        assert sum(op[0] == "added" for op in ops) >= 2  # crosses 8 -> 16
        buckets = set()
        for step, op in enumerate(ops):
            for side in (port, ref):
                side.apply(op)
            for req in REQUESTS:
                got = port.evaluate(req)
                arrays, kern, dyn, want = cold(port, req)
                assert_identical(got, want)
                assert_identical(got, ref.evaluate(req))
            # The resident state itself equals a cold upload, bit for bit.
            assert torch.equal(port.cache.kern._chips, kern._chips), step
            assert torch.equal(port.cache.kern._nodes, kern._nodes), step
            np.testing.assert_array_equal(port.cache.dyn_packed()[:3], dyn[:3])
            assert cache_counts(port.cache) == cache_counts(ref.cache), (step, op)
            buckets.add(port.cache.arrays.padded_shape[0])
        assert buckets == {8, 16}
        # The steady stream of single-node updates rode the delta path; the
        # overrun, the skew and every structural delta re-stacked.
        assert port.cache.delta_syncs > 0 and port.cache.rows_applied > 0
        structural = sum(op[0] in ("added", "deleted") for op in ops)
        assert port.cache.restacks >= 3 + min(structural, 1)

    def test_bucket_growth_forces_restack(self):
        port, ref = Side(PORT, 7), Side(REF, 7)
        req = (1, 0, 0, 0, 0)
        for side in (port, ref):
            side.evaluate(req)
        assert port.cache.arrays.padded_shape[0] == 8
        for i in range(7, 10):  # across the 8 -> 16 row-bucket boundary
            for side in (port, ref):
                side.apply(("added", f"n{i:04d}", {}))
        got = port.evaluate(req)
        assert port.cache.arrays.padded_shape[0] == 16
        assert port.cache.restacks == 2  # boot + one structural delta
        assert_identical(got, cold(port, req)[3])
        assert_identical(got, ref.evaluate(req))
        assert cache_counts(port.cache) == cache_counts(ref.cache)

    def test_chip_bucket_growth_forces_restack(self):
        port, ref = Side(PORT, 6), Side(REF, 6)
        req = (5, 0, 0, 0, 0)  # only the 6-chip node fits
        for side in (port, ref):
            side.evaluate(req)
            # A value change (not structural), but the mirror cannot hold 6
            # chip columns.
            side.tpu("modified", "n0001", chips=6)
        got = port.evaluate(req)
        assert port.cache.restacks == 2
        assert port.cache.arrays.padded_shape[1] >= 6
        assert_identical(got, cold(port, req)[3])
        assert_identical(got, ref.evaluate(req))
        assert cache_counts(port.cache) == cache_counts(ref.cache)

    def test_epoch_skew_falls_back_to_restack(self):
        port, ref = Side(PORT, 6), Side(REF, 6)
        req = (2, 1024, 0, 0, 0)
        for side in (port, ref):
            side.evaluate(req)
            side.cache.epoch = 10_000
            assert side.informer.changes_since(10_000) is None
            side.tpu("modified", "n0000", free_gib=2)
        got = port.evaluate(req)
        assert port.cache.restacks == 2
        assert_identical(got, cold(port, req)[3])
        assert_identical(got, ref.evaluate(req))

    def test_behind_skew_returns_none(self):
        for side in (Side(PORT, 3), Side(REF, 3)):
            assert side.informer.changes_since(-5) is None
            d = side.informer.changes_since(side.informer.metrics_version)
            assert d is not None and not d.changed and not d.structural


def feeds(side: Side, probes) -> dict:
    """Every delta feed's answer at each probe epoch, as plain values."""
    inf, acc = side.informer, side.accountant
    out = {}
    for e in probes["metrics"]:
        d = inf.changes_since(e)
        out["metrics", e] = None if d is None else (d.epoch, set(d.changed), d.structural)
    for e in probes["claimed"]:
        out["claimed", e] = inf.claimed_changes_since(e)
    for e in probes["admission"]:
        cur, nodes = inf.admission_changes_since(e)
        out["admission", e] = (cur, None if nodes is None else set(nodes))
    for e in probes["reserved"]:
        out["reserved", e] = acc.reserved_changes_since(e)
    return out


class TestDeltaFeed:
    @pytest.mark.parametrize("seed", [3, 11])
    def test_feeds_equal_reference_at_every_step(self, seed):
        port, ref = Side(PORT, 7), Side(REF, 7)
        history = {k: [0] for k in ("metrics", "claimed", "admission", "reserved")}
        ops = [op for op in churn_script(seed, 7, 48) if op[0] not in ("overrun", "skew")]
        rng = random.Random(seed)
        for op in ops:
            heartbeat = rng.random() < 0.3
            for side in (port, ref):
                side.apply(op)
                if heartbeat and "n0000" in side.informer.snapshot():
                    side.tpu("modified", "n0000")  # a heartbeat while unchanged
            inf, acc = port.informer, port.accountant
            current = {
                "metrics": inf.metrics_version, "claimed": inf.claimed_epoch,
                "admission": inf.admission_epoch, "reserved": acc.reservation_epoch,
            }
            assert current == {
                "metrics": ref.informer.metrics_version,
                "claimed": ref.informer.claimed_epoch,
                "admission": ref.informer.admission_epoch,
                "reserved": ref.accountant.reservation_epoch,
            }
            probes = {}
            for k, seen in history.items():
                seen.append(current[k])
                # Every epoch seen so far, plus ahead-skew and behind-skew.
                probes[k] = sorted(set(seen) | {current[k] + 5, -3})
            assert feeds(port, probes) == feeds(ref, probes)
            snap = port.informer.snapshot()
            assert snap.admission_epoch == ref.informer.snapshot().admission_epoch

    def test_modified_vs_structural_kinds(self):
        for side in (Side(PORT, 4), Side(REF, 4)):
            inf = side.informer
            e0 = inf.metrics_version
            side.tpu("modified", "n0002", free_gib=1)
            d = inf.changes_since(e0)
            assert d.changed == {"n0002"} and not d.structural
            side.tpu("deleted", "n0003")
            assert inf.changes_since(e0).structural
            # Heartbeat (value-identical republish): no epoch bump, no delta.
            e1 = inf.metrics_version
            side.tpu("modified", "n0002", free_gib=1)
            assert inf.metrics_version == e1
            assert inf.changes_since(e1).changed == frozenset()

    def test_reserved_delta_feed(self):
        for acc in (ChipAccountant(), RefAccountant()):
            e0 = acc.reservation_epoch
            acc._claim("u1", "host-a", 3)
            acc._claim("u2", "host-b", 2)
            cur, changes = acc.reserved_changes_since(e0)
            assert changes == {"host-a": 3, "host-b": 2}
            acc.release("u1")
            cur2, changes2 = acc.reserved_changes_since(cur)
            assert changes2 == {"host-a": 0}
            assert acc.reserved_changes_since(cur2) == (cur2, {})
            assert acc.reserved_changes_since(cur2 + 50)[1] is None


# --- the wired stacks ---


def ref_stack(enable_preemption=False, **knobs):
    return ref_build_stack(config=RefConfig(
        kernel_platform="cpu", enable_preemption=enable_preemption, **knobs,
    ))


def port_stack(enable_preemption=False, **knobs):
    return build_stack(config=SchedulerConfig(
        kernel_platform="cpu", enable_preemption=enable_preemption, **knobs,
    ))


STACKS = {"port": (port_stack, port_types, FakeTpuAgent),
          "ref": (ref_stack, ref_types, RefAgent)}
SET_COUNTERS = ("sets_retained", "burst_served", "burst_invalidated",
                "gang_burst_served", "gang_burst_invalidated", "dispatch_count")


def drain(stack) -> None:
    while (q := stack.scheduler.queue.pop(timeout=0)) is not None:
        stack.scheduler.schedule_one(q)


class TestSelectiveInvalidation:
    """An unrelated node update keeps a cached burst / gang-fused set; a
    related one drops it — with the reference's counters."""

    def _stack(self, which: str):
        build, types, agent_cls = STACKS[which]
        stack = build(batch_requests=8)
        agent = agent_cls(stack.cluster)
        for i in range(2):
            agent.add_host(f"v5e-{i}", generation="v5e", chips=8)
        # The unrelated node: 1 chip, infeasible for every 2-chip pod below.
        agent.add_host("tiny", generation="v5e", chips=1)
        agent.publish_all()
        (yb,) = stack.framework.batch_plugins
        return stack, types, agent, yb

    def _run(self, which: str, flip: str, gang: bool) -> dict:
        stack, types, agent, yb = self._stack(which)
        if gang:
            pods = [types.PodSpec(f"g-{m}", labels={
                "tpu/gang": "g", "tpu/gang-size": "2", "tpu/chips": "2"})
                for m in range(2)]
        else:
            pods = [types.PodSpec(f"p-{i}", labels={"tpu/chips": "2"}) for i in range(2)]
        for p in pods:
            stack.cluster.create_pod(p)
        if gang:
            stack.framework.prepare_gang(pods, stack.informer.snapshot())
            assert "g" in yb._gang_bursts
        else:
            stack.framework.prepare_burst(pods, stack.informer.snapshot())
            assert yb._burst is not None
        agent.set_chip_health(flip, 0, False)
        agent.refresh(flip)
        drain(stack)
        bound = [p.node_name for p in stack.cluster.list_pods() if p.node_name]
        assert len(bound) == 2
        return {c: getattr(yb, c) for c in SET_COUNTERS}

    @pytest.mark.parametrize("flip, gang", [
        ("tiny", False),    # unrelated node: the burst is kept
        ("v5e-0", False),   # a node the rows are feasible on: dropped
        ("tiny", True),     # unrelated node: the gang's rows are kept
    ])
    def test_counters_equal_reference(self, flip, gang):
        got, want = self._run("port", flip, gang), self._run("ref", flip, gang)
        assert got == want
        if flip == "tiny":
            assert got["sets_retained"] >= 1
            served = "gang_burst_served" if gang else "burst_served"
            assert got[served] == 2
            assert got["burst_invalidated"] == got["gang_burst_invalidated"] == 0
        else:
            assert got["burst_invalidated"] >= 1


class TestResidentStack:
    def test_stack_delta_syncs_instead_of_restacks(self):
        stack = port_stack()
        agent = FakeTpuAgent(stack.cluster)
        for i in range(4):
            agent.add_host(f"h-{i}", generation="v5e", chips=8)
        agent.publish_all()
        stack.cluster.create_pod(port_types.PodSpec("warm", labels={"tpu/chips": "1"}))
        stack.scheduler.run_until_idle(max_wall_s=30)
        yb = stack.batch
        assert yb._resident is not None
        assert yb.changes_fn is not None and yb.reserved_delta_fn is not None
        assert yb.claimed_delta_fn is not None and yb.admission_changes_fn is not None
        static0, restacks0 = yb._static, yb.restacks
        for k in range(3):  # rolling single-node refreshes + dispatches
            agent.set_chip_health(f"h-{k}", 0, False)
            agent.refresh(f"h-{k}")
            stack.cluster.create_pod(port_types.PodSpec(f"p{k}", labels={"tpu/chips": "2"}))
            stack.scheduler.run_until_idle(max_wall_s=30)
        assert yb.restacks == restacks0, "refreshes must not re-stack"
        assert yb._resident.delta_syncs >= 3
        assert yb._resident.rows_applied >= 3
        assert yb._static is static0  # same mirror object, rows refilled
        assert not static0.chip_healthy[static0.names.index("h-0"), 0]
        chips, nodes = stack_static(static0)
        assert torch.equal(yb._kern._chips, torch.from_numpy(chips))
        assert torch.equal(yb._kern._nodes, torch.from_numpy(nodes))
        pods = [p for p in stack.cluster.list_pods() if p.name.startswith("p")]
        assert len(pods) == 3 and all(p.node_name for p in pods)

    def test_bare_construction_keeps_classic_path(self):
        """Without the delta feeds (a bare YodaBatch, or feeds unset after
        build_stack) the classic per-version refresh serves."""
        stack = port_stack()
        for attr in ("changes_fn", "reserved_delta_fn", "claimed_delta_fn",
                     "admission_changes_fn"):
            setattr(stack.batch, attr, None)
        agent = FakeTpuAgent(stack.cluster)
        agent.add_host("h", generation="v5e", chips=8)
        agent.publish_all()
        stack.cluster.create_pod(port_types.PodSpec("p", labels={"tpu/chips": "1"}))
        stack.scheduler.run_until_idle(max_wall_s=30)
        assert stack.cluster.get_pod("default/p").node_name == "h"
        assert stack.batch._resident is None and stack.batch.restacks == 1
        assert stack.batch.sets_retained == stack.batch.admission_reuse == 0


# --- stack parity under churn ---

CHURN_COUNTERS = (
    "restacks", "snapshot_reuse", "sets_retained", "burst_served",
    "burst_invalidated", "gang_burst_served", "gang_burst_invalidated",
    "admission_reuse", "admission_patched", "admission_rebuilds",
    "dispatch_count", "burst_dispatches", "joint_dispatches", "plan_served",
)


def churn_pods(seed: int) -> list[tuple[str, dict]]:
    """Singletons and plain gangs, interleaved by a seeded shuffle (each
    gang's members stay in order)."""
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(40):
        labels = {"tpu/chips": str(int(rng.choice([1, 1, 2, 4, 8])))}
        if rng.random() < 0.5:
            labels["tpu/hbm"] = f"{int(rng.integers(1, 12))}Gi"
        if rng.random() < 0.2:
            labels["tpu/generation"] = "v5p"
        pods.append([(f"s{i:02d}", labels)])
    for g in range(3):
        size = 4
        labels = {"tpu/gang": f"g{g}", "tpu/gang-size": str(size),
                  "tpu/chips": str(2 * (g + 1))}
        pods.append([(f"g{g}-{m}", dict(labels)) for m in range(size)])
    order = rng.permutation(len(pods))
    return [p for i in order for p in pods[i]]


def run_churn(which: str, burst: int, seed: int, preemption: bool = False) -> dict:
    """Drive one stack cycle by cycle: pop a loop turn's batch, then run
    its cycles one by one; between cycles the agent republishes every host
    bound since the last cycle, and every 5th cycle it flips a chip's
    health on a seeded host."""
    build, types, agent_cls = STACKS[which]
    stack = build(batch_requests=burst, enable_preemption=preemption)
    agent = agent_cls(stack.cluster, now_fn=lambda: 0.0)
    hosts = [f"v5e-{i:02d}" for i in range(16)] + [f"v5p-{i:02d}" for i in range(6)]
    for h in hosts:
        agent.add_host(h, generation=h[:3], chips=8 if h.startswith("v5e") else 4)
    agent.publish_all()
    for name, labels in churn_pods(seed):
        stack.cluster.create_pod(types.PodSpec(name, labels=dict(labels)))
    rng = random.Random(seed)
    sched, queue = stack.scheduler, stack.scheduler.queue
    cycle, seen_bound, unhealthy, bound_at_retry = 0, set(), set(), -1
    while True:
        qpi = queue.pop(timeout=0)
        if qpi is None:
            # As run_until_idle: retry parked pods while binds progress.
            if not queue.pending_retry_count() or len(seen_bound) == bound_at_retry:
                break
            bound_at_retry = len(seen_bound)
            queue.move_all_to_active(force=True)
            continue
        for q in sched._pop_batch(qpi):
            sched.schedule_one(q)
            cycle += 1
            bound = {(p.name, p.node_name) for p in stack.cluster.list_pods() if p.node_name}
            for h in sorted({n for _, n in bound - seen_bound}):
                agent.refresh(h)
            seen_bound = bound
            # Health flips stop after the first 120 cycles: each flip
            # reactivates parked pods, and the drain must end.
            if cycle % 5 == 0 and cycle <= 120:
                h = rng.choice(hosts)
                chip = rng.randrange(2)
                agent.set_chip_health(h, chip, (h, chip) in unhealthy)
                unhealthy ^= {(h, chip)}
                agent.refresh(h)
    (yb,) = stack.framework.batch_plugins
    resident = yb._resident
    return dict(
        bindings={p.name: p.node_name for p in stack.cluster.list_pods()},
        gangs={g: stack.gang.gang_status(g) for g in ("g0", "g1", "g2")},
        cycles=cycle,
        preempted=stack.preemption.preempted_total if stack.preemption else None,
        delta_syncs=resident.delta_syncs, rows_applied=resident.rows_applied,
        **{c: getattr(yb, c) for c in CHURN_COUNTERS},
    )


class TestStackParityUnderChurn:
    """The closed divergence: before the port had the resident path its
    stack re-stacked on every refresh and dropped every cached set on any
    fleet change, so these counters differed from the reference's."""

    @pytest.mark.parametrize("preemption", [False, True])
    @pytest.mark.parametrize("burst", [1, 16])
    def test_bindings_verdicts_and_counters_equal_reference(self, burst, preemption):
        got = run_churn("port", burst, seed=5, preemption=preemption)
        want = run_churn("ref", burst, seed=5, preemption=preemption)
        assert got == want
        assert sum(v is not None for v in got["bindings"].values()) > 30
        assert got["restacks"] == 1 and got["delta_syncs"] > 0
        assert got["rows_applied"] > 0 and got["admission_reuse"] > 0
        if burst > 1:
            assert got["burst_served"] > 0


@pytest.mark.slow
class TestFlatOverheadAtScale:
    def test_delta_cycle_overhead_flat_at_low_churn(self):
        """At fixed low churn, the per-cycle pre-dispatch overhead (delta
        sync + dynamics build, no re-stack) must not scale with the fleet:
        16x the fleet must cost less than 4x the small-fleet cycle (a full
        re-stack is ~16x)."""
        times = {}
        for n in (512, 8192):
            side = Side(PORT, n, chips=8)
            side.cache.sync(side.informer.snapshot())
            side.cache.dyn_packed()
            samples = []
            for c in range(15):
                for j in range(4):
                    i = (c * 4 + j) % n
                    side.tpu("modified", f"n{i:04d}", chips=8, free_gib=8 + c % 8)
                    side.accountant._claim(f"u-{c}-{j}", f"n{i:04d}", 1)
                snap = side.informer.snapshot()
                t0 = time.perf_counter()
                side.cache.sync(snap)
                side.cache.dyn_packed()
                samples.append(time.perf_counter() - t0)
            assert side.cache.restacks == 1, "low churn must never re-stack"
            samples.sort()
            times[n] = samples[len(samples) // 2]
        assert times[8192] < max(4 * times[512], 0.01), times
