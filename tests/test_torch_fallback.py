"""The port's degraded-mode dispatch chain against the JAX package, on the
CPU, with tolerance 0 (int32 throughout):

- ``NumpyFleetKernel`` against the reference's ``NumpyFleetKernel`` and the
  port's plain version (``TorchFleetKernel`` on the host) on seeded fleets:
  8-chip, 40- and 64-chip hosts, padded rows, K = 1 / 16 / 144 bursts, and
  joint plans with heavy score ties and gangs that fail part-way; its path
  runs no torch op;
- the chain (``YodaBatch._dispatch``) under seeded fault plans: after each
  cycle ``dispatch_errors``, ``dispatch_fallbacks``, ``backend_level`` and
  the bindings equal the reference stack's under the same plan, and both
  ``yoda_dispatch_*`` families render the same on ``/metrics``;
- the fused plain-gang plan and a topology gang's split pass demote and give
  the primary's picks and fits; a demoted dispatch right after a resident
  delta sync sees the refilled rows; the mesh kernel (``mesh_devices: 1``)
  demotes with ``sharded_dispatches`` counting level 0 only; a level whose
  construction fails is skipped for good; ``kernel_platform: auto`` still
  raises without a card;
- a primary on the card never demotes (the port's departure from the
  reference): a failed build, launch or argument check is counted in
  ``dispatch_errors`` and re-raised, the pod's cycle ends in error and the
  pod binds when retried, with no pin and no host level built. The card
  is stood in for by ``YodaBatch._primary_on_card``, the one place the
  plugin asks where its primary's tensors live.

The reference's own cases (``tests/test_chaos.py::TestDispatchFallback``)
run on both packages in ``tests/test_torch_parity_chaos.py``. On the card,
``tests/test_torch_cuda.py`` holds a demoted result against ``fleet_eval``
and drives the faults on a card stack.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import yoda_tpu.ops.kernel as ref
import yoda_tpu_torch.ops.kernel as port
import yoda_tpu_torch.plugins.yoda.batch as port_batch
from yoda_tpu.config import Weights
from yoda_tpu.ops.kernel import KernelRequest

from test_torch_joint import joint_inputs, port_groups
from test_torch_kernel import (
    MOST_ALLOCATED,
    REQUESTS,
    assert_same,
    own_dyn,
    random_arrays,
    to_torch,
    torch_request,
    torch_weights,
)

CPU = torch.device("cpu")
PACKAGES = ("yoda_tpu", "yoda_tpu_torch")


# --- the numpy evaluator ----------------------------------------------------


def kernels(arrays, weights):
    """(reference numpy, port numpy, port plain version), each put."""
    rk = ref.NumpyFleetKernel(weights)
    rk.put_static(arrays)
    nk = port.NumpyFleetKernel(torch_weights(weights))
    tk = port.TorchFleetKernel(torch_weights(weights), CPU)
    fleet = to_torch(arrays)
    nk.put_static(fleet)
    tk.put_static(fleet)
    return rk, nk, tk


def burst_inputs(arrays, k: int, seed: int):
    """K seeded admission rows (a few all-False, as padding) and requests."""
    rng = np.random.default_rng(seed)
    n = arrays.node_valid.shape[0]
    host_ok = (rng.random((k, n)) > 0.3).astype(np.int32)
    host_ok[k - k // 8 :] = 0
    requests = [REQUESTS[int(i)] for i in rng.integers(0, len(REQUESTS), size=k)]
    return host_ok, requests


def partway_inputs(seed: int, n_nodes: int):
    """Three gangs over a fleet that admits every row: 3 one-chip members,
    then 4 two-chip members per node (more than the fleet's chips), then 2
    one-chip members."""
    arrays = random_arrays(n_nodes, seed=seed)
    n_pad = arrays.node_valid.shape[0]
    sizes = (3, 4 * n_nodes, 2)
    host_ok_groups = [np.ones((size, n_pad), dtype=np.int32) for size in sizes]
    small, large = KernelRequest(1, 0, 0, 0, 0), KernelRequest(2, 0, 0, 0, 0)
    request_groups = [[small] * 3, [large] * sizes[1], [small] * 2]
    return arrays, host_ok_groups, request_groups


def tied_arrays(arrays, n_nodes: int):
    """Every real node a copy of the first: every score ties."""
    out = {}
    for f in dataclasses.fields(arrays):
        v = getattr(arrays, f.name)
        if isinstance(v, np.ndarray) and f.name not in ("node_valid",):
            v = v.copy()
            v[: n_nodes] = v[0]
        out[f.name] = v
    return dataclasses.replace(arrays, **out)


class NoTorch(TorchFunctionMode):
    """Fails any torch function called while active."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        raise AssertionError(f"torch op on the numpy path: {func}")


class Forbidden:
    def __getattr__(self, name):
        raise AssertionError(f"torch.{name} reached on the numpy path")


class TestNumpyFleetKernel:
    @pytest.mark.parametrize("n_nodes,chips", [(50, 8), (40, 40), (30, 64), (3, 8)])
    @pytest.mark.parametrize("weights", [Weights(), MOST_ALLOCATED], ids=["least", "most"])
    def test_evaluate_matches_reference_and_plain(self, n_nodes, chips, weights):
        arrays = random_arrays(n_nodes, chips, seed=n_nodes + chips)
        assert arrays.node_valid.shape[0] > n_nodes  # padded rows
        rk, nk, tk = kernels(arrays, weights)
        dyn = own_dyn(arrays)
        for r in REQUESTS:
            got = nk.evaluate(dyn, torch_request(r))
            assert_same(got, rk.evaluate(dyn, r))
            assert_same(got, tk.evaluate(dyn, torch_request(r)))

    @pytest.mark.parametrize("k", [1, 16, 144])
    @pytest.mark.parametrize("n_nodes,chips", [(50, 8), (40, 40), (30, 64)])
    def test_burst_matches_reference_and_plain(self, k, n_nodes, chips):
        arrays = random_arrays(n_nodes, chips, seed=k + chips)
        rk, nk, tk = kernels(arrays, MOST_ALLOCATED if k == 16 else Weights())
        dyn = own_dyn(arrays)
        host_ok, requests = burst_inputs(arrays, k, seed=k)
        preqs = [torch_request(r) for r in requests]
        got = nk.evaluate_burst(dyn, host_ok, preqs)
        want = rk.evaluate_burst(dyn, host_ok, requests)
        plain = tk.evaluate_burst(dyn, host_ok, preqs)
        assert len(got) == len(want) == len(plain) == k
        for g, w, p in zip(got, want, plain):
            assert_same(g, w)
            assert_same(g, p)

    @pytest.mark.parametrize("tied", [False, True], ids=["seeded", "tied"])
    @pytest.mark.parametrize("seed,n_nodes,sizes", [
        (0, 60, [4]), (1, 60, [3, 5, 2]), (3, 12, [8, 8, 8, 8]), (5, 20, "partway"),
        (6, 9, "partway"),
    ])
    @pytest.mark.parametrize("minimum", [1, 16])
    def test_joint_plan_matches_reference_and_plain(self, tied, seed, n_nodes, sizes,
                                                    minimum):
        if sizes == "partway":
            arrays, host_ok_groups, request_groups = partway_inputs(seed, n_nodes)
        else:
            arrays, host_ok_groups, request_groups = joint_inputs(seed, n_nodes, sizes)
        if tied:
            arrays = tied_arrays(arrays, n_nodes)
        rk, nk, tk = kernels(arrays, Weights())
        dyn = own_dyn(arrays)
        groups = port_groups(request_groups)
        want = rk.evaluate_joint_plan(dyn, host_ok_groups, request_groups, minimum)
        got = nk.evaluate_joint_plan(dyn, host_ok_groups, groups, minimum)
        plain = tk.evaluate_joint_plan(dyn, host_ok_groups, groups, minimum)
        for other in (want, plain):
            assert got[1] == other[1]
            for g_rows, w_rows in zip(got[0], other[0]):
                for g, w in zip(g_rows, w_rows):
                    assert_same(g, w)
            for g, w in zip(got[2], other[2]):
                np.testing.assert_array_equal(g, np.asarray(w))
        joint = nk.evaluate_joint(dyn, host_ok_groups, groups, minimum)
        for g_rows, w_rows in zip(joint, got[0]):
            for g, w in zip(g_rows, w_rows):
                assert_same(g, w)
        if sizes == "partway":
            # The middle gang fails part-way (its first members claimed
            # nodes, a later one found none) and consumes nothing, so the
            # last gang fits.
            assert got[1] == [True, False, True]
            if not tied:  # tied copies of one node fail at the first row
                assert (got[2][1] >= 0).any() and (got[2][1] < 0).any()

    def test_runs_no_torch_op(self, monkeypatch):
        arrays, host_ok_groups, request_groups = joint_inputs(1, 40, [3, 5, 2])
        nk = port.NumpyFleetKernel(torch_weights(Weights()))
        fleet = to_torch(arrays)
        dyn = own_dyn(arrays)
        groups = port_groups(request_groups)
        host_ok, requests = burst_inputs(arrays, 16, seed=2)
        preqs = [torch_request(r) for r in requests]
        monkeypatch.setattr(port, "torch", Forbidden())
        with NoTorch():
            nk.put_static(fleet)
            nk.update_rows(fleet, [0, 1])
            nk.evaluate(dyn, preqs[0])
            nk.evaluate_burst(dyn, host_ok, preqs)
            nk.evaluate_joint(dyn, host_ok_groups, groups, 16)
            nk.evaluate_joint_plan(dyn, host_ok_groups, groups, 16)

    def test_rows_refilled_in_place_stay_visible(self):
        arrays = random_arrays(20, seed=4)
        fleet = to_torch(arrays)
        nk = port.NumpyFleetKernel(torch_weights(Weights()))
        nk.put_static(fleet)
        fleet.chip_healthy[3] = False  # an in-place refill
        nk.update_rows(fleet, [3])
        tk = port.TorchFleetKernel(torch_weights(Weights()), CPU)
        tk.put_static(fleet)
        dyn = own_dyn(arrays)
        for r in REQUESTS:
            assert_same(nk.evaluate(dyn, torch_request(r)), tk.evaluate(dyn, torch_request(r)))
        swapped = to_torch(random_arrays(20, seed=5))
        nk.update_rows(swapped, [0])  # a new arrays object: re-put
        assert nk._static["chip_valid"] is swapped.chip_valid


# --- the chain on a stack -------------------------------------------------


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class Side:
    """One package's stack over a FakeCluster of v5p hosts, on the host."""

    def __init__(self, pkg: str, *, hosts: int = 4, chips: int = 4,
                 slices: int = 0, **cfg):
        self.pkg = pkg
        config = mod(pkg, "config").SchedulerConfig(
            mode="batch", kernel_platform="cpu", bind_workers=0, **cfg
        )
        self.stack = mod(pkg, "standalone").build_stack(
            cluster=mod(pkg, "cluster.fake").FakeCluster(), config=config
        )
        self.agent = mod(pkg, "agent").FakeTpuAgent(self.stack.cluster)
        for i in range(hosts):
            self.agent.add_host(f"host-{i}", generation="v5p", chips=chips)
        for s in range(slices):
            self.agent.add_slice(f"slice-{s}", generation="v5p")
        self.agent.publish_all()
        self.batch = self.stack.framework.batch_plugins[0]
        self.chaos = mod(pkg, "testing.chaos")
        self.pod_cls = mod(pkg, "api.types").PodSpec

    def create(self, name: str, chips: int = 1, **labels) -> None:
        self.stack.cluster.create_pod(
            self.pod_cls(name, labels={"tpu/chips": str(chips), **labels})
        )

    def gang(self, name: str, size: int, chips: int, topology: str | None = None):
        for i in range(size):
            labels = {"tpu/gang": name, "tpu/gang-size": str(size)}
            if topology:
                labels["tpu/topology"] = topology
            self.create(f"{name}-{i}", chips, **labels)

    def run(self) -> None:
        self.stack.scheduler.run_until_idle(max_wall_s=20)

    def install(self, faults, kernel=None):
        plan = self.chaos.ChaosPlan(list(faults))
        if kernel is None:
            self.chaos.install_chaos_kernel(self.batch, plan)
        else:
            kernel(self.batch, plan)
        return plan

    def state(self) -> tuple:
        b = self.batch
        return b.dispatch_errors, b.dispatch_fallbacks, b.backend_level

    def bindings(self) -> dict:
        return {p.name: p.node_name for p in self.stack.cluster.list_pods()}

    def families(self) -> list:
        text = self.stack.metrics.registry.render_prometheus()
        return [
            ln for ln in text.splitlines()
            if ln.startswith(("yoda_dispatch_fallback_total", "yoda_dispatch_backend_level",
                              "yoda_dispatch_errors_total"))
        ]


def install_plan_fault(batch, plan):
    """The primary wrapped so that its fused plan draws faults too (the
    packages' ChaosKernel has no ``evaluate_joint_plan``)."""
    chaos = importlib.import_module(type(batch).__module__.split(".")[0] + ".testing.chaos")

    class PlanFault(chaos.ChaosKernel):
        def evaluate_joint_plan(self, dyn, host_ok_groups, request_groups, minimum=1):
            self._maybe_fail("plan")
            return self._inner.evaluate_joint_plan(
                dyn, host_ok_groups, request_groups, minimum
            )

    inner = batch._kern
    batch._kern = PlanFault(inner, plan)
    if batch._resident is not None and batch._resident.kern is inner:
        batch._resident.kern = batch._kern
    return batch._kern


def chain_script(side: Side, seed: int) -> list:
    """A warm-up pod, then a seeded fault plan over singletons, bursts and
    gangs, cycle after cycle: the chain's counters and the bindings after
    each step, and the families at the end."""
    side.create("warmup")
    side.run()
    plan = side.chaos.ChaosPlan.seeded(seed, ops=("dispatch",), horizon=24, rate=0.4)
    side.chaos.install_chaos_kernel(side.batch, plan)
    seen = []
    for step in range(10):
        if step % 4 == 3:
            side.gang(f"g{step}", 2, 2)
        elif step % 4 == 1:
            for i in range(3):
                side.create(f"b{step}-{i}", 1)
        else:
            side.create(f"p{step}", 1 + step % 2)
        side.run()
        seen.append((side.state(), side.bindings(), plan.invocations("dispatch")))
    seen.append(side.families())
    return seen


class TestChainSequence:
    @pytest.mark.parametrize("seed", [3, 7, 11])
    @pytest.mark.parametrize("burst", [1, 16])
    def test_counters_and_bindings_match_reference(self, seed, burst):
        got = chain_script(Side("yoda_tpu_torch", hosts=6, batch_requests=burst), seed)
        want = chain_script(Side("yoda_tpu", hosts=6, batch_requests=burst), seed)
        assert got == want
        states = [s[0] for s in got[:-1]]
        assert any(s[1] > 0 for s in states)  # the plan demoted something

    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_breaker_pins_then_level_two(self, pkg):
        side = Side(pkg, hosts=4)
        side.create("warmup")
        side.run()
        plan = side.install([side.chaos.FaultSpec("dispatch", 0, "error", count=100)])
        for i in range(3):
            side.create(f"p{i}")
            side.run()
        assert side.state() == (3, 3, 1)
        probes = plan.invocations("dispatch")
        side.create("pinned")
        side.run()
        assert plan.invocations("dispatch") == probes
        assert side.state() == (3, 4, 1)
        # Level 1 fails too: three more failures pin level 2.
        lvl1 = side.batch._fb_kerns[1]
        side.batch._fb_kerns[1] = side.chaos.ChaosKernel(
            lvl1, side.chaos.ChaosPlan([side.chaos.FaultSpec("dispatch", 0, "error", count=100)])
        )
        for i in range(4):
            side.create(f"q{i}")
            side.run()
        assert side.state() == (6, 8, 2)
        assert all(side.bindings().values())
        lines = side.families()
        assert "yoda_dispatch_backend_level 2" in " ".join(lines).replace(".0", "")


def plain_gang_sides(pkg: str, faulted: bool):
    side = Side(pkg, hosts=8, chips=4, batch_requests=16)
    side.create("warmup")
    side.run()
    if faulted:
        side.install([side.chaos.FaultSpec("dispatch", 0, "error")], install_plan_fault)
    return side


class RecordingLevel:
    """Wraps a demoted level's kernel: records each joint call's inputs and
    output, so the test can hold them against the primary's."""

    def __init__(self, inner):
        self._inner = inner
        self.calls = []

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not name.startswith("evaluate"):
            return attr

        def call(*args):
            # The resident dynamics row is maintained in place: keep the
            # inputs as they were at the call.
            kept = copy.deepcopy(args)
            out = attr(*args)
            self.calls.append((name, kept, out))
            return out

        return call


class TestJointPassesDemote:
    @pytest.mark.parametrize("level", [1, 2])
    def test_fused_plan_demotes_with_primary_picks(self, level):
        clean = plain_gang_sides("yoda_tpu_torch", faulted=False)
        side = plain_gang_sides("yoda_tpu_torch", faulted=True)
        primary = side.batch._kern._inner
        if level == 2:
            side.batch._fb_kerns[1] = False  # the host copy unavailable
        for s in (clean, side):
            s.gang("ga", 4, 4)
            s.gang("gb", 4, 4)
            s.gang("gc", 4, 4)  # parks: 8 hosts hold two gangs
        side.batch._kernel_at(level, side.batch._refresh_static(
            side.stack.informer.snapshot()))
        rec = side.batch._fb_kerns[level] = RecordingLevel(side.batch._fb_kerns[level])
        for s in (clean, side):
            s.run()
        assert side.bindings() == clean.bindings()
        assert side.batch.dispatch_fallbacks == 1
        assert side.batch.fused_plan_dispatches == clean.batch.fused_plan_dispatches >= 1
        plans = [c for c in rec.calls if c[0] == "evaluate_joint_plan"]
        assert plans
        for _name, args, (grouped, fits, picks) in plans:
            want = primary.evaluate_joint_plan(*args)
            assert fits == want[1] and False in fits
            for g, w in zip(picks, want[2]):
                np.testing.assert_array_equal(g, w)
            for g_rows, w_rows in zip(grouped, want[0]):
                for g, w in zip(g_rows, w_rows):
                    assert_same(g, w)

    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_topology_split_pass_demotes(self, pkg):
        sides = []
        for faulted in (False, True):
            side = Side(pkg, hosts=2, slices=4, batch_requests=16)
            side.create("warmup")
            side.run()
            if faulted:
                side.install([side.chaos.FaultSpec("dispatch", 0, "error")])
            side.gang("ta", 4, 4, topology="2x2x1")
            side.gang("tb", 4, 4, topology="2x2x1")
            side.run()
            sides.append(side)
        clean, side = sides
        assert side.bindings() == clean.bindings()
        assert all(side.bindings().values())
        assert side.state() == (1, 1, 0)

    def test_topology_split_pass_matches_reference(self):
        def script(pkg):
            side = Side(pkg, hosts=2, slices=4, batch_requests=16)
            side.create("warmup")
            side.run()
            side.install([side.chaos.FaultSpec("dispatch", 0, "error")])
            side.gang("ta", 4, 4, topology="2x2x1")
            side.gang("tb", 4, 4, topology="2x2x1")
            side.gang("pa", 2, 4)
            side.run()
            return side.state(), side.bindings(), side.families()

        assert script("yoda_tpu_torch") == script("yoda_tpu")


class TestChainEdges:
    def test_demotion_after_delta_sync_sees_refilled_rows(self):
        sides = []
        for faulted in (False, True):
            side = Side("yoda_tpu_torch", hosts=2, chips=4)
            side.create("warmup")
            side.run()
            if faulted:
                side.install([side.chaos.FaultSpec("dispatch", 0, "error", count=100)])
            side.create("a")
            side.run()
            syncs = side.batch._resident.delta_syncs
            # The host the next pod would take loses its chips: the delta
            # sync refills its row in place.
            side.agent.fail_chips(side.bindings()["a"], [0, 1, 2, 3])
            side.create("b")
            side.run()
            assert side.batch._resident.delta_syncs > syncs
            sides.append(side)
        clean, side = sides
        assert side.bindings() == clean.bindings()
        assert side.bindings()["b"] != side.bindings()["a"]
        assert side.state() == (2, 2, 0)
        lvl1 = side.batch._fb_kerns[1]
        chips, nodes = port.stack_static(side.batch._static)
        assert torch.equal(lvl1._chips, torch.from_numpy(chips))
        assert torch.equal(lvl1._nodes, torch.from_numpy(nodes))

    def test_numpy_level_after_delta_sync(self):
        side = Side("yoda_tpu_torch", hosts=2, chips=4)
        side.create("warmup")
        side.run()
        side.batch._fb_kerns[1] = False
        side.install([side.chaos.FaultSpec("dispatch", 0, "error", count=100)])
        side.create("a")
        side.run()
        side.agent.fail_chips(side.bindings()["a"], [0, 1, 2, 3])
        side.create("b")
        side.run()
        assert side.bindings()["b"] not in (None, side.bindings()["a"])
        lvl2 = side.batch._fb_kerns[2]
        assert lvl2._static["chip_healthy"] is side.batch._static.chip_healthy

    def test_restacked_fleet_keeps_the_host_level(self):
        """A demotion after a full re-stack of the same hosts: the port
        re-puts the new arrays into its level-1 kernel. The reference
        compares the two fleets with ``!=`` (element-wise arrays: it
        raises) and marks the level unavailable for good; its level 2
        serves the same results, so the counters and bindings agree."""
        got = {}
        for pkg in PACKAGES:
            side = Side(pkg, hosts=12)
            side.create("warmup")
            side.run()
            side.install([side.chaos.FaultSpec("dispatch", 0, "error", count=2)])
            side.create("a")
            side.run()
            restacks = side.batch.restacks
            for h in range(10):  # more than a quarter of the fleet: a re-stack
                side.agent.fail_chips(f"host-{h}", [0])
            side.create("b")
            side.run()
            assert side.batch.restacks == restacks + 1
            got[pkg] = side
        side, ref_side = got["yoda_tpu_torch"], got["yoda_tpu"]
        assert side.state() == ref_side.state() == (2, 2, 0)
        assert side.bindings() == ref_side.bindings()
        level1 = side.batch._fb_kerns[1]
        assert isinstance(level1, port.TorchFleetKernel)
        chips, _nodes = port.stack_static(side.batch._static)
        assert torch.equal(level1._chips, torch.from_numpy(chips))
        assert ref_side.batch._fb_kerns[1] is False

    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_mesh_kernel_demotes(self, pkg):
        side = Side(pkg, hosts=4, mesh_devices=1)
        side.create("warmup")
        side.run()
        assert side.batch.sharded_dispatches == 1
        side.install([side.chaos.FaultSpec("dispatch", 0, "error")])
        side.create("a")
        side.run()
        assert side.batch.sharded_dispatches == 1
        assert side.state() == (1, 1, 0)
        side.create("b")
        side.run()
        assert side.batch.sharded_dispatches == 2
        assert all(side.bindings().values())

    def test_failed_construction_skips_the_level_for_good(self, monkeypatch):
        side = Side("yoda_tpu_torch", hosts=3)
        side.create("warmup")
        side.run()
        built = []

        def broken(*args, **kw):
            built.append(args)
            raise RuntimeError("no host copy")

        monkeypatch.setattr(port_batch, "TorchFleetKernel", broken)
        side.install([side.chaos.FaultSpec("dispatch", 0, "error", count=2)])
        for name in ("a", "b", "c"):
            side.create(name)
            side.run()
        assert len(built) == 1
        assert side.batch._fb_kerns[1] is False
        assert isinstance(side.batch._fb_kerns[2], port.NumpyFleetKernel)
        assert side.state() == (2, 2, 0)
        assert all(side.bindings().values())

    def test_auto_platform_still_raises_without_a_card(self, monkeypatch):
        from yoda_tpu_torch.config import SchedulerConfig
        from yoda_tpu_torch.standalone import build_stack

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            build_stack(config=SchedulerConfig())


@pytest.fixture
def on_card(monkeypatch):
    """Every port batch plugin takes its primary for one on the card."""
    monkeypatch.setattr(port_batch.YodaBatch, "_primary_on_card", lambda self: True)


class TestCardPrimary:
    @pytest.mark.parametrize("error", [
        RuntimeError("nvcc failed to build fleet_eval.cu"),
        RuntimeError("CUDA error: an illegal memory access was encountered"),
        ValueError("fleet_eval: int32 tensors on one CUDA device expected"),
        AttributeError("evaluate_joint_plan"),
    ], ids=["build", "launch", "argument", "attribute"])
    def test_failure_is_raised_not_demoted(self, on_card, error):
        side = Side("yoda_tpu_torch", hosts=2)
        side.create("warmup")
        side.run()
        b = side.batch

        def launch(kern):
            raise error

        with pytest.raises(type(error)):
            b._dispatch(b._static, launch)
        assert side.state() == (1, 0, 0)
        assert b._fb_kerns == {} and not any(b._level_failures.values())

    def test_cycle_ends_in_error_then_binds_on_retry(self, on_card):
        side = Side("yoda_tpu_torch", hosts=2)
        side.create("warmup")
        side.run()
        plan = side.install([side.chaos.FaultSpec("dispatch", 0, "error")])
        side.create("a")
        side.run()  # the drain retries the pod once the fault has fired
        assert side.bindings()["a"] is not None
        assert side.state() == (1, 0, 0) and len(plan.fired) == 1
        sched = side.stack.scheduler
        assert [r.outcome for r in sched.stats.results] == ["bound", "error", "bound"]
        assert side.state() == (1, 0, 0) and side.batch._fb_kerns == {}

    def test_no_pin_under_a_persistent_fault(self, on_card):
        side = Side("yoda_tpu_torch", hosts=4)
        side.create("warmup")
        side.run()
        plan = side.install([side.chaos.FaultSpec("dispatch", 0, "error", count=100)])
        for i in range(4):
            side.create(f"p{i}")
            side.run()
        fired = len(plan.fired)
        assert fired >= 4  # every dispatch probes the card: nothing pins
        assert side.state() == (fired, 0, 0)
        assert not any(side.bindings()[f"p{i}"] for i in range(4))
        lines = " ".join(side.families()).replace(".0", "")
        assert "yoda_dispatch_backend_level 0" in lines
        assert "yoda_dispatch_fallback_total 0" in lines
        assert f"yoda_dispatch_errors_total {fired}" in lines
        side.batch._kern = side.batch._kern._inner
        if side.batch._resident is not None:
            side.batch._resident.kern = side.batch._kern
        side.stack.scheduler.queue.move_all_to_active(force=True)
        side.run()
        assert all(side.bindings().values())
        assert side.state() == (fired, 0, 0) and side.batch._fb_kerns == {}

    def test_mesh_kernel_is_not_demoted(self, on_card):
        side = Side("yoda_tpu_torch", hosts=4, mesh_devices=1)
        side.create("warmup")
        side.run()
        side.install([side.chaos.FaultSpec("dispatch", 0, "error")])
        side.create("a")
        side.run()
        # The failed dispatch counts no sharded dispatch; the retry does.
        assert side.batch.sharded_dispatches == 2
        assert side.state() == (1, 0, 0) and side.batch._fb_kerns == {}
        outcomes = [r.outcome for r in side.stack.scheduler.stats.results]
        assert outcomes == ["bound", "error", "bound"]
        assert all(side.bindings().values())

    def test_primary_on_the_host_is_not_on_the_card(self):
        side = Side("yoda_tpu_torch", hosts=2)
        assert not side.batch._primary_on_card()


class TestRunS:
    def test_run_s_small_on_cpu(self):
        """chip_smoke's run (s) at its small size on the host: the one-shot
        faults each served at level 1 with the pin back at 0, the breaker's
        pins at 1 and 2, the pin on ``/metrics``, every pod bound."""
        from chip_smoke import FALLBACK_SMALL, check_fallback_run, run_fallback

        run = run_fallback(FALLBACK_SMALL, reported=False)
        check_fallback_run(run, FALLBACK_SMALL)
        assert run["levels"].count(2) >= FALLBACK_SMALL["numpy"] + 1

    def test_run_s4_small_with_the_card_stood_in(self, on_card):
        """chip_smoke's (s4) at its small size, with the host primary taken
        for one on the card: each fault counted and re-raised, nothing
        demoted, every pod bound after its retry."""
        from chip_smoke import FALLBACK_SMALL, check_card_faults, run_card_faults

        check_card_faults(run_card_faults("cpu", FALLBACK_SMALL))
