"""The node-sharded fleet evaluation (yoda_tpu_torch/parallel/sharded.py and
the shard entry of the fleet evaluation) held against yoda_tpu.

Every case of ``tests/test_parallel.py`` runs on both packages from the
reference's own source (``torch_refcases.run_case``), with its exact
assertions, the port's host shards standing in for the reference's 8
virtual host devices. Left out:

- ``TestGraftEntry`` (four cases): the reference's TPU driver contract,
  ``__graft_entry__.py``, which jits the JAX kernel; the port has no such
  entry;
- on the port only, ``TestShardedBurst::test_sharded_burst_matches_single_device``:
  it builds the reference's single-device ``DeviceFleetKernel``, which the
  port calls ``TorchFleetKernel``; ``TestShardPhases`` below makes the same
  comparison on the port.

Beside them, with tolerance 0 (everything is int32): the plain shard
version at 1, 2, 4 and 8 host shards, seeded, at K = 1 and 16 and C = 8
and 64, against the reference's ``ShardedDeviceFleetKernel`` /
``ShardedFleetKernel`` on as many virtual devices and against the port's
unsharded plain version; each phase's partials against the unsharded
values they reduce to; row updates on the shards against a fresh
``put_static``; the mesh's device rules; and a seeded ``mesh_devices``
stack of singletons and gangs whose bindings equal the reference's. The
hand kernel's shard entry is held against the plain version on the card
by ``tests/test_torch_cuda.py::TestShardEntryOnCard`` and chip_smoke.py's
run (n).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_kernel import (
    MOST_ALLOCATED,
    assert_same,
    own_dyn,
    random_arrays,
    to_torch,
    torch_request,
    torch_weights,
)
from torch_refcases import PACKAGES, cases, run_case

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.types as ref_types
import yoda_tpu.config as ref_config
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent as port_agent
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.standalone as port_standalone
from yoda_tpu.config import Weights
from yoda_tpu.ops.kernel import KernelRequest
from yoda_tpu.parallel import ShardedDeviceFleetKernel as RefSharded
from yoda_tpu.parallel import ShardedFleetKernel as RefShardedFleetKernel
from yoda_tpu.parallel import default_mesh as ref_mesh
from yoda_tpu_torch.ops import cuda_kernel
from yoda_tpu_torch.ops.kernel import (
    TorchFleetKernel,
    kernel_impl,
    kernel_shard_phase,
    minmax_span,
    pack_request,
    stack_static,
)
from yoda_tpu_torch.parallel import ShardedDeviceFleetKernel, ShardedFleetKernel
from yoda_tpu_torch.parallel import default_mesh
from yoda_tpu_torch.parallel.sharded import HOST_DEVICES, _best_of

CPU = torch.device("cpu")
REF = "test_parallel.py"
GRAFT = "the reference's TPU driver contract (__graft_entry__.py); no port counterpart"
SKIP = {
    "TestGraftEntry::test_entry_compiles_and_runs": GRAFT,
    "TestGraftEntry::test_dryrun_multichip": GRAFT,
    "TestGraftEntry::test_dryrun_survives_site_hook_platform_pin": GRAFT,
    "TestGraftEntry::test_dryrun_falls_back_when_backend_preinitialized_short": GRAFT,
}
PORT_SKIP = {
    "TestShardedBurst::test_sharded_burst_matches_single_device":
        "builds the reference's DeviceFleetKernel (the port's TorchFleetKernel; "
        "TestShardPhases makes the comparison)",
}


def _reference_cases():
    out = []
    for pkg in PACKAGES:
        for c in cases(REF, SKIP):
            if pkg == "yoda_tpu_torch" and c[0] in PORT_SKIP:
                continue
            out.append(pytest.param(pkg, c, id=f"{c[0]}-{pkg}"))
    return out


@pytest.mark.parametrize("pkg,case", _reference_cases())
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


def seeded_inputs(k: int, chips: int, seed: int):
    """A 64-row reference fleet, its own dynamics rows, [K, N] admission rows
    (the last all-False when K > 1) and K requests of the four shapes
    test_torch_kernel.py uses, with the seed's generation and clock."""
    arrays = random_arrays(60, chips=chips, seed=seed)
    n_pad = arrays.node_valid.shape[0]
    rng = np.random.default_rng(seed + 100)
    host_ok_k = (rng.random((k, n_pad)) > 0.2).astype(np.int32)
    if k > 1:
        host_ok_k[-1] = 0
    table = [
        KernelRequest(1, 0, 0, 0, 0),
        KernelRequest(2, 8 * 1024, 0, 0, 0),
        KernelRequest(4, 4 * 1024, 900, 5, 1),
        KernelRequest(8, 15 * 1024, 990, 6, 0),
    ]
    reqs = [table[int(i)] for i in rng.integers(0, len(table), size=k)]
    return arrays, own_dyn(arrays), host_ok_k, reqs


class TestShardPhases:
    @pytest.mark.parametrize("shards", [1, 2, 4, 8])
    @pytest.mark.parametrize("k", [1, 16])
    @pytest.mark.parametrize("chips", [8, 64])
    def test_plain_shards_equal_reference_and_unsharded(self, shards, k, chips):
        weights = MOST_ALLOCATED if shards % 2 else Weights()
        arrays, dyn, host_ok_k, reqs = seeded_inputs(k, chips, seed=shards * 100 + k + chips)
        port_reqs = [torch_request(r) for r in reqs]
        sharded = ShardedDeviceFleetKernel(torch_weights(weights), mesh=[CPU] * shards)
        sharded.put_static(to_torch(arrays))
        got = sharded.evaluate_burst(dyn, host_ok_k, port_reqs)
        ref = RefSharded(weights, mesh=ref_mesh(shards))
        ref.put_static(arrays)
        want = ref.evaluate_burst(dyn, host_ok_k, reqs)
        single = TorchFleetKernel(torch_weights(weights), CPU)
        single.put_static(to_torch(arrays))
        unsharded = single.evaluate_burst(dyn, host_ok_k, port_reqs)
        assert len(got) == len(want) == k
        for g, w, u in zip(got, want, unsharded):
            assert_same(g, w)
            assert_same(g, u)
        assert sharded.shard_launches == 0  # host tensors take the plain version

    @pytest.mark.parametrize("shards", [1, 4, 8])
    def test_one_shot_equals_reference(self, shards):
        arrays, _dyn, _ok, reqs = seeded_inputs(1, 8, seed=shards)
        want = RefShardedFleetKernel(ref_mesh(shards), Weights())(arrays, reqs[0])
        got = ShardedFleetKernel([CPU] * shards, torch_weights(Weights()))(
            to_torch(arrays), torch_request(reqs[0])
        )
        assert_same(got, want)

    @pytest.mark.parametrize("chips", [8, 64])
    def test_partials_reduce_to_the_unsharded_values(self, chips):
        """Each phase's partials, reduced over four shards, give the values
        the single evaluation computes in between (kernel_impl's
        intermediates): the maxima, the raw bounds and the best row."""
        arrays, dyn, host_ok_k, reqs = seeded_inputs(16, chips, seed=chips)
        chips_t, nodes_t = (torch.from_numpy(x) for x in stack_static(to_torch(arrays)))
        dyn_t, ok_t = torch.from_numpy(dyn), torch.from_numpy(host_ok_k)
        reqs_t = torch.from_numpy(np.stack([pack_request(r) for r in reqs]))
        w = torch_weights(Weights())
        n, shards, k = dyn.shape[1], 4, len(reqs)
        rows = n // shards
        cols = [slice(s * rows, (s + 1) * rows) for s in range(shards)]
        outs = [torch.empty((k, 6, rows), dtype=torch.int32) for _ in cols]

        def phase(p, words, globals_=None):
            parts = []
            for s, sl in enumerate(cols):
                part = torch.empty((k, words), dtype=torch.int32)
                kernel_shard_phase(
                    chips_t[:, :, sl].contiguous(), nodes_t[:, sl].contiguous(),
                    dyn_t[:, sl].contiguous(), ok_t[:, sl].contiguous(), reqs_t, p,
                    globals_, outs[s], part, w,
                )
                parts.append(part)
            return torch.stack(parts)

        from yoda_tpu_torch.ops.kernel import _inputs_dict, _request_columns
        from yoda_tpu_torch.ops.kernel import _phase_filter, _phase_raw, _raw_bounds

        a = _inputs_dict(chips_t, nodes_t, dyn_t, ok_t)
        number, hbm, clock, gen, _topo = _request_columns(*reqs_t.unbind(1))
        feasible, _reasons, _claim, qual, maxima = _phase_filter(a, number, hbm, clock, gen)
        raw = _phase_raw(a, feasible, qual, maxima.clamp(min=1), w)
        lowest, highest = _raw_bounds(feasible, raw)

        p1 = phase(1, 6)
        assert torch.equal(p1.amax(dim=0), maxima)
        p2 = phase(2, 3, p1.amax(dim=0))
        assert torch.equal(p2[:, :, 0].amin(dim=0), lowest[:, 0])
        assert torch.equal(p2[:, :, 1].amax(dim=0), highest[:, 0])
        assert torch.equal(p2[:, :, 2].amax(dim=0) != 0, feasible.any(dim=-1))
        want = kernel_impl(a, *reqs_t.unbind(1), weights=w)
        assert torch.equal(torch.cat([o[:, 2] for o in outs], dim=1), want[2])
        low, span = minmax_span(
            p2[:, :, 0].amin(dim=0)[:, None], p2[:, :, 1].amax(dim=0)[:, None]
        )
        p3 = phase(3, 2, torch.cat([low, span], dim=1))
        assert torch.equal(torch.cat([o[:, 3] for o in outs], dim=1), want[3])
        best = _best_of(p3, rows, p2[:, :, 2].amax(dim=0) != 0)
        assert torch.equal(best, want[5])

    def test_shard_wrapper_on_cpu_launches_nothing(self):
        arrays, dyn, host_ok_k, reqs = seeded_inputs(4, 8, seed=3)
        before = cuda_kernel.shard_launches
        kern = ShardedDeviceFleetKernel(torch_weights(Weights()), mesh=[CPU] * 2)
        kern.put_static(to_torch(arrays))
        kern.evaluate_burst(dyn, host_ok_k, [torch_request(r) for r in reqs])
        assert cuda_kernel.shard_launches == before and kern.shard_launches == 0
        with pytest.raises(ValueError, match="phase"):
            cuda_kernel.fleet_eval_shard(*([None] * 5), 4, None, None, None, None)

    def test_row_updates_equal_a_fresh_upload(self):
        arrays, dyn, host_ok_k, reqs = seeded_inputs(4, 8, seed=5)
        port = to_torch(arrays)
        kern = ShardedDeviceFleetKernel(torch_weights(Weights()), mesh=[CPU] * 4)
        kern.put_static(port)
        rng = np.random.default_rng(5)
        rows = [int(r) for r in rng.choice(port.node_valid.shape[0], 9, replace=False)]
        for r in rows:
            port.hbm_free_mib[r] = rng.integers(0, 1024, size=port.hbm_free_mib.shape[1])
            port.generation_rank[r] = 6
        kern.update_rows(port, rows)
        fresh = ShardedDeviceFleetKernel(torch_weights(Weights()), mesh=[CPU] * 4)
        fresh.put_static(port)
        for a, b in zip(kern._chips + kern._nodes, fresh._chips + fresh._nodes):
            assert torch.equal(a, b)


class TestMeshDevices:
    def test_host_shards_under_cpu(self):
        assert default_mesh(8, platform="cpu") == [CPU] * HOST_DEVICES
        assert default_mesh(platform="cpu") == [CPU] * HOST_DEVICES
        with pytest.raises(ValueError, match="devices are available"):
            default_mesh(HOST_DEVICES + 1, platform="cpu")

    def test_auto_needs_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA device"):
            default_mesh(1)

    def test_an_explicit_list_may_repeat_a_device(self):
        kern = ShardedDeviceFleetKernel(torch_weights(Weights()), mesh=["cpu"] * 3)
        assert kern.n_shards() == 3 and kern.device == CPU

    def test_stack_builds_everything(self):
        stack = port_standalone.build_stack(
            config=port_config.SchedulerConfig(kernel_platform="cpu", mesh_devices=4)
        )
        try:
            assert stack.not_built == ()
            assert isinstance(stack.batch._kern, ShardedDeviceFleetKernel)
            assert stack.batch.device == CPU
        finally:
            stack.close()


SIDES = {
    "yoda_tpu": (ref_standalone, ref_config, ref_agent, ref_types),
    "yoda_tpu_torch": (port_standalone, port_config, port_agent, port_types),
}


def mesh_script(pkg: str, mesh: "int | None", seed: int = 13) -> dict:
    """A seeded stack run at K = 8: 24 v5e hosts of 8 chips and two v5p
    2x2x1 slices, two waves of singletons, two co-queued plain gangs of
    4 x 8 chips and a topology gang; returns pod -> node."""
    standalone, config, agent_mod, types = SIDES[pkg]
    cfg = config.SchedulerConfig(mesh_devices=mesh, batch_requests=8)
    if pkg == "yoda_tpu_torch":
        cfg = config.SchedulerConfig(
            mesh_devices=mesh, batch_requests=8, kernel_platform="cpu"
        )
    stack = standalone.build_stack(config=cfg)
    agent = agent_mod.FakeTpuAgent(stack.cluster)
    for h in range(24):
        agent.add_host(f"v5e-{h:02d}", generation="v5e", chips=8)
    for s in range(2):
        agent.add_slice(f"v5p-{s}", generation="v5p", host_topology=(2, 2, 1))
    agent.publish_all()
    rng = np.random.default_rng(seed)
    for wave in range(2):
        for i in range(12):
            labels = {"tpu/chips": str(int(rng.choice([1, 2, 4])))}
            if rng.random() < 0.5:
                labels["tpu/hbm"] = f"{int(rng.integers(1, 12))}Gi"
            stack.cluster.create_pod(types.PodSpec(f"s{wave}-{i}", labels=labels))
        if wave == 0:
            for g in range(2):
                for m in range(4):
                    stack.cluster.create_pod(types.PodSpec(
                        f"g{g}-{m}",
                        labels={"tpu/chips": "8", "tpu/gang": f"g{g}", "tpu/gang-size": "4"},
                    ))
        else:
            for m in range(4):
                stack.cluster.create_pod(types.PodSpec(f"t-{m}", labels={
                    "tpu/gang": "t", "tpu/topology": "2x2x1", "tpu/chips": "4",
                    "tpu/generation": "v5p",
                }))
        stack.scheduler.run_until_idle(max_wall_s=60)
    bound = {p.name: p.node_name for p in stack.cluster.list_pods()}
    if pkg == "yoda_tpu_torch":
        assert stack.batch.sharded_dispatches == (stack.batch.dispatch_count if mesh else 0)
        stack.close()
    return bound


class TestMeshStackParity:
    @pytest.mark.parametrize("mesh", [2, 8])
    def test_bindings_equal_reference(self, mesh):
        got = mesh_script("yoda_tpu_torch", mesh)
        assert got == mesh_script("yoda_tpu", mesh)
        assert got == mesh_script("yoda_tpu_torch", None)
        assert all(got.values())


class TestRunN:
    """chip_smoke's run (n2) at its small size on the CPU: a
    ``mesh_devices: 1`` stack binds run (b)'s pods (cut to 32) as a default
    stack does, every sharded evaluation equal to the unsharded plain
    version on the same inputs."""

    def test_mesh_stack_binds_as_the_default_stack(self):
        from chip_smoke import (
            SHARD_SMALL,
            build_fleet,
            check_sharded_stack,
            fleet_and_pods,
            run_sharded_stack,
        )
        from yoda_tpu_torch.api.types import PodSpec

        pods = fleet_and_pods(seed=0)[1][:32]
        stack, _ = build_fleet("cpu", 16, **SHARD_SMALL)
        for name, labels in pods:
            stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
        stack.scheduler.run_until_idle(max_wall_s=120)
        want = {n: stack.cluster.get_pod(f"default/{n}").node_name for n, _ in pods}
        stack.close()
        run = run_sharded_stack("cpu", SHARD_SMALL, pods)
        check_sharded_stack(run, want)
        assert run["checked_calls"] == run["dispatch_count"] > 0


class TestMeshFamilies:
    def test_mesh_stack_counts_sharded_dispatches_like_the_reference(self):
        """``yoda_sharded_dispatches_total`` moves with every dispatch of a
        ``mesh_devices`` stack in both packages, with the same families."""
        from chip_smoke import close_stack
        from test_torch_observability import PORT_ONLY, scrape

        got = {}
        for pkg in PACKAGES:
            standalone, config, agent_mod, types = SIDES[pkg]
            stack = standalone.build_stack(
                config=config.SchedulerConfig(mesh_devices=4, kernel_platform="cpu")
            )
            agent = agent_mod.FakeTpuAgent(stack.cluster)
            for h in range(4):
                agent.add_host(f"h{h}", generation="v5e", chips=8)
            agent.publish_all()
            for i in range(3):
                stack.cluster.create_pod(types.PodSpec(f"p{i}", labels={"tpu/chips": "2"}))
            stack.scheduler.run_until_idle(max_wall_s=30)
            fams, samples = scrape(stack.metrics.registry.render_prometheus())
            if pkg == "yoda_tpu_torch":
                fams = {k: v for k, v in fams.items() if k not in PORT_ONLY}
            got[pkg] = (fams, samples[("yoda_sharded_dispatches_total", ())])
            close_stack(stack)
        assert got["yoda_tpu"] == got["yoda_tpu_torch"]
        assert got["yoda_tpu_torch"][1] == 3
