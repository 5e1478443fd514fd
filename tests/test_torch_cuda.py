"""The hand-written CUDA kernels (yoda_tpu_torch/csrc/fleet_eval.cu and
joint_fit.cu) against their plain PyTorch versions on the same tensors,
tolerance 0 (everything is int32), and the wrappers' contracts; and the
resident state's in-place row update (TorchFleetKernel.update_rows)
against a fresh put_static, at chip_smoke.py's fleets and row sets; and
the speculative placement cache's private kernel on its own stream, alone
and beside the serve path's launches from a second thread (run (h)); and
the node health path (run (i)): a fence flip patches the admission rows
the card's kernels read, with no re-stack and no row update, and the
whole run decides as on the CPU; and the lanes as worker processes (run
(p) at its small size), each launching on the card; and federation and the
node agents (run (r) at its small size), every member stack on the card;
and the degraded-mode dispatch chain (run (s) at its small size): every
result a host-primary stack demoted held against the hand kernels on its
own inputs, and faults on a card stack counted and re-raised, never
demoted.

Tests marked ``cuda`` need the card and skip without one; run them there
with ``python -m pytest -m cuda tests/test_torch_cuda.py``. This file
imports neither JAX nor yoda_tpu, so it runs on a machine without JAX."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from chip_smoke import (
    AFFINITY_SMALL,
    BACKGROUND_SMALL,
    NODEHEALTH_SMALL,
    build_fleet,
    check_background,
    check_nodehealth,
    concurrent_eval,
    hot_pod,
    run_background,
    run_nodehealth,
    UPDATE_FLEETS,
    UPDATE_ROWS,
    identical_rows_case,
    check_affinity,
    joint_case,
    run_affinity,
    run_wide_fleet,
    slice_edge_case,
    update_rows_check,
)
from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.config import SchedulerConfig, Weights
from yoda_tpu_torch.ops import cuda_kernel
from yoda_tpu_torch.ops import kernel as kernel_mod
from yoda_tpu_torch.ops.cuda_kernel import fleet_eval, joint_fit
from yoda_tpu_torch.ops.kernel import (
    KernelRequest,
    TorchFleetKernel,
    joint_fit_scan,
    kernel_packed_burst,
)
from yoda_tpu_torch.standalone import build_stack

MOST_ALLOCATED = SchedulerConfig(scoring_strategy="most-allocated").effective_weights()
REQUESTS = np.array(
    [[1, 0, 0, 0, 0], [2, 8192, 0, 0, 0], [4, 4096, 900, 5, 1], [8, 15360, 990, 6, 0]],
    dtype=np.int32,
)


def stacked_fleet(n_real: int, n_pad: int, k: int, seed: int, chips: int = 8):
    """Seeded inputs in the device layout: chips [9, C, N], nodes [4, N],
    dyn [4, N], host_ok [K, N] (an all-False padding row when K > 1) and
    reqs [K, 5]."""
    rng = np.random.default_rng(seed)
    valid = np.zeros(n_pad, dtype=np.int32)
    valid[:n_real] = 1
    grid = (chips, n_pad)
    total = np.full(grid, 16 * 1024, dtype=np.int32)
    free = (total - rng.integers(0, 16 * 1024, size=grid)).astype(np.int32)
    chip_rows = np.stack(
        [
            np.broadcast_to(valid, grid),
            valid * (rng.random(grid) > 0.1),
            free < total,
            free,
            total,
            rng.integers(700, 1000, size=grid),
            rng.integers(400, 900, size=grid),
            rng.integers(100, 300, size=grid),
            rng.integers(100, 200, size=grid),
        ]
    ).astype(np.int32) * valid
    nodes = np.stack(
        [valid, rng.random(n_pad) > 0.5, rng.integers(2, 7, size=n_pad),
         rng.integers(0, 3, size=n_pad)]
    ).astype(np.int32)
    dyn = np.stack(
        [valid * (rng.random(n_pad) > 0.05), rng.integers(0, 4, size=n_pad),
         rng.integers(0, 64 * 1024, size=n_pad), np.zeros(n_pad)]
    ).astype(np.int32)
    host_ok = (rng.random((k, n_pad)) > 0.2).astype(np.int32)
    if k > 1:
        host_ok[-1] = 0
    reqs = REQUESTS[np.arange(k) % len(REQUESTS)]
    return [np.ascontiguousarray(x) for x in (chip_rows, nodes, dyn, host_ok, reqs)]


def on(device, arrays):
    return [torch.from_numpy(x).to(device) for x in arrays]


def fleet_arrays(chips, nodes, dyn, host_ok, n_real: int):
    """The stacked inputs as the FleetArrays TorchFleetKernel.put_static takes."""
    from yoda_tpu_torch.ops.arrays import FleetArrays

    fields = {k: chips[i].T for i, k in enumerate(
        ("chip_valid", "chip_healthy", "chip_used", "hbm_free_mib",
         "hbm_total_mib", "clock_mhz", "hbm_bandwidth", "tflops", "power_w"))}
    fields.update(
        names=[f"n{i}" for i in range(n_real)], node_valid=nodes[0],
        in_slice=nodes[1], generation_rank=nodes[2], ext_chips=nodes[3],
        fresh=dyn[0], reserved_chips=dyn[1], claimed_hbm_mib=dyn[2],
        host_ok=host_ok[0], last_updated=np.zeros(dyn.shape[1]),
    )
    return FleetArrays.from_numpy(fields)


def widen_metrics(inputs, seed: int):
    """Bandwidth and HBM large enough that x * 100 and the weighted sums
    wrap int32, in place."""
    rng = np.random.default_rng(seed)
    chips = inputs[0]
    valid = chips[0] != 0
    chips[6] = np.where(valid, rng.integers(10**7, 4 * 10**7, size=chips[6].shape), 0)
    chips[4] = np.where(valid, rng.integers(2 * 10**7, 3 * 10**7, size=chips[4].shape), 0)
    chips[3] = np.where(valid, chips[4] - rng.integers(0, 10**7, size=chips[4].shape), 0)
    chips[2] = chips[3] < chips[4]
    return inputs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernel has no CPU mode)")
    return torch.device("cuda", 0)


class TestWrapperOnCpu:
    def test_cpu_tensors_take_the_plain_version(self):
        args = on("cpu", stacked_fleet(37, 64, 4, seed=1))
        before = cuda_kernel.launches
        got = fleet_eval(*args, Weights())
        assert cuda_kernel.launches == before
        assert torch.equal(got, kernel_packed_burst(*args, Weights()))
        assert got.shape == (4, 6, 64) and got.dtype == torch.int32

    def test_cpu_output_buffer_and_chunking_need_no_card(self):
        args = on("cpu", stacked_fleet(37, 64, 150, seed=3))
        out = torch.full((150, 6, 64), -1, dtype=torch.int32)
        before = cuda_kernel.launches
        assert fleet_eval(*args, Weights(), out=out) is out
        assert cuda_kernel.launches == before
        assert torch.equal(out, kernel_packed_burst(*args, Weights()))

    def test_cpu_calls_leave_the_owner_count(self):
        owner = TorchFleetKernel(Weights(), torch.device("cpu"))
        fleet_eval(*on("cpu", stacked_fleet(37, 64, 150, seed=3)), Weights(), counter=owner)
        case = [torch.from_numpy(x) for x in joint_case(8, 64, seed=3)]
        joint_fit(*case, counter=owner)
        assert (owner.launches, owner.joint_fit_launches) == (0, 0)

    def test_other_devices_are_refused(self):
        args = [t.to("meta") for t in on("cpu", stacked_fleet(8, 8, 1, seed=2))]
        with pytest.raises(ValueError, match="no fleet evaluation"):
            fleet_eval(*args, Weights())


@pytest.mark.cuda
class TestHandKernel:
    @pytest.mark.parametrize(
        "n_real,n_pad,k",
        [
            (37, 64, 1),
            (256, 256, 8),
            (5000, 8192, 16),
            (1, 1, 1),             # smaller than one tile
            (37, 37, 1),
            (37, 37, 16),
            (100, 100, 4),         # not a multiple of the tile
            (5000, 5000, 16),
            (5000, 8192, 1),
            (262144, 262144, 4),   # blocks walk several tiles
        ],
    )
    @pytest.mark.parametrize(
        "weights", [Weights(), MOST_ALLOCATED], ids=["least", "most"]
    )
    def test_equals_plain(self, card, n_real, n_pad, k, weights):
        args = on(card, stacked_fleet(n_real, n_pad, k, seed=n_pad + k))
        before = cuda_kernel.launches
        got = fleet_eval(*args, weights)
        assert cuda_kernel.launches == before + 1
        want = kernel_packed_burst(*args, weights)
        torch.cuda.synchronize()
        assert torch.equal(got, want)

    def test_int32_wraparound(self, card):
        args = on(card, widen_metrics(stacked_fleet(300, 512, 4, seed=7), seed=7))
        for w in (Weights(hbm_bandwidth=900, actual=7), MOST_ALLOCATED):
            assert torch.equal(fleet_eval(*args, w), kernel_packed_burst(*args, w))

    def test_nothing_feasible_gives_no_best_row(self, card):
        inputs = stacked_fleet(37, 64, 2, seed=3)
        inputs[3][:] = 0
        got = fleet_eval(*on(card, inputs), Weights())
        assert int(got[:, 0].sum()) == 0
        assert (got[:, 4] == -1).all()

    def test_fleet_kernel_on_card_equals_cpu(self, card):
        chips, nodes, dyn, host_ok, reqs = stacked_fleet(100, 128, 4, seed=5)
        arrays = fleet_arrays(chips, nodes, dyn, host_ok, 100)
        requests = [KernelRequest(*map(int, r)) for r in reqs]
        out = []
        for device in (card, torch.device("cpu")):
            kern = TorchFleetKernel(Weights(), device)
            kern.put_static(arrays)
            out.append(kern.evaluate_burst(dyn, host_ok, requests))
        for g, c in zip(*out):
            for f in dataclasses.fields(g):
                np.testing.assert_array_equal(getattr(g, f.name), getattr(c, f.name))

    def test_wrapper_checks_its_inputs(self, card):
        args = on(card, stacked_fleet(8, 8, 1, seed=4))
        bad_dtype = list(args)
        bad_dtype[2] = args[2].long()
        with pytest.raises(TypeError, match="int32"):
            fleet_eval(*bad_dtype, Weights())
        bad_shape = list(args)
        bad_shape[3] = args[3][:, :4]
        with pytest.raises(ValueError, match="shape"):
            fleet_eval(*bad_shape, Weights())
        strided = list(args)
        strided[4] = torch.zeros((1, 10), dtype=torch.int32, device=card)[:, ::2]
        with pytest.raises(ValueError, match="contiguous"):
            fleet_eval(*strided, Weights())

    @pytest.mark.parametrize(
        "chips,k",
        [(4, 4), (16, 4), (32, 4), (32, 16),
         # Past one 32-bit mask: the wide instantiation, staged at K = 1 and
         # 16 (64 chips), from global memory at K = 144 (128-row chunks past
         # the shared-memory slot) and at 128 chips.
         (64, 1), (64, 16), (64, 144), (128, 1), (128, 16), (128, 144)],
    )
    def test_chip_counts_equal_plain(self, card, chips, k):
        args = on(card, stacked_fleet(300, 512, k, seed=chips + k, chips=chips))
        for w in (Weights(), MOST_ALLOCATED):
            assert torch.equal(fleet_eval(*args, w), kernel_packed_burst(*args, w))
        if chips > 32:
            plan = cuda_kernel.launch_plan(512, chips, min(k, 128), card)
            assert plan["resident"] == (1 if chips == 64 and k <= 16 else 0), plan

    def test_wide_nodes_at_the_int32_edges(self, card):
        args = on(card, widen_metrics(stacked_fleet(300, 512, 16, seed=14, chips=64), seed=14))
        for w in (Weights(hbm_bandwidth=900, actual=7), MOST_ALLOCATED):
            assert torch.equal(fleet_eval(*args, w), kernel_packed_burst(*args, w))

    def test_large_fleet_walks_tiles(self, card):
        plan = cuda_kernel.launch_plan(262144, 8, 4, card)
        assert plan["walk"] > 1
        assert plan["grid"] * plan["walk"] * cuda_kernel.TILE_NODES >= 262144
        assert plan["grid"] <= 262144 // cuda_kernel.TILE_NODES

    @pytest.mark.parametrize("k", [1, 16])
    def test_int32_wraparound_at_main_path_width(self, card, k):
        args = on(card, widen_metrics(stacked_fleet(5000, 8192, k, seed=8), seed=8))
        for w in (Weights(hbm_bandwidth=900, actual=7), MOST_ALLOCATED):
            assert torch.equal(fleet_eval(*args, w), kernel_packed_burst(*args, w))

    @pytest.mark.parametrize("k", [1, 16])
    def test_metrics_over_the_whole_int32_range(self, card, k):
        """Cluster maxima from 1 to 2**31 - 1 and negative metrics: the
        kernel's division by per-request constants against floor division."""
        inputs = stacked_fleet(3000, 4096, k, seed=10)
        rng = np.random.default_rng(10)
        chips = inputs[0]
        valid = chips[0] != 0
        full = (-(2**31), 2**31 - 1)
        for row in (6, 7, 8):  # bw, tflops, power
            chips[row] = np.where(valid, rng.integers(*full, size=chips[row].shape), 0)
        chips[7][:, ::3] = np.where(valid[:, ::3], 2**31 - 1, 0)
        args = on(card, inputs)
        for w in (Weights(), MOST_ALLOCATED):
            assert torch.equal(fleet_eval(*args, w), kernel_packed_burst(*args, w))

    @pytest.mark.parametrize("k", [1, 16])
    def test_every_row_infeasible(self, card, k):
        inputs = stacked_fleet(5000, 8192, k, seed=6)
        inputs[3][:] = 0
        args = on(card, inputs)
        got = fleet_eval(*args, Weights())
        assert torch.equal(got, kernel_packed_burst(*args, Weights()))
        assert int(got[:, 0].sum()) == 0
        assert (got[:, 4] == -1).all()

    def test_padding_row_is_infeasible(self, card):
        args = on(card, stacked_fleet(5000, 8192, 16, seed=9))
        got = fleet_eval(*args, Weights())
        assert torch.equal(got, kernel_packed_burst(*args, Weights()))
        assert int(got[-1, 0].sum()) == 0
        assert (got[-1, 1, :5000] == 8).all()  # REASON_NODE
        assert (got[-1, 4] == -1).all()

    def test_shrinking_fleets_on_one_stream(self, card):
        """Scratch and outputs come from torch.empty; a call that read
        anything an earlier, larger call left behind would show here."""
        for n_real, n_pad, k in [(65536, 65536, 16), (5000, 8192, 16), (900, 1000, 16),
                                 (37, 37, 4), (1, 1, 1)]:
            args = on(card, stacked_fleet(n_real, n_pad, k, seed=n_pad))
            got = fleet_eval(*args, Weights())
            assert torch.equal(got, kernel_packed_burst(*args, Weights())), n_pad

    def test_results_survive_the_next_evaluation(self, card):
        chips, nodes, dyn, host_ok, reqs = stacked_fleet(300, 512, 4, seed=12)
        kern = TorchFleetKernel(Weights(), card)
        kern.put_static(fleet_arrays(chips, nodes, dyn, host_ok, 300))
        requests = [KernelRequest(*map(int, r)) for r in reqs]
        first = kern.evaluate_burst(dyn, host_ok, requests)
        kept = [dataclasses.replace(r, **{
            f.name: np.copy(getattr(r, f.name)) for f in dataclasses.fields(r)
            if isinstance(getattr(r, f.name), np.ndarray)}) for r in first]
        other = (1 - host_ok).astype(np.int32)
        kern.evaluate_burst(dyn, other, requests[::-1])
        for r, k in zip(first, kept):
            for f in dataclasses.fields(r):
                np.testing.assert_array_equal(getattr(r, f.name), getattr(k, f.name))

    def test_affinity_run_binds_as_on_cpu(self, card):
        """chip_smoke's run (g) on a fleet of 160 hosts: inter-pod
        affinity, spread, volume and budget pods bind, evict and are
        refused on the card as on the CPU, and every evaluation launched
        the kernel."""
        got, want = run_affinity("auto", AFFINITY_SMALL), run_affinity("cpu", AFFINITY_SMALL)
        check_affinity(got, want, AFFINITY_SMALL)
        assert got["fleet_calls_k1"] > 0

    @pytest.mark.parametrize("burst", [1, 16])
    def test_wide_fleet_stack_binds_as_on_cpu(self, card, burst):
        """Hosts of 40 chips beside hosts of 8: the fleet pads to 64 chips a
        node and every evaluation takes the wide kernel."""
        got, want = run_wide_fleet("auto", burst), run_wide_fleet("cpu", burst)
        assert got["chip_bucket"] == 64
        assert got["bindings"] == want["bindings"]
        assert got["launches"] == got["dispatch_count"] > 0
        assert got["dispatch_errors"] == 0

    @pytest.mark.parametrize("burst", [1, 8])
    def test_config5_preemption_as_on_cpu(self, card, burst):
        """BASELINE config 5 through the card: two training gangs displace
        the inference pods that fill the pool, with the CPU run's bindings
        and evictions."""

        def run(platform):
            stack = build_stack(config=SchedulerConfig(
                kernel_platform=platform, batch_requests=burst))
            agent = FakeTpuAgent(stack.cluster)
            for h in range(8):
                agent.add_host(f"v5e-{h}", generation="v5e", chips=8)
            agent.publish_all()
            names = [f"infer-{i}" for i in range(32)]
            for name in names:
                stack.cluster.create_pod(
                    PodSpec(name, labels={"tpu/chips": "2", "tpu/priority": "1"}))
            stack.scheduler.run_until_idle(max_wall_s=30)
            for g in range(2):
                for m in range(4):
                    names.append(f"train{g}-{m}")
                    stack.cluster.create_pod(PodSpec(names[-1], labels={
                        "tpu/gang": f"job-{g}", "tpu/gang-size": "4", "tpu/chips": "8",
                        "tpu/priority": "100"}))
            before = cuda_kernel.launches
            stack.scheduler.run_until_idle(max_wall_s=60)
            pods = {n: stack.cluster.get_pod(f"default/{n}") for n in names}
            return dict(
                bindings={n: p.node_name if p else "evicted" for n, p in pods.items()},
                preempted=stack.preemption.preempted_total,
                nominations=stack.scheduler.stats.preempt_nominations,
                launches=cuda_kernel.launches - before,
            )

        got, want = run("auto"), run("cpu")
        assert got["launches"] > 0 and want["launches"] == 0
        got.pop("launches"), want.pop("launches")
        assert got == want
        assert got["preempted"] == 32
        assert all(got["bindings"][f"train{g}-{m}"] for g in range(2) for m in range(4))

    @pytest.mark.parametrize("burst", [1, 8])
    def test_stack_schedules_through_the_kernel(self, card, burst):
        stack = build_stack(config=SchedulerConfig(batch_requests=burst))
        assert stack.batch.device.type == "cuda"
        agent = FakeTpuAgent(stack.cluster)
        for h in range(16):
            agent.add_host(f"h{h:02d}", chips=8)
        agent.publish_all()
        for i in range(24):
            stack.cluster.create_pod(
                PodSpec(f"p{i}", labels={"tpu/chips": "2", "tpu/hbm": "2Gi"})
            )
        before = cuda_kernel.launches
        stack.scheduler.run_until_idle(max_wall_s=60)
        assert all(p.node_name for p in stack.cluster.list_pods())
        assert cuda_kernel.launches - before == stack.batch.dispatch_count > 0
        assert stack.batch.dispatch_errors == 0


def assert_joint_equal(card, packed, chips, starts, valid):
    before = cuda_kernel.joint_fit_launches
    got = joint_fit(packed, chips, starts, valid)
    assert cuda_kernel.joint_fit_launches == before + 1
    want = joint_fit_scan(packed[:, 0], packed[:, 3], packed[:, 5], chips, starts, valid)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(torch.int32)), tuple(packed.shape)
    return got


@pytest.mark.cuda
class TestJointFitKernel:
    @pytest.mark.parametrize(
        "k,n",
        [
            (1, 1), (3, 37), (16, 5000), (64, 8192), (256, 8192), (64, 65536),
            (16, 262144),  # past the shared-memory ledgers
            (64, 8191),    # rows misaligned for the bulk copies
        ],
    )
    def test_equals_plain(self, card, k, n):
        assert_joint_equal(
            card, *(torch.from_numpy(x).to(card) for x in joint_case(k, n, seed=k + n))
        )

    def test_identical_rows_take_the_next_best_host(self, card):
        args = [torch.from_numpy(x).to(card) for x in identical_rows_case()]
        picks, gok, _sim = assert_joint_equal(card, *args)
        feas, scores = args[0][0, 0].cpu().numpy(), args[0][0, 3].cpu().numpy()
        order = sorted(np.flatnonzero(feas), key=lambda j: (-int(scores[j]), j))
        assert picks.cpu().tolist() == order[: len(picks)]
        assert bool(gok.all())

    def test_top_score_ties_across_slice_edges(self, card):
        n = 8192
        slice_words = cuda_kernel.joint_fit_plan(n, card)["slice"]
        args = [torch.from_numpy(x).to(card) for x in slice_edge_case(64, n, slice_words)]
        picks = assert_joint_equal(card, *args)[0].cpu().tolist()
        edges = list(range(slice_words, n, slice_words))
        half = min(len(edges), 32)
        assert picks[:half] == edges[:half]  # e - 1 infeasible: e wins

    def test_plan_moves_ledgers_to_global_past_the_shared_ceiling(self, card):
        optin = torch.cuda.get_device_properties(card).shared_memory_per_block_optin
        for n, shared in ((1, 1), (37, 1), (8192, 1), (65536, 1), (262144, 0)):
            plan = cuda_kernel.joint_fit_plan(n, card)
            assert plan["shared_ledgers"] == shared, (n, plan)
            assert plan["blocks"] in (1, 2, 4, 8, 16)
            assert plan["slice"] % 4 == 0 and plan["blocks"] * plan["slice"] >= n
            assert plan["chunks"] * plan["chunk"] >= plan["slice"]
            assert 1 <= plan["stages"] <= 8 and plan["smem_bytes"] <= optin
        assert cuda_kernel.joint_fit_plan(1, card)["blocks"] == 1
        assert cuda_kernel.joint_fit_plan(65536, card)["blocks"] in (8, 16)

    @pytest.mark.parametrize("k", [144, 256])
    def test_fleet_eval_chunks_past_128_requests(self, card, k):
        args = on(card, stacked_fleet(5000, 8192, k, seed=k))
        before = cuda_kernel.launches
        got = fleet_eval(*args, Weights())
        assert cuda_kernel.launches == before + 2
        assert torch.equal(got, kernel_packed_burst(*args, Weights()))

    def test_evaluate_joint_plan_on_card_equals_cpu(self, card):
        chips, nodes, dyn, host_ok, _reqs = stacked_fleet(300, 512, 1, seed=21)
        arrays = fleet_arrays(chips, nodes, dyn, host_ok, 300)
        rng = np.random.default_rng(21)
        sizes = [5, 9, 3, 12]
        groups = [(rng.random((s, 512)) > 0.2).astype(np.int32) for s in sizes]
        requests = [
            [KernelRequest(*map(int, REQUESTS[int(rng.integers(0, 4))])) for _ in range(s)]
            for s in sizes
        ]
        out = []
        for device in (card, torch.device("cpu")):
            kern = TorchFleetKernel(Weights(), device)
            kern.put_static(arrays)
            before = cuda_kernel.joint_fit_launches
            out.append(kern.evaluate_joint_plan(dyn, groups, requests, 16))
            assert cuda_kernel.joint_fit_launches == before + (device.type == "cuda")
        (g_rows, g_fits, g_picks), (c_rows, c_fits, c_picks) = out
        assert g_fits == c_fits
        for gp, cp in zip(g_picks, c_picks):
            np.testing.assert_array_equal(gp, cp)
        for gg, cg in zip(g_rows, c_rows):
            for g, c in zip(gg, cg):
                for f in dataclasses.fields(g):
                    np.testing.assert_array_equal(getattr(g, f.name), getattr(c, f.name))

    def test_second_call_does_not_overwrite_kept_rows(self, card):
        chips, nodes, dyn, host_ok, _reqs = stacked_fleet(300, 512, 1, seed=22)
        kern = TorchFleetKernel(Weights(), card)
        kern.put_static(fleet_arrays(chips, nodes, dyn, host_ok, 300))
        groups = [np.ones((4, 512), dtype=np.int32), np.ones((3, 512), dtype=np.int32)]
        requests = [[KernelRequest(2, 0, 0, 0, 0)] * 4, [KernelRequest(1, 0, 0, 0, 0)] * 3]
        rows, fits, picks = kern.evaluate_joint_plan(dyn, groups, requests)
        kept = [[r.scores.copy() for r in g] for g in rows]
        kept_picks = [p.copy() for p in picks]
        kern.evaluate_joint_plan(dyn, [1 - g for g in groups], requests[::-1])
        for g, k in zip(rows, kept):
            for r, scores in zip(g, k):
                np.testing.assert_array_equal(r.scores, scores)
        for p, k in zip(picks, kept_picks):
            np.testing.assert_array_equal(p, k)

    def test_joint_gang_pass_launches_the_scan(self, card):
        stack = build_stack(config=SchedulerConfig(batch_requests=16))
        agent = FakeTpuAgent(stack.cluster)
        for h in range(6):
            agent.add_host(f"h{h}", chips=8)
        agent.publish_all()
        for g in range(3):  # 3 x 4 x 4 chips over 48: the third gang parks
            for i in range(4):
                stack.cluster.create_pod(PodSpec(f"g{g}-{i}", labels={
                    "tpu/gang": f"g{g}", "tpu/gang-size": "4", "tpu/chips": "4" if g < 2 else "8",
                }))
        before = cuda_kernel.joint_fit_launches
        stack.scheduler.run_until_idle(max_wall_s=30)
        b = stack.batch
        assert b.fused_plan_dispatches >= 1
        assert cuda_kernel.joint_fit_launches - before == b.fused_plan_dispatches
        assert b.dispatch_errors == 0
        for g in range(3):
            nodes = [stack.cluster.get_pod(f"default/g{g}-{i}").node_name for i in range(4)]
            assert all(nodes) or not any(nodes)


@pytest.mark.cuda
class TestRowUpdateOnCard:
    @pytest.mark.parametrize("n_real, n_pad", UPDATE_FLEETS)
    @pytest.mark.parametrize("r", UPDATE_ROWS)
    def test_update_rows_equals_put_static(self, card, n_real, n_pad, r):
        before = kernel_mod.row_update_launches
        update_rows_check(n_real, n_pad, r, card)
        assert kernel_mod.row_update_launches == before + 1

    def test_stack_delta_syncs_update_rows_on_card(self, card):
        stack = build_stack(config=SchedulerConfig(batch_requests=4))
        agent = FakeTpuAgent(stack.cluster)
        for h in range(6):
            agent.add_host(f"h{h}", chips=8)
        agent.publish_all()
        stack.cluster.create_pod(PodSpec("warm", labels={"tpu/chips": "1"}))
        stack.scheduler.run_until_idle(max_wall_s=30)
        before = kernel_mod.row_update_launches
        for h in range(3):
            agent.set_chip_health(f"h{h}", 0, False)
            agent.refresh(f"h{h}")
            stack.cluster.create_pod(PodSpec(f"p{h}", labels={"tpu/chips": "2"}))
            stack.scheduler.run_until_idle(max_wall_s=30)
        r = stack.batch._resident
        assert r is not None and r.restacks == 1 and r.delta_syncs >= 3
        assert kernel_mod.row_update_launches - before == r.delta_syncs


class TestRowUpdateOnCpu:
    @pytest.mark.parametrize("r", [1, 3, 40])
    def test_update_rows_equals_put_static(self, r):
        before = kernel_mod.row_update_launches
        update_rows_check(300, 512, r, torch.device("cpu"))
        assert kernel_mod.row_update_launches == before  # counts the card only


def small_spec_stack(platform: str):
    """chip_smoke's fleet at the tests' size with one K = 1 pod of each hot
    shape served, so the cache tracks the four shapes."""
    stack, _agent = build_fleet(platform, 1, slices=BACKGROUND_SMALL["slices"],
                                v5e_hosts=BACKGROUND_SMALL["v5e_hosts"])
    for i, chips in enumerate((1, 2, 4, 8)):
        stack.cluster.create_pod(hot_pod(f"seen{i}", chips))
    stack.scheduler.run_until_idle(max_wall_s=60)
    return stack


def plan_view(spec) -> list:
    return sorted((int(k[1].number), p.node, p.base_reserved, p.score)
                  for k, p in spec._plans.items())


@pytest.mark.cuda
class TestSpeculationOnCard:
    def test_private_kernel_runs_on_its_own_stream(self, card, monkeypatch):
        stack = small_spec_stack("auto")
        spec = stack.speculation
        assert spec.kernel.device.type == "cuda"
        assert spec._stream is not None
        assert spec._stream != torch.cuda.default_stream(card)
        seen = []
        real = cuda_kernel.fleet_eval

        def noting(*args, **kw):
            seen.append(torch.cuda.current_stream(card))
            return real(*args, **kw)

        monkeypatch.setattr(cuda_kernel, "fleet_eval", noting)
        before, serve_before = spec.kernel.launches, stack.batch._kern.launches
        assert spec.speculate_once() == 4
        assert spec.kernel.launches - before == 4  # one K = 1 launch a shape
        assert stack.batch._kern.launches == serve_before
        assert seen and all(s == spec._stream for s in seen)

    def test_plans_equal_a_cpu_cache(self, card):
        got, want = small_spec_stack("auto"), small_spec_stack("cpu")
        for stack in (got, want):
            stack.speculation.speculate_once()
        assert plan_view(got.speculation) == plan_view(want.speculation)
        assert got.speculation.stats() == want.speculation.stats()
        assert want.speculation.kernel.launches == 0

    def test_two_threads_get_the_plain_result(self, card):
        """fleet_eval from the cache's stream while a second thread launches
        fleet_eval at K = 16 and joint_fit on the default stream: every
        result of both threads equals the plain version (concurrent_eval
        raises otherwise)."""
        stack = small_spec_stack("auto")
        spec = stack.speculation
        spec.speculate_once()
        kept = []
        inner = spec.kernel.evaluate
        spec.kernel.evaluate = lambda dyn, req: kept.append((np.array(dyn), req)) or inner(dyn, req)
        spec.speculate_once()
        spec.kernel.evaluate = inner
        got = concurrent_eval(stack, spec, kept[-1], calls=20)
        assert got["serve_thread_calls_in_windows"] > 0

    def test_run_h_small_as_on_cpu(self, card):
        """chip_smoke's run (h) at the tests' size: (h1)-(h3) equal to the
        CPU run, (h4) holds its invariants with both threads launching."""
        got = run_background("auto", BACKGROUND_SMALL)
        want = run_background("cpu", BACKGROUND_SMALL, threaded=False)
        check_background(got, want, BACKGROUND_SMALL)
        assert got["h4"]["serve_joint_fit_launches"] > 0

    def test_owner_counts_move_at_the_launch(self, card):
        """A wrapper given a ``counter`` adds each launch to it: one per
        128-row chunk of fleet_eval, one per joint_fit."""
        owner = TorchFleetKernel(Weights(), card)
        chips, nodes, dyn, host_ok, reqs = on(card, stacked_fleet(300, 512, 144, seed=5))
        packed = fleet_eval(chips, nodes, dyn, host_ok, reqs, Weights(), counter=owner)
        assert (owner.launches, owner.joint_fit_launches) == (2, 0)
        case = [torch.from_numpy(x).to(card) for x in joint_case(16, 512, seed=5)]
        joint_fit(*case, counter=owner)
        assert (owner.launches, owner.joint_fit_launches) == (2, 1)
        assert packed.shape == (144, 6, 512)


@pytest.mark.cuda
class TestNodeHealthOnCard:
    def test_fence_flip_patches_rows_on_the_card(self, card):
        """One (i1)-style flip at the tests' size on the card and on the
        CPU: the stopped hosts are fenced, the probe dispatch right after
        patches exactly their admission rows, nothing re-stacks, no
        ``update_rows`` launches, and the K = 16 serve wave that follows
        launches ``fleet_eval`` and binds as on the CPU, off every fenced
        host."""
        got = run_nodehealth("auto", NODEHEALTH_SMALL)
        want = run_nodehealth("cpu", NODEHEALTH_SMALL)
        flips = {f["step"]: f for f in got["flips"]}
        assert flips["i1 probe"]["admission_patched"] == NODEHEALTH_SMALL["stop"]
        assert flips["i1 probe"]["restacks"] == flips["i1 probe"]["row_update_launches"] == 0
        assert flips["i1 probe"]["fleet_eval"] > 0
        assert got["phase_bindings"]["i1"] == want["phase_bindings"]["i1"]
        assert not got["violations"]

    def test_run_i_small_as_on_cpu(self, card):
        """chip_smoke's run (i) at the tests' size: every decision equal to
        the CPU run, every invariant, ``fleet_eval`` in (i1) and
        ``joint_fit`` at the reopen, every call equal to its plain
        version."""
        got = run_nodehealth("auto", NODEHEALTH_SMALL)
        want = run_nodehealth("cpu", NODEHEALTH_SMALL)
        check_nodehealth(got, want, NODEHEALTH_SMALL)


@pytest.mark.cuda
class TestDispatchSpanOnCard:
    """Run (j)'s claim that the dispatch spans cover the card's work:
    ``TorchFleetKernel.evaluate_joint_plan`` (and ``evaluate_joint``) copy
    their results back to pinned host memory and synchronize before they
    return, so the span the batch plugin closes after ``_dispatch`` lasts
    at least as long as the device time of the launches inside it."""

    def test_dispatch_span_covers_its_launches(self, card):
        stack = build_stack(config=SchedulerConfig(batch_requests=16))
        agent = FakeTpuAgent(stack.cluster)
        for i in range(48):
            agent.add_host(f"h{i:02d}", generation="v5e", chips=8)
        agent.publish_all()
        kern = stack.batch._kern
        calls = []

        def evented(inner):
            def call(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.monotonic()
                start.record()
                try:
                    return inner(*args, **kw)
                finally:
                    end.record()
                    end.synchronize()
                    calls.append((t0, time.monotonic(), start.elapsed_time(end)))
            return call

        kern.evaluate_joint_plan = evented(kern.evaluate_joint_plan)
        kern.evaluate_joint = evented(kern.evaluate_joint)
        launches = cuda_kernel.joint_fit_launches
        for g in range(2):
            labels = {"tpu/gang": f"g{g}", "tpu/gang-size": "8", "tpu/chips": "8"}
            for m in range(8):
                stack.cluster.create_pod(PodSpec(f"g{g}-{m}", labels=dict(labels)))
        stack.scheduler.run_until_idle(max_wall_s=30)
        assert sum(1 for p in stack.cluster.list_pods() if p.node_name) == 16
        assert cuda_kernel.joint_fit_launches > launches
        spans = [r for r in stack.metrics.tracer.records()
                 if r.name in ("gang-dispatch", "joint-dispatch")]
        assert spans and calls
        for r in spans:
            t0, t1 = r.t0_ms / 1e3, (r.t0_ms + r.dur_ms) / 1e3
            inside = [c for c in calls if t0 <= c[0] and c[1] <= t1]
            assert inside, (r.name, t0, t1, calls)
            assert r.dur_ms >= sum(c[2] for c in inside), (r.dur_ms, inside)


@pytest.mark.cuda
class TestProcessOnCard:
    """chip_smoke's run (l) at the tests' size on the card: the CLI over
    the wire and the failover hold every check, with ``fleet_eval`` and
    ``joint_fit`` launched and equal to their plain versions; the
    pipelined drive equals its CPU run."""

    def test_run_l_small(self, card):
        from chip_smoke import (
            PIPELINE_PARITY, PIPELINE_SMALL, PROCESS_SMALL, check_pipeline_run,
            check_process, run_failover, run_pipeline, run_wire,
        )

        check_process(run_wire("auto", PROCESS_SMALL),
                      run_failover("auto", PROCESS_SMALL), card=True)
        got = run_pipeline("auto", PIPELINE_SMALL)
        want = run_pipeline("cpu", PIPELINE_SMALL)
        check_pipeline_run(got)
        assert {k: got[k] for k in PIPELINE_PARITY} == {k: want[k] for k in PIPELINE_PARITY}


@pytest.mark.cuda
class TestShardEntryOnCard:
    """The shard entry of fleet_eval.cu (chip_smoke.py's run (n)): 1 and 4
    shards of the card, bit-equal to the unsharded kernel and to the plain
    shard version, three launches per shard per 128 requests."""

    @pytest.mark.parametrize(
        "n_real,n_pad,c,k",
        [(37, 64, 8, 1), (37, 64, 8, 150), (5000, 8192, 8, 16), (1000, 1024, 128, 16)],
    )
    @pytest.mark.parametrize("shards", [1, 4])
    def test_equals_unsharded_kernel_and_plain(self, card, n_real, n_pad, c, k, shards):
        from chip_smoke import shard_case

        for w in (Weights(), MOST_ALLOCATED):
            row = shard_case(n_real, n_pad, c, k, shards, w, card, timed=False)
            assert row["max_abs_err"] == 0, row
            assert row["launches_per_call"] == row["expected_launches"], row

    def test_mesh_stack_binds_as_the_default_stack(self, card):
        from chip_smoke import (
            SHARD_SMALL,
            check_sharded_stack,
            fleet_and_pods,
            mesh_refused,
            run_sharded_stack,
        )

        pods = fleet_and_pods(seed=0)[1][:32]
        stack, _ = build_fleet("auto", 16, **SHARD_SMALL)
        for name, labels in pods:
            stack.cluster.create_pod(PodSpec(name, labels=dict(labels)))
        stack.scheduler.run_until_idle(max_wall_s=120)
        want = {n: stack.cluster.get_pod(f"default/{n}").node_name for n, _ in pods}
        stack.close()
        check_sharded_stack(run_sharded_stack("auto", SHARD_SMALL, pods), want)
        assert "devices are available" in mesh_refused()


@pytest.mark.cuda
class TestLoopOnCard:
    def test_loop_run_holds_its_checks(self, card):
        """Run (m) at its small size on the card: loop mode agrees with the
        card's batch evaluation pod by pod and binds gangs whole."""
        from chip_smoke import LOOP_SMALL, run_loop

        out = run_loop("auto", LOOP_SMALL)
        assert out["m1"]["launches"] == out["m1"]["batch_dispatches"] > 0


@pytest.mark.cuda
class TestLanesOnCard:
    def test_two_lanes_launch_on_their_own_streams(self, card, monkeypatch):
        """Two lanes' kernels (each a TorchFleetKernel on a stream of its
        own, as ``build_stack(shard=...)`` gives every lane) evaluate from
        two threads at once, 20 bursts of K = 16 each: every launch runs on
        its lane's stream, counts on its lane, and equals the plain version
        on the same inputs."""
        import threading

        streams = [torch.cuda.Stream(device=card) for _ in range(2)]
        lanes = [TorchFleetKernel(Weights(), card, stream=s) for s in streams]
        launched: list = []
        real = cuda_kernel.fleet_eval

        def kept(*args, **kw):
            out = real(*args, **kw)
            launched.append((kw["counter"], torch.cuda.current_stream(card),
                             [a.clone() for a in args[:5]], out.clone()))
            return out

        monkeypatch.setattr(cuda_kernel, "fleet_eval", kept)
        inputs = []
        for i, kern in enumerate(lanes):
            chips, nodes, dyn, host_ok, reqs = stacked_fleet(
                3000 + 500 * i, 4096, 16, seed=20 + i)
            kern._chips, kern._nodes = on(card, (chips, nodes))
            kern._names = [f"n{j}" for j in range(chips.shape[2])]
            inputs.append((dyn, host_ok, [KernelRequest(*map(int, r)) for r in reqs]))
        errors: list = []

        def drive(i: int) -> None:
            try:
                for _ in range(20):
                    lanes[i].evaluate_burst(*inputs[i])
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=drive, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        torch.cuda.synchronize()
        assert not errors
        assert [k.launches for k in lanes] == [20, 20]
        for kern, stream in zip(lanes, streams):
            assert {s for owner, s, _a, _o in launched if owner is kern} == {stream}
        for _owner, _s, args, out in launched:
            want = kernel_packed_burst(*(a.cpu() for a in args), Weights())
            assert torch.equal(out.cpu(), want)

    def test_run_o_small_as_on_cpu(self, card):
        """chip_smoke's run (o) at its small size: (o1), (o3) and (o4) equal
        to the CPU run (journal files byte for byte), every launch equal to
        its plain version, and (o2)'s gates with every lane launching."""
        from chip_smoke import LANES_SMALL, check_lanes, run_lanes

        got = run_lanes("auto", LANES_SMALL)
        want = run_lanes("cpu", LANES_SMALL, reported=False)
        check_lanes(got, want, LANES_SMALL)


@pytest.mark.cuda
class TestProcessLanesOnCard:
    def test_run_p_small(self, card):
        """chip_smoke's run (p) at its small size: (p1)'s worker processes
        each launch on the card, every launch equal to its plain version,
        and the run equal to its CPU run; (p2)'s CLI-spawned workers on
        the card with one killed and respawned; (p3)'s tailing standby
        promoting warm."""
        from chip_smoke import (
            PROC_SMALL, PROC_WIRE_SMALL, check_proc_spec, check_proc_standby,
            check_proc_wire, run_proc_spec, run_proc_standby, run_proc_wire,
        )

        check_proc_spec(run_proc_spec("auto", PROC_SMALL), run_proc_spec("cpu", PROC_SMALL),
                        PROC_SMALL)
        check_proc_wire(run_proc_wire("auto", PROC_WIRE_SMALL), PROC_WIRE_SMALL, card=True)
        check_proc_standby(run_proc_standby("auto", PROC_WIRE_SMALL))


@pytest.mark.cuda
class TestFederationOnCard:
    def test_run_r_small(self, card):
        """chip_smoke's run (r) at its small size: (r1) both member stacks of
        the federation on the card, the spillover, the partition and the
        rejoin, equal to its CPU run; (r2) the federated CLI and the agent
        process; (r3) the native agents' CRs and bindings equal to the CPU
        run; every launch equal to its plain version."""
        from chip_smoke import FEDERATION_SMALL, check_federation, run_federation

        check_federation(run_federation("auto", FEDERATION_SMALL),
                         run_federation("cpu", FEDERATION_SMALL, reported=False),
                         FEDERATION_SMALL)


@pytest.mark.cuda
class TestFallbackOnCard:
    def test_run_s_small(self, card):
        """chip_smoke's run (s) at its small size: on host-primary stacks
        one-shot faults served at level 1 and the breaker's pins at 1 and
        2, every demoted result equal to ``fleet_eval`` / ``joint_fit`` on
        the card on the same inputs; on card stacks (s4) every fault
        counted and re-raised, nothing demoted, every pod bound on the
        card after its retry."""
        from chip_smoke import (
            FALLBACK_SMALL,
            check_card_faults,
            check_fallback_run,
            run_card_faults,
            run_fallback,
        )

        check_card_faults(run_card_faults("auto", FALLBACK_SMALL))
        check_fallback_run(run_fallback(FALLBACK_SMALL, hold_on="auto", reported=False),
                           FALLBACK_SMALL)
