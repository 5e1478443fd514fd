"""The hand-written CUDA fleet-evaluation kernel (yoda_tpu_torch/csrc/
fleet_eval.cu) against its plain PyTorch version on the same tensors,
tolerance 0 (everything is int32), and the wrapper's contract.

Tests marked ``cuda`` need the card and skip without one; run them there
with ``python -m pytest -m cuda tests/test_torch_cuda.py``. This file
imports neither JAX nor yoda_tpu, so it runs on a machine without JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.config import SchedulerConfig, Weights
from yoda_tpu_torch.ops import cuda_kernel
from yoda_tpu_torch.ops.cuda_kernel import fleet_eval
from yoda_tpu_torch.ops.kernel import (
    KernelRequest,
    TorchFleetKernel,
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

    @pytest.mark.parametrize("chips", [4, 16, 32])
    def test_chip_counts_equal_plain(self, card, chips):
        args = on(card, stacked_fleet(300, 512, 4, seed=chips, chips=chips))
        for w in (Weights(), MOST_ALLOCATED):
            assert torch.equal(fleet_eval(*args, w), kernel_packed_burst(*args, w))

    def test_more_than_32_chips_are_refused(self, card):
        args = on(card, stacked_fleet(8, 8, 1, seed=4, chips=64))
        with pytest.raises(ValueError, match="32 chips"):
            fleet_eval(*args, Weights())

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
