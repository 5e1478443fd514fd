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
        "n_real,n_pad,k", [(37, 64, 1), (256, 256, 8), (5000, 8192, 16)]
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
        inputs = stacked_fleet(300, 512, 4, seed=7)
        rng = np.random.default_rng(7)
        chips = inputs[0]
        valid = chips[0] != 0
        chips[6] = np.where(valid, rng.integers(10**7, 4 * 10**7, size=chips[6].shape), 0)
        chips[4] = np.where(valid, rng.integers(2 * 10**7, 3 * 10**7, size=chips[4].shape), 0)
        chips[3] = np.where(valid, chips[4] - rng.integers(0, 10**7, size=chips[4].shape), 0)
        chips[2] = chips[3] < chips[4]
        args = on(card, inputs)
        for w in (Weights(hbm_bandwidth=900, actual=7), MOST_ALLOCATED):
            assert torch.equal(fleet_eval(*args, w), kernel_packed_burst(*args, w))

    def test_nothing_feasible_gives_no_best_row(self, card):
        inputs = stacked_fleet(37, 64, 2, seed=3)
        inputs[3][:] = 0
        got = fleet_eval(*on(card, inputs), Weights())
        assert int(got[:, 0].sum()) == 0
        assert (got[:, 4] == -1).all()

    def test_fleet_kernel_on_card_equals_cpu(self, card):
        from yoda_tpu_torch.ops.arrays import FleetArrays

        chips, nodes, dyn, host_ok, reqs = stacked_fleet(100, 128, 4, seed=5)
        fields = {k: chips[i].T for i, k in enumerate(
            ("chip_valid", "chip_healthy", "chip_used", "hbm_free_mib",
             "hbm_total_mib", "clock_mhz", "hbm_bandwidth", "tflops", "power_w"))}
        fields.update(
            names=[f"n{i}" for i in range(100)], node_valid=nodes[0],
            in_slice=nodes[1], generation_rank=nodes[2], ext_chips=nodes[3],
            fresh=dyn[0], reserved_chips=dyn[1], claimed_hbm_mib=dyn[2],
            host_ok=host_ok[0], last_updated=np.zeros(128),
        )
        arrays = FleetArrays.from_numpy(fields)
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
