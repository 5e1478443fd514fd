"""Parity of the port's fleet evaluation (yoda_tpu_torch.ops) with the JAX
package: the plain PyTorch version on the CPU against the XLA kernel
(``fused_filter_score``), the Pallas kernel in interpret mode
(``fused_filter_score_pallas``) and the burst kernel
(``DeviceFleetKernel.evaluate_burst``). Everything is int32, so the
tolerance is 0: every output row and the best index must be equal.

The hand CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

from yoda_tpu.config import SchedulerConfig, Weights
from yoda_tpu.ops.arrays import FleetArrays, bucket_rows
from yoda_tpu.ops.kernel import DeviceFleetKernel, KernelRequest, fused_filter_score
from yoda_tpu.ops.pallas_kernel import fused_filter_score_pallas
from yoda_tpu_torch.config import Weights as TorchWeights
from yoda_tpu_torch.ops import cuda_kernel
from yoda_tpu_torch.ops.arrays import FleetArrays as TorchFleetArrays
from yoda_tpu_torch.ops.kernel import KernelRequest as TorchKernelRequest
from yoda_tpu_torch.ops.kernel import TorchFleetKernel, kernel_packed, stack_static

CPU = torch.device("cpu")


def random_arrays(n_nodes: int, chips: int = 8, seed: int = 0) -> FleetArrays:
    """A copy of tests/test_pallas.py::random_arrays."""
    n = bucket_rows(n_nodes)
    rng = np.random.default_rng(seed)
    valid = np.zeros(n, dtype=bool)
    valid[:n_nodes] = True
    grid = (n, chips)
    total = np.full(grid, 16 * 1024, dtype=np.int32)
    free = total - rng.integers(0, 16 * 1024, size=grid, dtype=np.int32)
    healthy = rng.random(grid) > 0.1
    return FleetArrays(
        names=[f"n{i:04d}" for i in range(n_nodes)],
        node_valid=valid,
        generation_rank=rng.integers(2, 7, size=n).astype(np.int32),
        in_slice=rng.random(n) > 0.5,
        fresh=valid & (rng.random(n) > 0.05),
        host_ok=valid & (rng.random(n) > 0.05),
        last_updated=np.zeros(n, dtype=np.float64),
        reserved_chips=rng.integers(0, 4, size=n).astype(np.int32),
        claimed_hbm_mib=rng.integers(0, 64 * 1024, size=n).astype(np.int32),
        ext_chips=rng.integers(0, 3, size=n).astype(np.int32),
        chip_valid=np.broadcast_to(valid[:, None], grid).copy(),
        chip_healthy=np.broadcast_to(valid[:, None], grid) & healthy,
        chip_used=free < total,
        hbm_free_mib=free,
        hbm_total_mib=total,
        clock_mhz=rng.integers(700, 1000, size=grid).astype(np.int32),
        hbm_bandwidth=rng.integers(400, 900, size=grid).astype(np.int32),
        tflops=rng.integers(100, 300, size=grid).astype(np.int32),
        power_w=rng.integers(100, 200, size=grid).astype(np.int32),
    )


REQUESTS = [
    KernelRequest(1, 0, 0, 0, 0),
    KernelRequest(2, 8 * 1024, 0, 0, 0),
    KernelRequest(4, 4 * 1024, 900, 5, 1),
    KernelRequest(8, 15 * 1024, 990, 6, 0),
]

MOST_ALLOCATED = SchedulerConfig(scoring_strategy="most-allocated").effective_weights()


def to_torch(arrays: FleetArrays) -> TorchFleetArrays:
    """The reference's fleet state as numpy, fed to the port."""
    return TorchFleetArrays.from_numpy(vars(arrays))


def torch_weights(w: Weights) -> TorchWeights:
    return TorchWeights(**dataclasses.asdict(w))


def torch_request(r: KernelRequest) -> TorchKernelRequest:
    return TorchKernelRequest(**dataclasses.asdict(r))


def own_dyn(arrays: FleetArrays) -> np.ndarray:
    """The arrays' own dynamic rows, verbatim (what fused_filter_score
    evaluates)."""
    return np.stack(
        [
            np.asarray(arrays.fresh, dtype=np.int32),
            np.asarray(arrays.reserved_chips, dtype=np.int32),
            np.asarray(arrays.claimed_hbm_mib, dtype=np.int32),
            np.asarray(arrays.host_ok, dtype=np.int32),
        ]
    )


def port_eval(arrays: FleetArrays, req: KernelRequest, weights: Weights):
    kern = TorchFleetKernel(torch_weights(weights), CPU)
    kern.put_static(to_torch(arrays))
    return kern.evaluate(own_dyn(arrays), torch_request(req))


def assert_same(got, want) -> None:
    np.testing.assert_array_equal(got.feasible, want.feasible)
    np.testing.assert_array_equal(got.reasons, want.reasons)
    np.testing.assert_array_equal(got.raw_scores, want.raw_scores)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.claimable, want.claimable)
    assert got.best_index == want.best_index


class TestPlainVersionParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("req", REQUESTS, ids=lambda r: f"n{r.number}")
    @pytest.mark.parametrize(
        "weights", [Weights(), MOST_ALLOCATED], ids=["least", "most"]
    )
    def test_matches_xla_kernel(self, seed, req, weights):
        arrays = random_arrays(37, seed=seed)
        assert_same(
            port_eval(arrays, req, weights),
            fused_filter_score(arrays, req, weights=weights),
        )

    @pytest.mark.parametrize(
        "n_nodes,chips", [(37, 8), (150, 5), (300, 8)], ids=["37x8", "150x5", "300x8"]
    )
    @pytest.mark.parametrize(
        "weights", [Weights(), MOST_ALLOCATED], ids=["least", "most"]
    )
    def test_matches_pallas_interpret(self, n_nodes, chips, weights):
        arrays = random_arrays(n_nodes, chips=chips, seed=n_nodes)
        req = KernelRequest(2, 8 * 1024, 800, 0, 0)
        want = fused_filter_score_pallas(arrays, req, weights=weights, interpret=True)
        assert_same(port_eval(arrays, req, weights), want)

    @pytest.mark.parametrize("k", [1, 4])
    @pytest.mark.parametrize(
        "weights", [Weights(), MOST_ALLOCATED], ids=["least", "most"]
    )
    def test_matches_device_kernel_burst(self, k, weights):
        arrays = random_arrays(37, seed=7)
        dyn = own_dyn(arrays)
        n_pad = arrays.node_valid.shape[0]
        rng = np.random.default_rng(11)
        # Per-request admission rows; the last is all-False padding (the
        # batcher's bucket-padding convention) when K > 1.
        host_ok_k = (rng.random((k, n_pad)) > 0.3).astype(np.int32)
        if k > 1:
            host_ok_k[-1] = 0
        requests = REQUESTS[:k]
        want_kern = DeviceFleetKernel(weights)
        want_kern.put_static(arrays)
        want = want_kern.evaluate_burst(dyn, host_ok_k, requests)
        got_kern = TorchFleetKernel(torch_weights(weights), CPU)
        got_kern.put_static(to_torch(arrays))
        got = got_kern.evaluate_burst(
            dyn, host_ok_k, [torch_request(r) for r in requests]
        )
        assert len(got) == k
        for g, w in zip(got, want):
            assert_same(g, w)
        if k > 1:
            assert not got[-1].feasible.any() and got[-1].best_index == -1

    @pytest.mark.parametrize(
        "weights", [Weights(hbm_bandwidth=900, actual=7), MOST_ALLOCATED],
        ids=["heavy", "most"],
    )
    def test_int32_wraparound(self, weights):
        """Products that overflow int32 wrap as jnp's do (x * 100 past
        2**31, weighted sums past it) and // floors the negative results."""
        arrays = random_arrays(37, seed=9)
        rng = np.random.default_rng(9)
        grid = arrays.hbm_bandwidth.shape
        arrays.hbm_bandwidth[:] = rng.integers(10**7, 4 * 10**7, size=grid)
        arrays.hbm_total_mib[:] = rng.integers(2 * 10**7, 3 * 10**7, size=grid)
        arrays.hbm_free_mib[:] = arrays.hbm_total_mib - rng.integers(0, 10**7, size=grid)
        arrays.chip_used[:] = arrays.hbm_free_mib < arrays.hbm_total_mib
        assert (arrays.hbm_bandwidth.astype(np.int64) * 100 > 2**31 - 1).any()
        req = KernelRequest(1, 0, 0, 0, 0)
        want = fused_filter_score(arrays, req, weights=weights)
        assert_same(port_eval(arrays, req, weights), want)

    def test_nothing_feasible(self):
        arrays = random_arrays(20, seed=3)
        arrays.host_ok[:] = False
        req = REQUESTS[0]
        got = port_eval(arrays, req, Weights())
        assert_same(got, fused_filter_score(arrays, req))
        assert got.best_index == -1

    def test_kernel_packed_is_burst_of_one(self):
        arrays = random_arrays(37, seed=4)
        chips, nodes = (torch.from_numpy(x) for x in stack_static(to_torch(arrays)))
        dyn = torch.from_numpy(own_dyn(arrays))
        reqv = torch.tensor([2, 1024, 0, 0, 0], dtype=torch.int32)
        packed = kernel_packed(chips, nodes, dyn, reqv, TorchWeights())
        want = fused_filter_score(arrays, KernelRequest(2, 1024, 0, 0, 0))
        n = arrays.n_nodes
        np.testing.assert_array_equal(packed[3, :n].numpy(), want.scores)
        assert int(packed[4, 0]) == want.best_index

    def test_plain_version_counts_no_launch(self):
        before = cuda_kernel.launches
        port_eval(random_arrays(10, seed=5), REQUESTS[1], Weights())
        assert cuda_kernel.launches == before
