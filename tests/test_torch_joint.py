"""The port's joint gang evaluation against the JAX package, exactly
(int32 throughout, tolerance 0).

- the plain PyTorch ``joint_fit_scan`` against the reference's jnp
  ``lax.scan`` and its numpy twin, on seeded rows with heavy score ties,
  padding rows, gangs that fail part-way, after a fit and at their first
  row, and K = 1;
- ``kernel_joint_plan`` against ``yoda_tpu.ops.kernel._kernel_joint_plan``
  (packed rows, picks, group_ok, sim);
- ``stack_joint_burst``, ``joint_fit_vectors``, ``burst_bucket`` and the
  packed upload with the joint side inputs;
- ``TorchFleetKernel(device="cpu").evaluate_joint_plan`` (and
  ``evaluate_joint``) against ``DeviceFleetKernel``.

The hand CUDA joint-fit kernel is held against the plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

import yoda_tpu.ops.kernel as ref
import yoda_tpu_torch.ops.kernel as port
from yoda_tpu.config import Weights
from yoda_tpu.ops.kernel import DeviceFleetKernel
from yoda_tpu_torch.ops import cuda_kernel

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


def scan_case(seed: int, k: int, n: int, *, ties: bool = False, pad: int = 0):
    """Seeded joint-fit inputs: K rows (the last ``pad`` are padding) in
    gangs of random size over N nodes. ``ties`` draws scores from {0, 1}
    (most maxima tie); otherwise from a wide range."""
    rng = np.random.default_rng(seed)
    feas = (rng.random((k, n)) > 0.35).astype(np.int32)
    scores = rng.integers(0, 2 if ties else 200, size=(k, n)).astype(np.int32)
    claim = rng.integers(0, 9, size=(k, n)).astype(np.int32)
    m = k - pad
    offsets = [0]
    while offsets[-1] < m:
        offsets.append(min(m, offsets[-1] + int(rng.integers(1, 5))))
    requests = [
        port.KernelRequest(int(rng.integers(1, 7)), 0, 0, 0, 0) for _ in range(m)
    ] + [port.KernelRequest(1, 0, 0, 0, 0)] * pad
    chips, starts, valid = port.joint_fit_vectors(requests, offsets)
    return feas, scores, claim, chips, starts, valid


def ref_scans(feas, scores, claim, chips, starts, valid):
    """(jnp lax.scan result, numpy twin result), as numpy."""
    jnp_out = tuple(
        np.asarray(x) for x in ref.joint_fit_scan(feas, scores, claim, chips, starts, valid)
    )
    np_out = ref.joint_fit_scan(feas, scores, claim, chips, starts, valid, xp=np)
    return jnp_out, np_out


def port_scan(feas, scores, claim, chips, starts, valid):
    out = port.joint_fit_scan(
        *(torch.from_numpy(x) for x in (feas, scores, claim, chips, starts, valid))
    )
    return tuple(t.numpy() for t in out)


def assert_scan_equal(got, want) -> None:
    picks, gok, sim = got
    np.testing.assert_array_equal(picks, want[0])
    np.testing.assert_array_equal(gok.astype(bool), np.asarray(want[1]).astype(bool))
    np.testing.assert_array_equal(sim, want[2])


class TestJointFitScan:
    @pytest.mark.parametrize(
        "seed,k,n,ties,pad",
        [
            (0, 1, 1, False, 0),
            (1, 1, 37, True, 0),
            (2, 3, 37, False, 0),
            (3, 16, 50, True, 3),
            (4, 16, 50, False, 5),
            (5, 40, 64, True, 8),
            (6, 40, 20, False, 0),
            (7, 64, 100, True, 16),
        ],
    )
    def test_matches_jnp_scan_and_numpy_twin(self, seed, k, n, ties, pad):
        case = scan_case(seed, k, n, ties=ties, pad=pad)
        jnp_out, np_out = ref_scans(*case)
        got = port_scan(*case)
        assert_scan_equal(got, jnp_out)
        assert_scan_equal(got, np_out)

    def test_all_tie_scores_pick_the_first_index(self):
        k, n = 6, 10
        feas = np.ones((k, n), dtype=np.int32)
        scores = np.full((k, n), 7, dtype=np.int32)
        claim = np.full((k, n), 2, dtype=np.int32)
        requests = [port.KernelRequest(1, 0, 0, 0, 0)] * k
        side = port.joint_fit_vectors(requests, [0, 3, 6])
        got = port_scan(feas, scores, claim, *side)
        jnp_out, np_out = ref_scans(feas, scores, claim, *side)
        assert_scan_equal(got, jnp_out)
        assert_scan_equal(got, np_out)
        # Each node takes two one-chip members, lowest index first, and the
        # second gang starts where the first left off.
        assert got[0].tolist() == [0, 0, 1, 1, 2, 2]

    def test_gang_failing_part_way_consumes_nothing(self):
        # Gang 0 fits (nodes 0, 1); gang 1's second member needs 9 chips
        # and fails part-way; gang 2 still sees gang 1's capacity; gang 3
        # fails at its first row.
        n = 4
        rows = [(1, 0), (1, 0), (2, 1), (9, 1), (2, 2), (50, 3)]
        k = len(rows)
        feas = np.ones((k, n), dtype=np.int32)
        scores = np.tile(np.array([5, 4, 3, 2], dtype=np.int32), (k, 1))
        claim = np.full((k, n), 4, dtype=np.int32)
        requests = [port.KernelRequest(c, 0, 0, 0, 0) for c, _ in rows]
        side = port.joint_fit_vectors(requests, [0, 2, 4, 5, 6])
        got = port_scan(feas, scores, claim, *side)
        for want in ref_scans(feas, scores, claim, *side):
            assert_scan_equal(got, want)
        picks, gok, sim = got
        assert gok.tolist() == [True, True, True, False, True, False]
        assert picks.tolist() == [0, 0, 0, -1, 0, -1]
        assert sim.tolist() == [4, 0, 0, 0]  # gangs 0 and 2 only

    def test_int32_claimable_minus_ledger_wraps(self):
        # claimable - tent in int32, as jnp computes it: a ledger past the
        # claimable value goes negative, never a wide difference.
        k, n = 3, 5
        feas = np.ones((k, n), dtype=np.int32)
        scores = np.arange(n, dtype=np.int32)[None].repeat(k, 0)
        claim = np.full((k, n), 2**31 - 2, dtype=np.int32)
        requests = [port.KernelRequest(2**30, 0, 0, 0, 0)] * k
        side = port.joint_fit_vectors(requests, [0, k])
        got = port_scan(feas, scores, claim, *side)
        for want in ref_scans(feas, scores, claim, *side):
            assert_scan_equal(got, want)

    def test_cpu_wrapper_is_the_plain_scan_and_launches_nothing(self):
        feas, scores, claim, chips, starts, valid = scan_case(9, 12, 30, ties=True, pad=2)
        packed = torch.zeros((12, 6, 30), dtype=torch.int32)
        packed[:, 0] = torch.from_numpy(feas)
        packed[:, 3] = torch.from_numpy(scores)
        packed[:, 5] = torch.from_numpy(claim)
        out = torch.full((2 * 12 + 30,), -7, dtype=torch.int32)
        before = cuda_kernel.joint_fit_launches
        picks, gok, sim = cuda_kernel.joint_fit(
            packed, *(torch.from_numpy(x) for x in (chips, starts, valid)), out=out
        )
        assert cuda_kernel.joint_fit_launches == before
        assert picks.data_ptr() == out.data_ptr()
        assert_scan_equal(
            (picks.numpy(), gok.numpy(), sim.numpy()),
            port_scan(feas, scores, claim, chips, starts, valid),
        )


def joint_inputs(seed: int, n_nodes: int, sizes: list[int]):
    arrays = random_arrays(n_nodes, seed=seed)
    n_pad = arrays.node_valid.shape[0]
    rng = np.random.default_rng(seed)
    host_ok_groups = [
        (rng.random((size, n_pad)) > 0.2).astype(np.int32) for size in sizes
    ]
    request_groups = [
        [REQUESTS[int(rng.integers(0, 3))] for _ in range(size)] for size in sizes
    ]
    return arrays, host_ok_groups, request_groups


def port_groups(request_groups):
    return [[torch_request(r) for r in g] for g in request_groups]


class TestKernelJointPlan:
    @pytest.mark.parametrize("seed,sizes", [(0, [4]), (1, [3, 5, 2]), (2, [1, 1])])
    @pytest.mark.parametrize("weights", [Weights(), MOST_ALLOCATED], ids=["least", "most"])
    def test_matches_reference_program(self, seed, sizes, weights):
        arrays, host_ok_groups, request_groups = joint_inputs(seed, 37, sizes)
        dyn = own_dyn(arrays)
        host_ok_k, requests, offsets = ref.stack_joint_burst(
            host_ok_groups, request_groups, 8
        )
        chips_k, starts_k, valid_k = ref.joint_fit_vectors(requests, offsets)
        reqs_k = np.stack([ref.pack_request(r) for r in requests])
        static = {k: getattr(arrays, k) for k in ref.STATIC_NODE_KEYS + ref.CHIP_KEYS}
        want = ref._kernel_joint_plan(
            static, dyn, host_ok_k, reqs_k, chips_k, starts_k, valid_k,
            weights=weights,
        )
        chips, nodes = (torch.from_numpy(x) for x in port.stack_static(to_torch(arrays)))
        got = port.kernel_joint_plan(
            chips, nodes,
            *(torch.from_numpy(np.ascontiguousarray(x)) for x in (
                dyn, host_ok_k, reqs_k, chips_k, starts_k, valid_k,
            )),
            torch_weights(weights),
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # The script exercises claims: some row picked a node.
        assert (got[1].numpy() >= 0).any()


class TestJointStacking:
    @pytest.mark.parametrize(
        "k,minimum", [(1, 1), (1, 16), (3, 1), (16, 16), (17, 16), (144, 16), (240, 16)]
    )
    def test_burst_bucket(self, k, minimum):
        assert port.burst_bucket(k, minimum) == ref.burst_bucket(k, minimum)

    @pytest.mark.parametrize("sizes,minimum", [([4], 1), ([3, 5, 2], 8), ([9, 9], 4)])
    def test_stack_and_side_vectors(self, sizes, minimum):
        _arrays, host_ok_groups, request_groups = joint_inputs(5, 20, sizes)
        want_ok, want_reqs, want_off = ref.stack_joint_burst(
            host_ok_groups, request_groups, minimum
        )
        got_ok, got_reqs, got_off = port.stack_joint_burst(
            host_ok_groups, port_groups(request_groups), minimum
        )
        np.testing.assert_array_equal(got_ok, want_ok)
        assert got_off == want_off
        assert [dataclasses.asdict(r) for r in got_reqs] == [
            dataclasses.asdict(r) for r in want_reqs
        ]
        for g, w in zip(
            port.joint_fit_vectors(got_reqs, got_off),
            ref.joint_fit_vectors(want_reqs, want_off),
        ):
            np.testing.assert_array_equal(g, w)

    def test_stack_refuses_no_rows(self):
        with pytest.raises(ValueError, match="at least one member row"):
            port.stack_joint_burst([np.zeros((0, 4))], [[]])

    def test_pack_with_side_vectors_round_trips(self):
        n, k = 7, 3
        rng = np.random.default_rng(3)
        dyn = rng.integers(0, 99, size=(4, n)).astype(np.int32)
        host_ok = rng.random((k, n)) > 0.5
        reqs = rng.integers(0, 99, size=(k, 5)).astype(np.int32)
        side = [rng.integers(0, 9, size=k).astype(np.int32) for _ in range(3)]
        buf = port.pack_inputs(dyn, host_ok, reqs, *side)
        assert buf.shape == (port.inputs_size(n, k, 3),)
        got = port.split_inputs(torch.from_numpy(buf), n, k, 3)
        for t, want in zip(got, [dyn, host_ok.astype(np.int32), reqs, *side]):
            np.testing.assert_array_equal(t.numpy(), want)


class TestTorchFleetKernelJoint:
    @pytest.mark.parametrize("seed,sizes", [(0, [4]), (1, [3, 5, 2]), (3, [6, 6, 6, 6])])
    @pytest.mark.parametrize("minimum", [1, 16])
    def test_evaluate_joint_plan_matches_device_kernel(self, seed, sizes, minimum):
        arrays, host_ok_groups, request_groups = joint_inputs(seed, 60, sizes)
        dyn = own_dyn(arrays)
        want_kern = DeviceFleetKernel(MOST_ALLOCATED)
        want_kern.put_static(arrays)
        want = want_kern.evaluate_joint_plan(dyn, host_ok_groups, request_groups, minimum)
        got_kern = port.TorchFleetKernel(torch_weights(MOST_ALLOCATED), CPU)
        got_kern.put_static(to_torch(arrays))
        groups = port_groups(request_groups)
        got = got_kern.evaluate_joint_plan(dyn, host_ok_groups, groups, minimum)
        via = port.evaluate_joint_plan_via_burst(
            got_kern, dyn, host_ok_groups, groups, minimum
        )
        for result in (got, via):
            grouped, fits, picks = result
            assert fits == want[1]
            for g_rows, w_rows in zip(grouped, want[0]):
                assert len(g_rows) == len(w_rows)
                for g, w in zip(g_rows, w_rows):
                    assert_same(g, w)
            for g, w in zip(picks, want[2]):
                np.testing.assert_array_equal(g, np.asarray(w))

    def test_contended_gangs_park_at_the_gate(self):
        # Four gangs over a small fleet: the later ones cannot fit whole.
        arrays, host_ok_groups, request_groups = joint_inputs(4, 12, [8, 8, 8, 8])
        request_groups = [[REQUESTS[3]] * 8 for _ in range(4)]
        dyn = own_dyn(arrays)
        want_kern = DeviceFleetKernel(Weights())
        want_kern.put_static(arrays)
        want = want_kern.evaluate_joint_plan(dyn, host_ok_groups, request_groups, 16)
        got_kern = port.TorchFleetKernel(torch_weights(Weights()), CPU)
        got_kern.put_static(to_torch(arrays))
        got = got_kern.evaluate_joint_plan(
            dyn, host_ok_groups, port_groups(request_groups), 16
        )
        assert got[1] == want[1]
        for g, w in zip(got[2], want[2]):
            np.testing.assert_array_equal(g, np.asarray(w))

    def test_evaluate_joint_matches_device_kernel(self):
        arrays, host_ok_groups, request_groups = joint_inputs(6, 40, [4, 4])
        dyn = own_dyn(arrays)
        want_kern = DeviceFleetKernel(Weights())
        want_kern.put_static(arrays)
        want = want_kern.evaluate_joint(dyn, host_ok_groups, request_groups, 8)
        got_kern = port.TorchFleetKernel(torch_weights(Weights()), CPU)
        got_kern.put_static(to_torch(arrays))
        got = got_kern.evaluate_joint(dyn, host_ok_groups, port_groups(request_groups), 8)
        for g_rows, w_rows in zip(got, want):
            for g, w in zip(g_rows, w_rows):
                assert_same(g, w)

    def test_joint_rows_survive_the_next_evaluation(self):
        arrays, host_ok_groups, request_groups = joint_inputs(7, 37, [3, 3])
        dyn = own_dyn(arrays)
        kern = port.TorchFleetKernel(torch_weights(Weights()), CPU)
        kern.put_static(to_torch(arrays))
        groups = port_groups(request_groups)
        grouped, _fits, picks = kern.evaluate_joint_plan(dyn, host_ok_groups, groups)
        kept = [[r.scores.copy() for r in g] for g in grouped]
        kept_picks = [p.copy() for p in picks]
        kern.evaluate_joint_plan(dyn, [1 - g for g in host_ok_groups], groups[::-1])
        for g, k in zip(grouped, kept):
            for r, scores in zip(g, k):
                np.testing.assert_array_equal(r.scores, scores)
        for p, k in zip(picks, kept_picks):
            np.testing.assert_array_equal(p, k)
