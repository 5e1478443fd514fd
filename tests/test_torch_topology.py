"""The port's ICI topology planner (yoda_tpu_torch/plugins/yoda/topology.py)
against the JAX package's, exactly (tolerance 0: equal plans, equal block
lists).

Port-side copies of tests/test_gang.py::TestTopologyMatching and of the
planner cases of TestMultislice, plus seeded parity: random slice fleets
with holes, blocked hosts, axis permutations, pinned hosts, several blocks
per gang and L-shaped free regions that trap greedy packing go through
both packages' functions."""

import itertools

import numpy as np
import pytest

import yoda_tpu.api.types as ref_types
import yoda_tpu.framework.interfaces as ref_fw
import yoda_tpu.plugins.yoda.topology as ref
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.framework.interfaces as port_fw
import yoda_tpu_torch.plugins.yoda.topology as port
from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
from yoda_tpu_torch.config import SchedulerConfig
from yoda_tpu_torch.plugins.yoda.topology import (
    find_subblock,
    normalize_dims,
    pack_blocks,
    plan_multislice_placement,
)
from yoda_tpu_torch.standalone import build_stack

SHAPES = [(2, 2, 1), (4, 2, 1), (2, 2, 2), (4, 4, 1), (1, 4, 2), (3, 2, 1)]
WANTS = [(1,), (2,), (2, 2), (2, 2, 1), (2, 1, 2), (4, 1), (1, 2, 2), (2, 2, 2), (3, 1)]


def random_fleet(seed: int):
    """[(host, slice id, coords)] for a few slices of random shape with
    random holes, plus hosts outside any slice; a blocked host set."""
    rng = np.random.default_rng(seed)
    hosts = []
    for s in range(int(rng.integers(1, 5))):
        x, y, z = SHAPES[int(rng.integers(len(SHAPES)))]
        for i, c in enumerate(itertools.product(range(x), range(y), range(z))):
            if rng.random() < 0.12:
                continue  # a hole: the host is gone
            hosts.append((f"sl{s}-{i}", f"sl{s}", c))
    for i in range(int(rng.integers(0, 3))):
        hosts.append((f"solo-{i}", "", (0, 0, 0)))
    blocked = {h for h, _, _ in hosts if rng.random() < 0.15}
    return hosts, blocked


def snapshot(types, fw, hosts):
    return fw.Snapshot(
        {
            name: fw.NodeInfo(
                name=name,
                tpu=types.TpuNodeMetrics(
                    name=name, slice_id=sid, topology_coords=coords
                ),
            )
            for name, sid, coords in hosts
        }
    )


def random_free(rng, size: int = 4):
    dims = rng.integers(1, size + 1, size=3)
    return {
        c
        for c in itertools.product(*(range(int(d)) for d in dims))
        if rng.random() < 0.8
    }


class TestTopologyMatching:
    def test_normalize(self):
        assert normalize_dims((4,)) == (4, 1, 1)
        assert normalize_dims((2, 2)) == (2, 2, 1)

    def test_find_subblock_exact(self):
        free = {(x, y, z) for x in range(2) for y in range(2) for z in range(2)}
        block = find_subblock(free, (2, 2, 2))
        assert block is not None and len(block) == 8

    def test_find_subblock_within_larger(self):
        free = {(x, y, 0) for x in range(4) for y in range(4)}
        block = find_subblock(free, (2, 2, 1))
        assert block == [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]

    def test_find_subblock_axis_permutation(self):
        free = {(0, y, z) for y in range(2) for z in range(4)}  # 1x2x4 region
        assert find_subblock(free, (4, 2, 1)) is not None

    def test_find_subblock_respects_holes(self):
        free = {(x, y, 0) for x in range(2) for y in range(2)} - {(0, 1, 0)}
        assert find_subblock(free, (2, 2, 1)) is None
        assert find_subblock(free, (2, 1, 1)) is not None

    def test_find_subblock_must_include(self):
        free = {(x, y, 0) for x in range(4) for y in range(2)}
        block = find_subblock(
            free - {(2, 0, 0)}, (2, 2, 1), must_include={(2, 0, 0)}
        )
        assert block is not None and (2, 0, 0) in block
        assert (
            find_subblock({(0, 0, 0)}, (2, 1, 1), must_include={(3, 0, 0)}) is None
        )

    def test_fragmented_no_contiguous_block(self):
        free = {(0, 0, 0), (2, 0, 0), (0, 2, 0), (2, 2, 0)}  # checkerboard
        assert find_subblock(free, (2, 1, 1)) is None


def fleet_snapshot(*slices):
    stack = build_stack(config=SchedulerConfig(kernel_platform="cpu"))
    agent = FakeTpuAgent(stack.cluster)
    hosts = {
        name: agent.add_slice(name, host_topology=shape) for name, shape in slices
    }
    agent.publish_all()
    return stack.informer.snapshot(), hosts


class TestMultislicePlanner:
    def test_planner_two_blocks_across_slices(self):
        snap, _ = fleet_snapshot(("s-a", (2, 2, 1)), ("s-b", (2, 2, 1)))
        plan = plan_multislice_placement(
            snap, want_dims=(2, 2, 1), slices=2, host_ok=lambda ni: True
        )
        assert plan is not None and len(plan) == 8
        assert {h.rsplit("-", 1)[0] for h in plan} == {"s-a", "s-b"}

    def test_planner_two_blocks_pack_one_big_slice(self):
        snap, _ = fleet_snapshot(("big", (4, 2, 1)))
        plan = plan_multislice_placement(
            snap, want_dims=(2, 2, 1), slices=2, host_ok=lambda ni: True
        )
        assert plan is not None and len(plan) == 8

    def test_pack_blocks_backtracks_past_greedy_traps(self):
        free = {(0, 0, 0), (1, 0, 0), (2, 0, 0), (0, 1, 0)}
        blocks = pack_blocks(free, (2, 1, 1), 2)
        assert blocks is not None
        used = [c for b in blocks for c in b]
        assert sorted(used) == sorted(free)
        assert pack_blocks(free, (2, 1, 1), 3) is None

    def test_planner_multi_pin_blocks_in_one_slice(self):
        snap, hosts = fleet_snapshot(("wide", (4, 2, 1)))
        by_coord = {snap.get(h).tpu.topology_coords: h for h in hosts["wide"]}
        pinned = {
            by_coord[(0, 0, 0)]: (0, 0, 0),
            by_coord[(0, 1, 0)]: (0, 1, 0),
            by_coord[(2, 0, 0)]: (2, 0, 0),
        }
        plan = plan_multislice_placement(
            snap,
            want_dims=(2, 2, 1),
            slices=2,
            host_ok=lambda ni: ni.name not in pinned,
            pinned=pinned,
        )
        assert plan is not None and len(plan) == 8
        for h, c in pinned.items():
            assert plan.get(h) == c

    def test_planner_insufficient_blocks(self):
        snap, _ = fleet_snapshot(("only", (2, 2, 1)))
        assert (
            plan_multislice_placement(
                snap, want_dims=(2, 2, 1), slices=2, host_ok=lambda ni: True
            )
            is None
        )


class TestParityWithReference:
    @pytest.mark.parametrize("seed", range(6))
    def test_block_search(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(20):
            free = random_free(rng)
            want = normalize_dims(WANTS[int(rng.integers(len(WANTS)))])
            assert port.normalize_dims(want) == ref.normalize_dims(want)
            must = set()
            if free and rng.random() < 0.4:
                must = {sorted(free)[int(rng.integers(len(free)))]}
            assert list(port.iter_subblocks(free, want, must_include=must)) == list(
                ref.iter_subblocks(free, want, must_include=must)
            )
            assert port.find_subblock(free, want, must_include=must) == (
                ref.find_subblock(free, want, must_include=must)
            )
            k = int(rng.integers(0, 4))
            assert port.pack_blocks(free, want, k) == ref.pack_blocks(free, want, k)

    @pytest.mark.parametrize("seed", range(8))
    def test_plans(self, seed):
        hosts, blocked = random_fleet(seed)
        ref_snap = snapshot(ref_types, ref_fw, hosts)
        port_snap = snapshot(port_types, port_fw, hosts)
        rng = np.random.default_rng(100 + seed)
        in_slice = [(h, c) for h, sid, c in hosts if sid]
        for _ in range(12):
            want = WANTS[int(rng.integers(len(WANTS)))]
            slices = int(rng.integers(1, 4))
            pinned = {}
            if in_slice and rng.random() < 0.4:
                for i in rng.choice(len(in_slice), size=int(rng.integers(1, 3))):
                    h, c = in_slice[int(i)]
                    pinned[h] = c

            def host_ok(ni):
                return ni.name not in blocked

            kw = dict(want_dims=want, host_ok=host_ok, pinned=dict(pinned))
            got = port.plan_multislice_placement(port_snap, slices=slices, **kw)
            want_plan = ref.plan_multislice_placement(ref_snap, slices=slices, **kw)
            assert got == want_plan
            if slices == 1:
                assert port.plan_slice_placement(port_snap, **kw) == (
                    ref.plan_slice_placement(ref_snap, **kw)
                )

    def test_greedy_trap_and_permutation_cases(self):
        # An L-shaped region (two 2x1 blocks only when the first pick is not
        # the lowest origin) and a 1x2x4 region asked for as 4x2x1.
        for free, want, k in (
            ({(0, 0, 0), (1, 0, 0), (2, 0, 0), (0, 1, 0)}, (2, 1, 1), 2),
            ({(0, y, z) for y in range(2) for z in range(4)}, (4, 2, 1), 1),
            ({(x, y, 0) for x in range(4) for y in range(4)}, (2, 2, 1), 4),
        ):
            assert port.pack_blocks(free, want, k) == ref.pack_blocks(free, want, k)
            assert port.pack_blocks(free, want, k) is not None
