"""The generators repeat from the seed, and every seed gets the same work
in another order."""

from collections import Counter

import pytest

from portbench.harness import fleet as fleet_mod
from portbench.harness import runner
from small import ROOT, bench, shrink

CELLS = ["batch5k.singles-backlog"]


def _traffic(cell_name: str, seed: int):
    cell = runner.find_cell(ROOT, bench(), cell_name)
    cfg, mix = shrink(cell.config, cell.mix)
    fleet = fleet_mod.build_fleet(cfg)
    return cell.generator.Traffic(mix, fleet, seed, {}, cfg["settings"], 10.0), cfg, fleet


def _work(t) -> list:
    return [(p.chips, p.hbm_gib, p.clock_mhz, p.generation) for p in t.pods]


@pytest.mark.parametrize("cell", CELLS)
def test_generators_repeat_from_the_seed(cell):
    a, _, _ = _traffic(cell, 2**31 + 12345)
    b, _, _ = _traffic(cell, 2**31 + 12345)
    assert _work(a) == _work(b)
    assert a.sample() == b.sample()


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_gets_the_same_work_in_another_order(cell):
    a, _, _ = _traffic(cell, 101)
    b, _, _ = _traffic(cell, 2**33 + 7)
    assert Counter(_work(a)) == Counter(_work(b))
    assert _work(a) != _work(b)


def test_prefill_holds_the_same_pods_on_other_hosts():
    cell = runner.find_cell(ROOT, bench(), "batch5k.singles-backlog")
    cfg, _ = shrink(cell.config, cell.mix)
    fleet = fleet_mod.build_fleet(cfg)
    p1 = fleet_mod.build_prefill(fleet, cfg, cfg["prefill"]["mix"], 5)
    p2 = fleet_mod.build_prefill(fleet, cfg, cfg["prefill"]["mix"], 5)
    p3 = fleet_mod.build_prefill(fleet, cfg, cfg["prefill"]["mix"], 6)
    assert p1.pods == p2.pods
    assert [n for _, n in p1.pods] != [n for _, n in p3.pods]
    held = sum(r.chips for r, n in p1.pods if not n.startswith("v5p"))
    v5e = sum(h.chips for h in fleet.hosts if not h.slice_id)
    assert held == v5e // 2
    slices = {n.rsplit("-", 1)[0] for r, n in p1.pods if n.startswith("v5p")}
    assert len(slices) == len(fleet.slices) // 2
