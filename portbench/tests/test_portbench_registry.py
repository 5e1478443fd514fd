"""Everything a cell is made of is found by name, and a part added as a
file is found with no edit to any other file."""

import json
import shutil

import pytest

from portbench.harness import runner
from small import ROOT, bench

def test_benchmark_json_names_every_part_and_each_part_exists():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    metrics = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert w["config"] in configs
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        cell = runner.find_cell(ROOT, b, w["name"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        reported = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in reported for m in cell.per_layer)
    for name in metrics:
        mod = runner.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")
        assert callable(mod.read)
    for m in b["per_layer"]:
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in b["workloads"]}


@pytest.mark.parametrize("kind", ["backlog_singles"])
def test_every_generator_kind_loads_by_name(kind):
    mod = runner.load_module(ROOT / "portbench" / "generators" / f"{kind}.py")
    assert hasattr(mod, "Traffic")


def test_a_cell_added_in_a_copy_is_found_without_editing_a_file(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    before = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    mix = json.loads((copy / "portbench/traffic/singles-backlog.json").read_text())
    mix["pending_target"] = 96
    (copy / "portbench/traffic/singles-shallow.json").write_text(json.dumps(mix))
    (copy / "portbench/metrics/bound_pods.py").write_text(
        "def read(run):\n    return float(sum(e.kind == 'bind' for e in run.events))\n"
    )
    b["workloads"].append(dict(name="batch5k.singles-shallow", config="batch5k",
                               traffic="singles-shallow", chips=1, why="test"))
    b["per_layer"].append(dict(name="bound_pods", unit="pods", better="higher",
                               source="host_clock", layer="serve loop",
                               moves="pods_per_s", workloads=["batch5k.singles-shallow"]))
    cell = runner.find_cell(copy, b, "batch5k.singles-shallow")
    assert cell.mix["pending_target"] == 96
    assert [m["name"] for m in cell.per_layer] == ["first_restack_ms", "bound_pods"]
    reader = runner.load_module(copy / "portbench/metrics/bound_pods.py")
    assert reader.read(runner.Run("x")) == 0.0
    after = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[p] == data for p, data in before.items())
