"""The port's process entry point (yoda_tpu_torch/cli.py), held against
yoda_tpu.

Every case of ``tests/test_cli.py`` that needs no unported part runs on
both packages from the reference's own source (``torch_refcases.run_case``)
against each package's own fake API server: the scheduler binding a pod,
a topology gang (with its Scheduled Events) and a selector-steered pod
over real HTTP, a bad config rejected, and ``/healthz`` / ``/readyz``
staying 200 while the overload ladder sheds. Left out, with the part they
wait for (ROADMAP queue 1):

- ``TestAgentMode`` (three cases): the node agent, item 11;
- ``TestFederatedSchedulerMode``: federation, item 9.

Port-only cases: without ``--device cpu`` (and with a config that leaves
``kernel_platform`` at "auto") the CLI on a machine without a card exits
nonzero naming the card, in a process of its own; every unported mode
exits 2 naming its ROADMAP item before it touches the API server;
``--demo --device cpu`` prints the reference demo's placements; and
chip_smoke's runs (l1) and (l2) at their small size on the CPU
(``TestRunL``).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_refcases import PACKAGES, cases, run_case

REPO = Path(__file__).resolve().parent.parent

REF = "test_cli.py"
SKIP = {
    "TestAgentMode::test_agent_requires_node_name": "node agent (item 11)",
    "TestAgentMode::test_agent_refuses_fake_without_flag": "node agent (item 11)",
    "TestAgentMode::test_agent_publishes_fake_profile": "node agent (item 11)",
    "TestFederatedSchedulerMode::test_readyz_follows_degraded_readiness_with_dead_remote":
        "federation (item 9)",
}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


@pytest.mark.skipif(
    torch.cuda.is_available(), reason="checks the CLI on a machine without a card"
)
def test_default_device_without_a_card_exits_nonzero_naming_the_card(tmp_path):
    from yoda_tpu_torch.testing import FakeKubeApiServer

    with FakeKubeApiServer() as srv:
        env = dict(os.environ, YODA_KUBE_API_URL=srv.base_url)
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run(
            [sys.executable, "-m", "yoda_tpu_torch.cli", "--metrics-port", "-1"],
            env=env,
            cwd=tmp_path,
            capture_output=True,
            text=True,
            timeout=120,
        )
    assert proc.returncode != 0
    assert "CUDA device" in proc.stderr and "none is available" in proc.stderr
    assert "serving" not in proc.stderr


UNPORTED = [
    (["--agent"], None, "item 11"),
    (["--federate-url", "remote=http://127.0.0.1:1"], None, "item 9"),
    ([], "shard_count: 2\n", "item 9"),
    ([], "profiles:\n  - scheduler_name: other\n", "item 9"),
    ([], "commit_endpoint: 127.0.0.1:1\n", "item 9"),
]


@pytest.mark.parametrize(
    "argv, config, item", UNPORTED, ids=["agent", "federate", "shards", "profiles", "tail"]
)
def test_unported_mode_exits_2_naming_its_item(argv, config, item, tmp_path, capsys, monkeypatch):
    from yoda_tpu_torch.cli import main

    # No API server behind this URL: an unported mode must refuse before
    # dialling one.
    monkeypatch.setenv("YODA_KUBE_API_URL", "http://127.0.0.1:1")
    if config is not None:
        path = tmp_path / "config.yaml"
        path.write_text(config)
        argv = argv + ["--config", str(path)]
    assert main(argv + ["--metrics-port", "-1", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert item in err and "not ported to yoda_tpu_torch" in err


def test_demo_on_the_host_prints_the_reference_placements(capsys):
    from yoda_tpu.cli import main as ref_main
    from yoda_tpu_torch.cli import main as port_main

    def placements(text: str) -> list[str]:
        return text.split("\n\n")[0].splitlines()

    assert ref_main(["--demo", "-v", "0"]) == 0
    want = placements(capsys.readouterr().out)
    assert port_main(["--demo", "--device", "cpu", "-v", "0"]) == 0
    got = placements(capsys.readouterr().out)
    assert got == want and len(got) == 6


class TestRunL:
    """chip_smoke's run (l) at its small size on the CPU (``--device
    cpu``): the process over the wire and the failover hold every check
    the card's run is held to, less the kernel launches."""

    def test_wire_and_failover_hold_their_checks(self):
        from chip_smoke import PROCESS_SMALL, check_process, run_failover, run_wire

        l1 = run_wire("cpu", PROCESS_SMALL)
        l2 = run_failover("cpu", PROCESS_SMALL)
        check_process(l1, l2, card=False)
        assert l1["bound"] == l1["pods"] and l1["fused_plan_dispatches"] == 1
        assert l1["launches"] == {"fleet_eval": 0, "joint_fit": 0, "update_rows": 0}
