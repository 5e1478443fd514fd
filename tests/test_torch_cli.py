"""The port's process entry point (yoda_tpu_torch/cli.py), held against
yoda_tpu.

Every case of ``tests/test_cli.py`` runs on both packages from the
reference's own source (``torch_refcases.run_case``) against each
package's own fake API server: the scheduler binding a pod, a topology
gang (with its Scheduled Events) and a selector-steered pod over real
HTTP, a bad config rejected, ``/healthz`` / ``/readyz`` staying 200 while
the overload ladder sheds, the node agent (``TestAgentMode``: its
refusals and a fake profile published) and federated mode with a dead
remote (``TestFederatedSchedulerMode``: degraded readiness, a home bind,
the remote at LOST). None is left out.

Port-only cases: without ``--device cpu`` (and with a config that leaves
``kernel_platform`` at "auto") the CLI on a machine without a card exits
nonzero naming the card, in a process of its own; with ``--device cpu``
federated mode (a dead remote) and the agent (the reader built from
``native/``) each serve in a process of their own and exit 0 on SIGTERM;
``shard_count: 2`` (thread lanes), ``profiles`` and ``shard_mode:
process`` (worker processes on the host, on a Unix socket and on TCP)
serve over the fake API server and bind a pod of every lane or profile,
the reload of ``shard_count`` resizing thread lanes, with
``/debug/shards`` and ``/debug/journal`` answering;
``--demo --device cpu`` prints the reference demo's placements; and
chip_smoke's runs (l1) and (l2) at their small size on the CPU
(``TestRunL``).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_refcases import PACKAGES, cases, run_case

REPO = Path(__file__).resolve().parent.parent

REF = "test_cli.py"
SKIP: dict = {}


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


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("mode", ["federate", "agent"])
def test_federated_and_agent_modes_serve_in_a_process(mode, tmp_path):
    """``python -m yoda_tpu_torch.cli --device cpu`` in a process of its
    own, over the port's fake API server: with ``--federate-url`` naming a
    dead remote it comes up, ``/readyz`` turns 200 once home resynced and
    a pod binds at home while ``/metrics`` reports the remote LOST; with
    ``--agent`` (the reader built from ``native/`` under
    ``YODA_TPUINFO_SPEC``) it publishes the node's CR. Each exits 0 on
    SIGTERM."""
    import signal
    import urllib.request

    from yoda_tpu_torch.api.types import PodSpec, make_node
    from yoda_tpu_torch.cluster import KubeApiClient, KubeApiConfig, KubeCluster
    from yoda_tpu_torch.testing import FakeKubeApiServer, wait_until

    dead = FakeKubeApiServer().start()
    dead_url = dead.base_url
    dead.stop()
    with FakeKubeApiServer() as srv:
        env = dict(os.environ, YODA_KUBE_API_URL=srv.base_url)
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        port = _free_port()
        if mode == "federate":
            cfg = tmp_path / "config.yaml"
            cfg.write_text(
                "federation_degraded_after_s: 0.2\n"
                "federation_partitioned_after_s: 0.4\n"
                "federation_lost_after_s: 0.8\n"
                "federation_probe_period_s: 0.1\n"
            )
            argv = ["--config", str(cfg), "--metrics-port", str(port), "--device", "cpu",
                    "--federate-url", f"remote={dead_url}"]
        else:
            env["YODA_TPUINFO_SPEC"] = "generation=v5e;chips=8"
            argv = ["--agent", "--node-name", "agent-0", "--interval-s", "0.2"]
        seed = KubeCluster(
            KubeApiClient(KubeApiConfig(base_url=srv.base_url, watch_timeout_s=2))
        )
        proc = subprocess.Popen(
            [sys.executable, "-m", "yoda_tpu_torch.cli", *argv],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        try:
            if mode == "federate":
                seed.put_tpu_metrics(make_node("fh-1", chips=4))
                base = f"http://127.0.0.1:{port}"

                def get(path: str) -> "tuple[int, str]":
                    try:
                        r = urllib.request.urlopen(f"{base}{path}", timeout=1)
                        return r.status, r.read().decode()
                    except Exception:  # noqa: BLE001 — not up yet / 503
                        return 0, ""

                wait_until(lambda: get("/readyz")[0] == 200, timeout_s=90.0,
                           msg="/readyz 200 with a dead remote")
                seed.create_pod(PodSpec("fed-pod", labels={"tpu/chips": "1"}))
                wait_until(
                    lambda: (srv.get_object("Pod", "default/fed-pod") or {})
                    .get("spec", {}).get("nodeName") == "fh-1",
                    timeout_s=60.0, msg="home bound the pod")
                wait_until(
                    lambda: 'yoda_cluster_state{cluster="remote"} 3' in get("/metrics")[1],
                    timeout_s=60.0, msg="remote reported LOST")
            else:
                wait_until(
                    lambda: srv.get_object("TpuNodeMetrics", "agent-0") is not None,
                    timeout_s=60.0, msg="agent published its CR")
                status = srv.get_object("TpuNodeMetrics", "agent-0")["status"]
                assert status["chipCount"] == 8 and status["generation"] == "v5e"
                assert status["source"] == "env"
        finally:
            proc.send_signal(signal.SIGTERM)
            _out, err = proc.communicate(timeout=60)
            seed.stop()
        assert proc.returncode == 0, err[-2000:]
        assert ("clusters=['home', 'remote']" in err) if mode == "federate" else (
            "publishing agent-0" in err)


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


LANES = [
    "shard_count: 2\njournal_path: {journal}\n",
    "profiles:\n  - scheduler_name: other\n    scoring_strategy: most-allocated\n",
    "shard_count: 2\nshard_mode: process\njournal_path: {journal}\n",
    "shard_count: 2\nshard_mode: process\njournal_path: {journal}\n"
    "commit_listen: 127.0.0.1:0\n",
]


@pytest.mark.parametrize(
    "config", LANES, ids=["shards", "profiles", "process", "process-tcp"]
)
def test_lanes_and_profiles_serve(config, tmp_path, monkeypatch):
    """``shard_count: 2`` (thread lanes, with the journal), ``profiles``
    and ``shard_mode: process`` (two worker processes on the host, given
    the CLI's ``--device cpu``, over the commit RPC on a Unix socket or on
    TCP at ``commit_listen``) build, serve over the port's fake API server
    and bind a topology gang and singletons of every lane or profile;
    ``/debug/shards`` lists the lanes (thread lanes under this pid, process
    lanes as live workers of their own pids) and ``/debug/journal`` the
    journal's summary; a ``shard_count`` reload resizes thread lanes."""
    import json
    import threading
    import urllib.request

    from yoda_tpu_torch.api.types import PodSpec, make_node
    from yoda_tpu_torch.cli import main
    from yoda_tpu_torch.cluster import KubeApiClient, KubeApiConfig, KubeCluster
    from yoda_tpu_torch.testing import FakeKubeApiServer, wait_until

    sharded = config.startswith("shard_count")
    process = "shard_mode: process" in config
    path = tmp_path / "config.yaml"
    path.write_text(config.format(journal=tmp_path / "journal"))
    with FakeKubeApiServer() as srv:
        monkeypatch.setenv("YODA_KUBE_API_URL", srv.base_url)
        seed = KubeCluster(
            KubeApiClient(KubeApiConfig(base_url=srv.base_url, watch_timeout_s=2))
        )
        for s in range(4):
            for i in range(4):
                seed.put_tpu_metrics(make_node(
                    f"s{s}-{i}", chips=4, slice_id=f"slice-{s}",
                    topology_coords=(i % 2, i // 2, 0),
                ))
        port_file = tmp_path / "port"
        from yoda_tpu_torch import metrics_server

        real_start = metrics_server.MetricsServer.start

        def start(self):
            real_start(self)
            port_file.write_text(str(self.port))

        monkeypatch.setattr(metrics_server.MetricsServer, "start", start)
        stop = threading.Event()
        rc: list = []
        t = threading.Thread(
            target=lambda: rc.append(main(
                ["--config", str(path), "--metrics-port", "0", "--device", "cpu"],
                stop=stop,
            )),
            daemon=True,
        )
        t.start()
        try:
            names = ["yoda-tpu"] if sharded else ["yoda-tpu", "other"]
            pods = [
                PodSpec(f"p{i}", labels={"tpu/chips": "2"},
                        scheduler_name=names[i % len(names)])
                for i in range(8)
            ] + [
                PodSpec(f"g-{i}", labels={
                    "tpu/gang": "g", "tpu/topology": "2x2x1", "tpu/chips": "4",
                })
                for i in range(4)
            ]
            for p in pods:
                seed.create_pod(p)

            def bound():
                return all(
                    (srv.get_object("Pod", f"default/{p.name}") or {})
                    .get("spec", {}).get("nodeName")
                    for p in pods
                )

            wait_until(bound, timeout_s=90.0, msg="every pod bound")
            wait_until(port_file.exists, timeout_s=10.0, msg="metrics served")
            base = f"http://127.0.0.1:{port_file.read_text()}"
            shards = json.loads(urllib.request.urlopen(f"{base}/debug/shards").read())
            journal = json.loads(urllib.request.urlopen(f"{base}/debug/journal").read())
            if process:
                assert shards["mode"] == "process"
                assert [w["lane"] for w in shards["workers"]] == ["s0", "s1"]
                assert all(w["alive"] and w["restarts"] == 0 for w in shards["workers"])
                assert os.getpid() not in {w["pid"] for w in shards["workers"]}
                assert journal["enabled"] and journal["appends"] >= len(pods)
                metrics = urllib.request.urlopen(f"{base}/metrics").read().decode()
                kind = "tcp" if "commit_listen" in config else "unix"
                assert re.search(
                    r'yoda_commit_rpc_calls_total\{op="commit",shard="s[01]",'
                    f'transport="{kind}"' + r'\} [1-9]', metrics)
            elif sharded:
                assert shards["mode"] == "thread"
                assert [w["lane"] for w in shards["workers"]] == ["s0", "s1"]
                assert {w["pid"] for w in shards["workers"]} == {os.getpid()}
                assert journal["enabled"] and journal["appends"] >= len(pods)
                # A shard_count reload resizes the lanes in place.
                path.write_text("shard_count: 3\njournal_path: {}\n".format(
                    tmp_path / "journal"))
                wait_until(
                    lambda: len(json.loads(urllib.request.urlopen(
                        f"{base}/debug/shards").read())["workers"]) == 3,
                    timeout_s=30.0, msg="the reload resized the lanes",
                )
            else:
                assert shards == {"enabled": False}
                assert journal == {"enabled": False}
        finally:
            stop.set()
            t.join(timeout=30)
        assert rc == [0]
