"""Process-mode lanes (``framework/procserve.py``: the commit transport,
``CommitRPCServer`` / ``CommitRPCClient``, ``WorkerFence``, the worker
entries; ``RemoteAccountant``; ``WorkerSupervisor``), held against
yoda_tpu.

Every case of ``tests/test_procserve.py`` runs on both packages from the
reference's own source (``torch_refcases.run_case``), with its exact
assertions; none is left out. On the port's side a worker process a case
spawns (its own spec worker, the port's chaos module's ``DriveWorker``) is
the port's worker, on the host (``--device cpu``).

Beside them: a seeded process drive (a parent and two spec worker
processes) on each package, whose lanes' journal records, bindings,
parent claims and reports are equal between the packages; drive workers
of each package against a parent of each, over a Unix socket and TCP,
deciding alike; the worker entry's default of the card; and chip_smoke's
run (p) at its small size (``TestRunP``).
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_refcases import PACKAGES, cases, run_case

REF = "test_procserve.py"
SKIP: "dict[str, str]" = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


# --- a seeded process drive on both packages --------------------------------

REPO = Path(__file__).resolve().parent.parent


def _side(pkg: str) -> types.SimpleNamespace:
    mod = importlib.import_module
    return types.SimpleNamespace(
        FakeCluster=mod(f"{pkg}.cluster.fake").FakeCluster,
        FakeTpuAgent=mod(f"{pkg}.agent").FakeTpuAgent,
        ChipAccountant=mod(f"{pkg}.plugins.yoda.accounting").ChipAccountant,
        FileJournal=mod(f"{pkg}.journal").FileJournal,
        procserve=mod(f"{pkg}.framework.procserve"),
        shards=mod(f"{pkg}.framework.shards"),
        PodSpec=mod(f"{pkg}.api.types").PodSpec,
    )


def worker_cmd(pkg: str, *args: str) -> "list[str]":
    """A worker process of ``pkg`` (the port's on the host)."""
    cmd = [sys.executable, "-m", f"{pkg}.framework.procserve", *args]
    return cmd + (["--device", "cpu"] if pkg == "yoda_tpu_torch" else [])


def worker_env() -> dict:
    # One string hash seed for every worker: a gang's Permit waiters are
    # released in set order, and so are the uids of a commit record.
    return dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu")


def drive_pods() -> "list[tuple[str, dict]]":
    """Seeded pods: 3 plain gangs of 4 x 2 chips and 16 singletons of
    1-8 chips."""
    rng = np.random.default_rng(5)
    pods = [(f"g{g}-{m:02d}", {"tpu/gang": f"g{g}", "tpu/gang-size": "4",
                                "tpu/chips": "2"})
            for g in range(3) for m in range(4)]
    pods += [(f"s{i:02d}", {"tpu/chips": str(int(rng.choice([1, 2, 4, 8])))})
             for i in range(16)]
    return [pods[i] for i in rng.permutation(len(pods))]


def process_drive(pkg: str, tmp: Path, lanes: int = 2) -> dict:
    """A parent (the journal-owning accountant of ``pkg`` behind its
    ``CommitRPCServer``) and ``lanes`` spec worker processes of ``pkg``,
    each given its ``ShardMap`` partition of 16 v5e hosts and the pods the
    router sends its lane. Returns each lane's journal records, the
    committed bindings, the parent's claims and counts, and the reports
    less their clocks."""
    from chip_smoke import P1_REPORT_KEYS, journal_frames, lane_records

    s = _side(pkg)
    cluster = s.FakeCluster()
    acc = s.ChipAccountant()
    acc.track_capacity = True
    journal = s.FileJournal(str(tmp / "journal"))
    journal.open()
    acc.journal = journal
    smap = s.shards.ShardMap(lanes)
    router = s.shards.ShardRouter(smap)
    cluster.add_watcher(router.observe, batch_fn=router.observe_batch)
    cluster.add_watcher(acc.handle)
    agent = s.FakeTpuAgent(cluster)
    for h in range(16):
        agent.add_host(f"v5e-{h:02d}", generation="v5e", chips=8)
    agent.publish_all()
    hosts: dict = {}
    for t in cluster.list_tpu_metrics():
        lane = next(i for i in range(lanes) if smap.node_filter(i)(t.name, t))
        hosts.setdefault(lane, []).append(
            {"name": t.name, "generation": "v5e", "chips": 8})
    routed: dict = {}
    for name, labels in drive_pods():
        lane = router.route(s.PodSpec(name, labels=labels, uid=f"default/{name}"))
        routed.setdefault(lane, []).append({"name": name, "labels": labels})
    assert "global" not in routed and len(routed) == lanes
    sock_dir = tempfile.mkdtemp(prefix="yoda-pd-")
    sock = os.path.join(sock_dir, "c.sock")
    server = s.procserve.CommitRPCServer(acc, sock, fence_fn=lambda: True,
                                         expected_workers=lanes)
    server.start()
    procs = []
    try:
        for i in range(lanes):
            spec = {"socket": sock, "shard_index": i, "workers": lanes,
                    "config": {"batch_requests": 4}, "hosts": hosts[i],
                    "pods": routed[f"s{i}"]}
            path = tmp / f"s{i}.json"
            path.write_text(json.dumps(spec))
            procs.append(subprocess.Popen(
                worker_cmd(pkg, "--serve-spec", str(path)), cwd=REPO,
                env=worker_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))
        errs = [p.communicate(timeout=240)[1] for p in procs]
        assert [p.returncode for p in procs] == [0] * lanes, [e[-2000:] for e in errs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        reports = dict(server.reports)
        server.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
    journal.close()
    records, bindings = lane_records(journal_frames(tmp / "journal"))
    return dict(
        records=records, bindings=bindings, claims=acc.claims_snapshot(),
        staged=acc.staged_count(), commits=acc.commit_commits,
        conflicts=acc.commit_conflicts,
        reports={lane: {k: r.get(k) for k in P1_REPORT_KEYS}
                 for lane, r in reports.items()},
        routed={lane: [p["name"] for p in pods] for lane, pods in routed.items()},
    )


def test_seeded_process_drive_equal_on_both_packages(tmp_path):
    """Two spec worker processes per package behind that package's parent:
    every pod binds and commits through the parent, and each lane's
    journal records, the bindings, the parent's claims and counts and the
    reports are equal between the packages (tolerance 0)."""
    got = {}
    for pkg in PACKAGES:
        (tmp_path / pkg).mkdir()
        got[pkg] = process_drive(pkg, tmp_path / pkg)
    ref, port = got["yoda_tpu"], got["yoda_tpu_torch"]
    names = [n for n, _ in drive_pods()]
    assert sorted(k.split("/", 1)[1] for k in ref["bindings"]) == sorted(names)
    assert ref["staged"] == 0 and ref["conflicts"] == 0 and ref["claims"] == {}
    assert sorted(ref["records"]) == ["s0", "s1"]
    for key in ref:
        assert port[key] == ref[key], key


# --- the wire between the packages ------------------------------------------


def _parent(s, tmp: Path):
    cluster = s.FakeCluster()
    acc = s.ChipAccountant()
    acc.track_capacity = True
    journal = s.FileJournal(str(tmp / "journal"))
    journal.open()
    acc.journal = journal
    cluster.add_watcher(acc.handle)
    agent = s.FakeTpuAgent(cluster)
    for i in range(2):
        agent.add_host(f"host-{i}", generation="v5e", chips=8)
    agent.publish_all()
    return acc


def cross_drive(worker_pkg: str, server_pkg: str, transport: str, tmp: Path) -> dict:
    """A drive worker process of ``worker_pkg`` against a parent of
    ``server_pkg`` over ``transport``: it stages a gang of 2 x 3 chips on
    host-0 and commits it; a client of the parent's package stages 4
    chips on host-0 from another lane (refused at commit: capacity) and
    releases it; the worker releases one member and exits. Returns every
    verdict and the parent's state and journal records."""
    from chip_smoke import journal_frames, lane_records

    s = _side(server_pkg)
    acc = _parent(s, tmp)
    sock_dir = tempfile.mkdtemp(prefix="yoda-x-")
    endpoint = (os.path.join(sock_dir, "c.sock") if transport == "unix"
                else "127.0.0.1:0")
    server = s.procserve.CommitRPCServer(acc, endpoint, fence_fn=lambda: True)
    server.start()
    spec = {"socket": server.endpoint, "shard": "s0",
            "claims": [{"uid": f"default/ga-{m}", "node": "host-0", "chips": 3,
                        "gang": "ga"} for m in range(2)]}
    path = tmp / "drive.json"
    path.write_text(json.dumps(spec))
    proc = subprocess.Popen(worker_cmd(worker_pkg, "--drive", str(path)), cwd=REPO,
                            env=worker_env(), stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lines = [proc.stdout.readline().strip()]
        proc.stdin.write("COMMIT\n")
        proc.stdin.flush()
        lines.append(proc.stdout.readline().strip())
        cl = s.procserve.CommitRPCClient(server.endpoint, shard="s1")
        cl.stage("default/over", "host-0", 4, "s1")
        refused = cl.commit(["default/over"])
        cl.release("default/over")
        cl.close()
        proc.stdin.write("RELEASE default/ga-0\n")
        proc.stdin.flush()
        lines.append(proc.stdout.readline().strip())
        proc.stdin.write("EXIT\n")
        proc.stdin.flush()
        assert proc.wait(timeout=60) == 0, proc.stderr.read()[-2000:]
        view = server.debug()["workers"]
    finally:
        if proc.poll() is None:
            proc.kill()
        server.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
    acc.journal.close()
    return dict(
        transport=server.transport.kind, lines=lines, refused=refused,
        chips=acc.chips_by_node(), staged=acc.staged_count(),
        claims=acc.claims_snapshot(), lanes=sorted(r["lane"] for r in view),
        records=lane_records(journal_frames(tmp / "journal")),
    )


@pytest.mark.parametrize("transport", ["unix", "tcp"])
def test_drive_workers_across_packages_decide_alike(transport, tmp_path):
    """A reference drive worker against the port's ``CommitRPCServer`` and
    a port drive worker against the reference's give the decisions,
    parent state and journal records of each package's own pair."""
    got = {}
    for worker in PACKAGES:
        for server in PACKAGES:
            d = tmp_path / f"{worker}-{server}"
            d.mkdir()
            got[worker, server] = cross_drive(worker, server, transport, d)
    want = got["yoda_tpu", "yoda_tpu"]
    assert want["transport"] == transport
    assert want["lines"] == ["STAGED", "COMMITTED 1", "RELEASED"]
    assert want["refused"][0] is False and "capacity" in want["refused"][1]
    assert want["chips"] == {"host-0": 3} and want["staged"] == 0
    for pair, result in got.items():
        assert result == want, pair


# --- process-mode entry points on the host ------------------------------------


@pytest.mark.skipif(
    torch.cuda.is_available(), reason="checks the worker on a machine without a card"
)
def test_worker_defaults_to_the_card(tmp_path):
    """``python -m yoda_tpu_torch.framework.procserve`` evaluates on the
    card unless asked for the host: without ``--device`` and without a
    card its spec worker exits nonzero naming the card, having bound
    nothing."""
    from yoda_tpu_torch.framework.procserve import CommitRPCServer

    s = _side("yoda_tpu_torch")
    acc = _parent(s, tmp_path)
    sock_dir = tempfile.mkdtemp(prefix="yoda-d-")
    server = CommitRPCServer(acc, os.path.join(sock_dir, "c.sock"))
    server.start()
    try:
        spec = tmp_path / "w.json"
        spec.write_text(json.dumps({
            "socket": server.endpoint, "workers": 1,
            "hosts": [{"name": "h", "chips": 8}],
            "pods": [{"name": "p", "labels": {"tpu/chips": "1"}}]}))
        proc = subprocess.run(
            [sys.executable, "-m", "yoda_tpu_torch.framework.procserve",
             "--serve-spec", str(spec)],
            cwd=REPO, env=worker_env(), capture_output=True, text=True, timeout=120)
    finally:
        server.stop()
        acc.journal.close()
        shutil.rmtree(sock_dir, ignore_errors=True)
    assert proc.returncode != 0
    assert "CUDA device" in proc.stderr and "none is available" in proc.stderr
    assert acc.claims_snapshot() == {} and not server.reports


class TestRunP:
    """chip_smoke's run (p) at its small size on the CPU (``--device cpu``
    workers): (p1) the spec workers behind ``build_proc_parent``, (p2) the
    CLI with process lanes and a killed worker, (p3) the tailing standby's
    warm promotion, each holding every check the card's run is held to,
    less the kernel launches and nvidia-smi."""

    def test_p1_spec_workers(self):
        from chip_smoke import (
            PROC_SMALL,
            check_proc_spec_run,
            run_proc_spec,
            run_proc_threads,
        )

        run = run_proc_spec("cpu", PROC_SMALL)
        check_proc_spec_run(run, PROC_SMALL)
        assert run["pods"] == 40 and sorted(run["lanes"]) == ["s0", "s1"]
        assert all(k is None for k in run["kernels"].values())
        # The same script in one worker process, and as thread lanes.
        one = dict(PROC_SMALL, shards=1)
        single = run_proc_spec("cpu", one, "p1-single")
        check_proc_spec_run(single, one)
        assert set(single["bindings"]) == set(run["bindings"])
        threads = run_proc_threads("cpu", PROC_SMALL)
        assert threads["bound"] == threads["pods"] == run["pods"]

    def test_p2_cli_with_a_killed_worker(self):
        from chip_smoke import PROC_WIRE_SMALL, check_proc_wire, run_proc_wire

        run = run_proc_wire("cpu", PROC_WIRE_SMALL)
        check_proc_wire(run, PROC_WIRE_SMALL, card=False)
        assert run["kill_to_respawned_first_bind_ms"] is not None

    def test_p3_tailing_standby(self):
        from chip_smoke import PROC_WIRE_SMALL, check_proc_standby, run_proc_standby

        check_proc_standby(run_proc_standby("cpu", PROC_WIRE_SMALL))
