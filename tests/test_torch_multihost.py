"""The multi-host control plane (the TCP commit transport, epoch term
fencing, ``journal/tail.py``'s tailing standby, partition residue), held
against yoda_tpu.

Every case of ``tests/test_multihost.py`` runs on both packages from the
reference's own source (``torch_refcases.run_case``), with its exact
assertions; none is left out. Each package's side runs over its own
chaos module's ``ChaosTcpProxy``, ``ChaosPlan`` and ``DriveWorker`` (the
port's spawns the port's worker, on the host under the harness).

Beside them, a tailer of each package follows a parent of each package
over TCP to zero lag and promotes warm: every combination holds what the
reference's own pair holds (tolerance 0).
"""

from __future__ import annotations

import importlib
import types
from pathlib import Path

import pytest
from torch_refcases import PACKAGES, cases, run_case

REF = "test_multihost.py"
SKIP: "dict[str, str]" = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


# --- the tailing standby across the packages ----------------------------------


def _side(pkg: str) -> types.SimpleNamespace:
    mod = importlib.import_module
    return types.SimpleNamespace(
        FakeCluster=mod(f"{pkg}.cluster.fake").FakeCluster,
        FakeTpuAgent=mod(f"{pkg}.agent").FakeTpuAgent,
        ChipAccountant=mod(f"{pkg}.plugins.yoda.accounting").ChipAccountant,
        FileJournal=mod(f"{pkg}.journal").FileJournal,
        procserve=mod(f"{pkg}.framework.procserve"),
        tail=mod(f"{pkg}.journal.tail"),
    )


def _accountant(s, journal_dir=None):
    cluster = s.FakeCluster()
    acc = s.ChipAccountant()
    acc.track_capacity = True
    if journal_dir is not None:
        journal = s.FileJournal(str(journal_dir))
        journal.open()
        acc.journal = journal
    cluster.add_watcher(acc.handle)
    agent = s.FakeTpuAgent(cluster)
    for i in range(2):
        agent.add_host(f"host-{i}", generation="v5e", chips=64)
    agent.publish_all()
    return acc


def tail_across(parent_pkg: str, standby_pkg: str, tmp: Path) -> dict:
    """A journal-owning parent of ``parent_pkg`` on TCP with 12 claims
    staged (gangs among them) and half committed; a ``JournalTailer`` of
    ``standby_pkg`` polls it to zero lag, then new activity (one stage and
    commit) and a second poll; then it promotes into a fresh accountant and
    journal of ``standby_pkg``. Returns what the tailer and the promoted
    standby hold."""
    p, s = _side(parent_pkg), _side(standby_pkg)
    parent = _accountant(p, tmp / "parent")
    for i in range(12):
        gang = f"g{i // 4}" if i % 4 < 2 else ""
        parent.stage(f"default/p{i}", f"host-{i % 2}", 1, f"s{i % 2}", gang)
    ok, why = parent.commit_staged([f"default/p{i}" for i in range(6)])
    assert ok, why
    server = p.procserve.CommitRPCServer(parent, "127.0.0.1:0")
    server.start()
    try:
        client = s.procserve.CommitRPCClient(server.endpoint, shard="standby")
        tailer = s.tail.JournalTailer(client)
        first = tailer.poll_once()
        lag_first = tailer.lag_frames
        parent.stage("default/new", "host-0", 2, "s0", "")
        ok, why = parent.commit_staged(["default/new"])
        assert ok, why
        second = tailer.poll_once()
        client.close()
    finally:
        server.stop()
    standby = _accountant(s, tmp / "standby")
    term = tailer.promote_into(standby, standby.journal, snapshot="sync")
    standby.journal.close()
    replayed = s.FileJournal(str(tmp / "standby")).open()
    out = dict(
        applied=(first, second), lag=(lag_first, tailer.lag_frames),
        synced=tailer.synced, divergence=tailer.divergence(), term=term,
        in_use={n: v for n, v in tailer.in_use.items() if v},
        staged=sorted(tailer.staged),
        parent_chips={n: v for n, v in parent.chips_by_node().items() if v},
        parent_staged=sorted(parent.staged_uids()),
        standby_chips={n: v for n, v in standby.chips_by_node().items() if v},
        standby_staged=sorted(standby.staged_uids()),
        replayed_term=replayed.term,
        replayed=sorted((u, tuple(c)) for u, c in replayed.claims.items()),
    )
    parent.journal.close()
    return out


def test_tailer_follows_a_parent_of_the_other_package(tmp_path):
    """A port ``JournalTailer`` tails a reference parent to zero lag and
    promotes warm at the next term, and a reference tailer a port parent;
    every combination holds what the reference's own pair holds."""
    got = {}
    for parent in PACKAGES:
        for standby in PACKAGES:
            d = tmp_path / f"{parent}-{standby}"
            d.mkdir()
            got[parent, standby] = tail_across(parent, standby, d)
    want = got["yoda_tpu", "yoda_tpu"]
    assert want["lag"] == (0, 0) and want["synced"] and want["divergence"] is None
    assert want["applied"][1] == 2 and want["term"] == 2 and want["replayed_term"] == 2
    assert want["in_use"] == want["parent_chips"] == want["standby_chips"]
    assert want["staged"] == want["parent_staged"] == want["standby_staged"]
    for pair, result in got.items():
        assert result == want, pair
