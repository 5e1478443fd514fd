"""The durable claim journal (``yoda_tpu_torch/journal/``, the
accountant's write-ahead records, warm-start restore and the reconciler's
warm resync), held against yoda_tpu.

Every case of ``tests/test_journal.py`` runs on both packages from the
reference's own source (``torch_refcases.run_case``), with its exact
assertions; none is left out. ``TestChaosDiskFaults`` drives each
package's own chaos module's ``FaultyJournalIO`` over that package's
``RealJournalIO`` and ``JournalFault``.
``TestReplayVsColdResyncBench`` keeps the reference's ``slow`` mark.

Beside them: the record format is the reference's byte for byte — one
seeded script of every record kind, with rotation, written by both
packages gives identical segment files, and each package's journal
replays in the other to the same ``ReplayedState``.
"""

from __future__ import annotations

import random

import pytest
from torch_refcases import PACKAGES, cases, run_case

import yoda_tpu.journal as ref_journal
import yoda_tpu_torch.journal as port_journal

REF = "test_journal.py"
SKIP: "dict[str, str]" = {}

JOURNALS = {"yoda_tpu": ref_journal, "yoda_tpu_torch": port_journal}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


def record_script(seed: int, n: int = 400) -> list:
    """A seeded run of accountant mutations: staged claims (some of a
    gang), commits of staged cohorts, releases, rollbacks and one term
    bump."""
    rng = random.Random(seed)
    live: dict[str, str] = {}  # uid -> shard ("" = committed)
    ops: list = []
    seq = 0
    for i in range(n):
        roll = rng.random()
        staged = [u for u, sh in live.items() if sh]
        committed = [u for u, sh in live.items() if not sh]
        if roll < 0.45 or not live:
            uid = f"ns/p{i}#{rng.randrange(1 << 16)}"
            shard = rng.choice(["", "s0", "s1", "global"])
            seq += 1 if shard else 0
            gang = rng.choice(["", "", f"g{rng.randrange(4)}"]) if shard else ""
            node = f"host-{rng.randrange(64)}"
            ops.append(("stage", uid, node, rng.choice([1, 2, 4, 8]), shard,
                        seq if shard else 0, gang))
            live[uid] = shard
        elif roll < 0.65 and staged:
            cohort = rng.sample(staged, min(len(staged), rng.randrange(1, 5)))
            ops.append(("commit", cohort))
            for u in cohort:
                live[u] = ""
        elif roll < 0.85 and committed:
            uid = rng.choice(committed)
            ops.append(("release", uid))
            del live[uid]
        elif staged:
            uid = rng.choice(staged)
            ops.append(("rollback", uid))
            del live[uid]
        if i == n // 2:
            ops.append(("term", 3))
    return ops


def write(pkg: str, path, ops, **kw):
    j = JOURNALS[pkg].FileJournal(str(path), sync="always", **kw)
    j.open()
    for op in ops:
        kind, args = op[0], op[1:]
        if kind == "stage":
            j.record_stage(*args)
        elif kind == "commit":
            j.record_commit(args[0])
        elif kind == "release":
            j.record_release(args[0])
        elif kind == "rollback":
            j.record_rollback(args[0])
        else:
            j.record_term_bump(args[0])
    j.close()
    return j


def files(path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


def state_of(state) -> tuple:
    return (state.claims, state.stage_seq, state.tail_seq, state.term,
            state.torn_records)


class TestSameBytes:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("segment_bytes", [4 << 20, 2048])
    def test_both_packages_write_identical_segments(self, seed, segment_bytes, tmp_path):
        ops = record_script(seed)
        for pkg in PACKAGES:
            write(pkg, tmp_path / pkg, ops, segment_bytes=segment_bytes)
        ref, port = files(tmp_path / "yoda_tpu"), files(tmp_path / "yoda_tpu_torch")
        assert port == ref
        assert sum(len(b) for b in ref.values()) > 0
        if segment_bytes == 2048:
            # Rotation ran: the live segment opens with a snapshot record.
            assert ref_journal.FileJournal(str(tmp_path / "yoda_tpu")).open().tail_seq > 0


class TestCrossReplay:
    @pytest.mark.parametrize("seed", [3, 4])
    @pytest.mark.parametrize("writer", PACKAGES)
    def test_each_journal_replays_in_the_other(self, seed, writer, tmp_path):
        ops = record_script(seed)
        write(writer, tmp_path / "j", ops, segment_bytes=4096)
        states = {
            reader: state_of(JOURNALS[reader].FileJournal(str(tmp_path / "j")).open())
            for reader in PACKAGES
        }
        assert states["yoda_tpu"] == states["yoda_tpu_torch"]
        assert states["yoda_tpu"][0], "the script left live claims"
        assert states["yoda_tpu"][3] == 3  # the term bump replayed

    def test_torn_tail_repairs_alike(self, tmp_path):
        ops = record_script(5, 120)
        for pkg in PACKAGES:
            write(pkg, tmp_path / pkg, ops)
            (seg,) = sorted((tmp_path / pkg).iterdir())
            data = seg.read_bytes()
            seg.write_bytes(data[: len(data) - 7])  # cut inside the last frame
        got = {
            pkg: state_of(JOURNALS[pkg].FileJournal(str(tmp_path / pkg)).open())
            for pkg in PACKAGES
        }
        assert got["yoda_tpu"] == got["yoda_tpu_torch"]
        assert got["yoda_tpu"][4] == 1
        assert files(tmp_path / "yoda_tpu") == files(tmp_path / "yoda_tpu_torch")
