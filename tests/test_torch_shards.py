"""Scheduler shard-out in one process (``framework/shards.py``, the
accountant's optimistic commit, ``standalone.build_sharded_stacks`` and
``ShardSet``), held against yoda_tpu.

Every case of ``tests/test_shards.py`` runs on both packages from the
reference's own source (``torch_refcases.run_case``), with its exact
assertions; none is left out (the reference's shard tests are all of
thread mode; ``shard_mode: process`` waits for ROADMAP item 9b).

Beside them, a seeded drive of four lanes through
``build_sharded_stacks`` on both packages on a stepped clock, lane by
lane in a fixed order: plain, topology and cross-shard gangs (one routed
to the global lane), commit conflicts (through the stale-map overlap
window, ``ShardMap(overlap=...)``, and the chips failing under a gang's
landed member, whose cohort then rolls back whole),
and a live ``resize`` from 4 lanes to 2; bindings, per-lane counters,
commit counts and the journal files are equal, byte for byte. And
chip_smoke's run (o) at its small size on the CPU.
"""

from __future__ import annotations

import dataclasses

import pytest
from torch_refcases import PACKAGES, cases, run_case

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.types as ref_types
import yoda_tpu.config as ref_config
import yoda_tpu.framework.shards as ref_shards
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent as port_agent
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.framework.shards as port_shards
import yoda_tpu_torch.standalone as port_standalone

REF = "test_shards.py"
SKIP: "dict[str, str]" = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


SIDES = {
    "yoda_tpu": (ref_standalone, ref_config, ref_agent, ref_types, ref_shards),
    "yoda_tpu_torch": (
        port_standalone, port_config, port_agent, port_types, port_shards,
    ),
}


class SteppedClock:
    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


def gang(types, tag, n, chips, *, topology=None):
    labels = {"tpu/gang": tag, "tpu/chips": str(chips)}
    if topology:
        labels["tpu/topology"] = topology
    else:
        labels["tpu/gang-size"] = str(n)
    return [pod(types, f"{tag}-{m}", labels) for m in range(n)]


def pod(types, name, labels):
    """A pod with a uid of its own name: a singleton routes on its uid,
    which must not depend on how many pods the process made before."""
    return types.PodSpec(name, labels=dict(labels), uid=f"default/{name}")


def lane_drive(pkg: str, journal_dir) -> dict:
    """Four lanes over 6 v5p 2x2x1 slices and 12 v5e hosts of 8 chips,
    the pool ``v5p-0`` pinned open to two lanes (the stale-map window),
    driven lane by lane on a held clock: waves of gangs and singletons,
    a gang no single lane can host (global lane), a live resize 4 -> 2,
    a last wave."""
    standalone, config, agent_mod, types, shards = SIDES[pkg]
    cfg = config.SchedulerConfig(
        shard_count=4, batch_requests=8, kernel_platform="cpu",
        journal_path=str(journal_dir), journal_sync="always",
        bind_workers=0, spec_enabled=False,
    )
    clock = SteppedClock()
    base = shards.ShardMap(4)
    owner = base.shard_of_pool("v5p-0")
    smap = shards.ShardMap(4, overlap={"v5p-0": [(owner + 1) % 4]})
    ss = standalone.build_sharded_stacks(config=cfg, clock=clock, shard_map=smap)
    cluster = ss.global_stack.cluster
    agent = agent_mod.FakeTpuAgent(cluster)
    for s in range(6):
        agent.add_slice(f"v5p-{s}", generation="v5p", host_topology=(2, 2, 1))
    for i in range(12):
        agent.add_host(f"v5e-{i}", generation="v5e", chips=8)
    agent.publish_all()

    def drain(rounds=4):
        for _ in range(rounds):
            ss.rescue_starved(min_attempts=1)
            for st in ss.stacks:
                st.scheduler.run_until_idle(max_wall_s=60)
            clock.now += 2.0
            for st in ss.stacks:
                st.framework.expire_waiting(now=clock.now)
                if st.queue.has_parked():
                    st.queue.move_all_to_active(force=True)

    routes = {}
    waves = [
        # Larger than any lane's partition: the global lane's.
        gang(types, "huge", 6, 8)
        + gang(types, "ta", 4, 4, topology="2x2")
        + gang(types, "tb", 4, 4, topology="2x2")
        + gang(types, "pa", 4, 4)
        + [pod(types, f"s{i}", {"tpu/chips": str(1 + i % 2)}) for i in range(12)],
        gang(types, "tc", 4, 4, topology="2x2")
        + [pod(types, f"t{i}", {"tpu/chips": "2"}) for i in range(8)],
    ]
    for wave in waves:
        for p in wave:
            routes[p.name] = ss.router.route(p)
            cluster.create_pod(p)
        drain()
    # A commit conflict and its whole-gang rollback: the chips of the host
    # under the first landing member of gang "pc" fail as the bind lands,
    # so the cohort's commit no longer validates (the host's healthy
    # capacity shrank under the staged claim); the gang rolls back whole,
    # and binds again once the chips are healed.
    failed: list = []
    real_bind = cluster.bind_pod

    def bind_pod(key, node):
        out = real_bind(key, node)
        if key.startswith("default/pc-") and not failed:
            tpu = next(t for t in cluster.list_tpu_metrics() if t.name == node)
            failed.append((node, range(len(tpu.chips))))
            agent.fail_chips(*failed[0])
        return out

    cluster.bind_pod = bind_pod
    for p in gang(types, "pc", 2, 4):
        routes[p.name] = ss.router.route(p)
        cluster.create_pod(p)
    drain()
    cluster.bind_pod = real_bind
    rollbacks = ss.metrics.shard_rollbacks.total()
    agent.heal_chips(*failed[0])
    drain()
    resize = ss.resize(2, quiesce_timeout_s=0.0)
    for p in gang(types, "pb", 2, 4) + [
        pod(types, f"u{i}", {"tpu/chips": "2"}) for i in range(6)
    ]:
        routes[p.name] = ss.router.route(p)
        cluster.create_pod(p)
    drain()
    ss.accountant.journal.close()
    out = {
        "routes": routes,
        "bound": sorted(
            (p.name, p.node_name) for p in cluster.list_pods() if p.node_name
        ),
        "lanes": [
            (st.scheduler.shard, st.scheduler.stats.binds,
             len(st.scheduler.stats.results))
            for st in ss.stacks
        ],
        "commits": ss.accountant.commit_commits,
        "conflicts": ss.accountant.commit_conflicts,
        "gang_rollbacks": rollbacks,
        "staged": ss.accountant.staged_uids(),
        "claims": ss.accountant.claims_snapshot(),
        "resize": {k: v for k, v in resize.items()},
        "journal": {
            p.name: p.read_bytes() for p in sorted(journal_dir.iterdir())
        },
        "caps": {
            ni.name: (ss.accountant.chips_in_use(ni.name), len(ni.tpu.healthy_chips()))
            for ni in ss.global_stack.informer.snapshot().infos()
        },
    }
    ss.close()
    return out


class TestLaneDrive:
    def test_four_lanes_equal_the_reference_byte_for_byte(self, tmp_path):
        runs = {}
        for pkg in PACKAGES:
            (tmp_path / pkg).mkdir()
            runs[pkg] = lane_drive(pkg, tmp_path / pkg)
        ref, port = runs["yoda_tpu"], runs["yoda_tpu_torch"]
        for key in ref:
            assert port[key] == ref[key], key
        # The drive covers what it claims to.
        assert ref["routes"]["huge-0"] == "global"
        assert {r for r in ref["routes"].values()} >= {"global", "s0", "s1"}
        assert ref["conflicts"] > 0, "no commit conflict was forced"
        assert ref["gang_rollbacks"] >= 2, "the pc gang was not rolled back whole"
        assert ref["resize"]["resized"] and ref["resize"]["shards"] == 2
        assert len(ref["bound"]) == sum(1 for _ in ref["routes"])
        assert not ref["staged"]
        assert all(used <= cap for used, cap in ref["caps"].values())
        sizes = {"ta": 4, "tb": 4, "pa": 4, "huge": 6, "tc": 4, "pb": 2, "pc": 2}
        for tag, size in sizes.items():
            assert sum(1 for n, _ in ref["bound"] if n.startswith(tag + "-")) == size
        assert ref["journal"] and all(ref["journal"].values())


class TestRunO:
    """chip_smoke's run (o) at its small size on the CPU: (o1), (o3) and
    (o4) hold their own gates, and (o2)'s threaded lanes on the wall clock
    hold theirs (every pod bound, gangs whole, no double bind, the claims
    exactly the bound pods), with the journal on and off and beside one
    plain stack."""

    def test_run_o_small_holds_its_checks(self):
        from chip_smoke import LANES_SMALL, check_lanes_run, check_lanes_wall, run_lanes

        run = run_lanes("cpu", LANES_SMALL)
        check_lanes_run(run, LANES_SMALL)
        for part in ("o2", "o2_single", "o2_nojournal"):
            check_lanes_wall(run[part], part)
        assert run["o3"]["residue"] and run["o3"]["warm"]
        assert run["o2"]["journal_summary"]["appends"] > 0
        assert run["o2_nojournal"]["journal_summary"] is None
        assert run["o1"]["lane_launches"]["global"] == {
            "fleet_eval": 0, "joint_fit": 0, "update_rows": 0}
