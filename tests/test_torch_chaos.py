"""The port's chaos harness and trace replayer
(``yoda_tpu_torch/testing/{chaos,tracegen}.py``) held against the JAX
package's on the CPU, for the same seeds, tolerance 0 (counts, names and
int32 decisions):

- ``generate(spec)`` gives equal ``TraceOp`` streams;
- ``ChaosPlan.seeded`` gives equal plans, and equal ``fired`` records
  when both are consumed alike;
- ``replay(spec, hosts=6)`` on ``kernel_platform: cpu`` gives an equal
  ``fingerprint()``;
- ``build_overload_storm`` / ``storm_stream`` give the same pods and the
  same ladder levels round by round (chip_smoke's run (q3)); the calm
  after the storm drains faster on the port, by its one repair of the
  ladder, and equal to the reference with that repair switched off;
- chip_smoke's run (q) at its small size (``CHAOS_SMALL``): the replay of
  run (q1)'s trace and (q2)'s shard crash mid-commit give equal
  fingerprints, SLO evaluations, binds, crash records and bindings.

Also: ``DriveWorker`` resolves its device before it spawns the port's
worker, with ``--device cpu`` when asked for the host.
"""

from __future__ import annotations

import dataclasses

import pytest
from chip_smoke import (
    CHAOS_FULL,
    CHAOS_PARITY,
    CHAOS_SMALL,
    STORM_ROUNDS,
    STORM_SEED,
    check_chaos_run,
    port_testing,
    replay_spec,
    run_chaos,
    run_storm,
)

import yoda_tpu.api.types as ref_types
import yoda_tpu.config as ref_config
import yoda_tpu.overload as ref_overload
import yoda_tpu.standalone as ref_standalone
from yoda_tpu.testing import chaos as ref_chaos
from yoda_tpu.testing import tracegen as ref_tracegen
from yoda_tpu_torch.testing import chaos as port_chaos
from yoda_tpu_torch.testing import tracegen as port_tracegen

SIDES = {
    "yoda_tpu": {"tracegen": ref_tracegen, "chaos": ref_chaos, "standalone": ref_standalone,
                 "config": ref_config, "types": ref_types, "overload": ref_overload},
    "yoda_tpu_torch": port_testing(),
}


def slo_spec(tg, seed: int):
    """``tests/test_slo.py``'s ``TestTraceReplayDeterminism`` trace."""
    return tg.TraceSpec(
        seed=seed,
        tenants=(tg.TenantMix("team-a", priority=5),
                 tg.TenantMix("team-b", gang_fraction=0.3, gang_sizes=(2,))),
        duration_s=90.0, base_rate_per_s=1.5, diurnal_amplitude=0.4,
        foreign_rate_per_s=30.0, failure_bursts=((45.0, 1),),
    )


def ops(tg, spec) -> list:
    return [vars(o) for o in tg.generate(spec)]


class TestGenerate:
    @pytest.mark.parametrize("seed", [0, 3, 7, 16])
    def test_streams_equal(self, seed):
        got = ops(port_tracegen, slo_spec(port_tracegen, seed))
        want = ops(ref_tracegen, slo_spec(ref_tracegen, seed))
        assert got == want and len(got) > 100

    @pytest.mark.parametrize("size", ["full", "small"])
    def test_run_q1_trace_equal(self, size):
        sz = CHAOS_FULL if size == "full" else CHAOS_SMALL
        got = ops(port_tracegen, replay_spec(port_tracegen, sz))
        want = ops(ref_tracegen, replay_spec(ref_tracegen, sz))
        assert got == want
        assert any(o["topology"] == "2x2x1" for o in got)
        assert any(o["foreign"] for o in got)


class TestChaosPlan:
    @pytest.mark.parametrize("seed", [1, 5, 23, 1337])
    def test_seeded_plans_and_fired_equal(self, seed):
        ops_ = ("bind", "dispatch", "crash", "journal", "rpc_partition")
        port = port_chaos.ChaosPlan.seeded(seed, ops=ops_, horizon=30, rate=0.3)
        ref = ref_chaos.ChaosPlan.seeded(seed, ops=ops_, horizon=30, rate=0.3)
        assert ([dataclasses.astuple(f) for f in port.faults]
                == [dataclasses.astuple(f) for f in ref.faults])
        for i in range(90):
            op = ops_[(i * 7 + seed) % len(ops_)]
            a, b = port.next(op), ref.next(op)
            assert (a is None) == (b is None)
        assert port.fired == ref.fired and port.fired


class TestReplay:
    @pytest.mark.parametrize("seed", [5, 7])
    def test_fingerprint_equal(self, seed):
        reports = {}
        for pkg, m in SIDES.items():
            tg = m["tracegen"]
            cfg = dataclasses.replace(tg._default_config(), kernel_platform="cpu")
            reports[pkg] = tg.replay(slo_spec(tg, seed), config=cfg, hosts=6)
        got, want = reports["yoda_tpu_torch"], reports["yoda_tpu"]
        assert got.fingerprint() == want.fingerprint()
        assert got.binds > 0 and len(got.killed_nodes) == 1


class TestStorm:
    def test_pods_equal(self):
        for r in range(8):
            got = port_chaos.storm_stream(STORM_SEED, r)
            want = ref_chaos.storm_stream(STORM_SEED, r)
            assert ([[(p.key, p.labels) for p in side] for side in got]
                    == [[(p.key, p.labels) for p in side] for side in want])

    def test_levels_round_by_round(self, monkeypatch):
        """With the port's one repair of the ladder switched off (draws the
        BROWNOUT cap parked re-enter at each evaluation; the reference
        waits for a cluster event, ``test_torch_overload.py``'s
        ``TestParkedQueueRepairs``), every level, the shed count and every
        pod's node are the reference's."""
        import yoda_tpu_torch.overload as port_overload

        real = port_overload.OverloadMonitor.evaluate

        def evaluate(self, *a, **kw):
            self._capped = False
            return real(self, *a, **kw)

        monkeypatch.setattr(port_overload.OverloadMonitor, "evaluate", evaluate)
        got = run_storm("cpu", SIDES["yoda_tpu_torch"])
        want = run_storm("cpu", SIDES["yoda_tpu"])
        for key in CHAOS_PARITY["q3"] + ("left", "violations"):
            assert got[key] == want[key], key
        assert got["peak"] == got["shed_level"] and got["shed_total"] > 0

    def test_storm_rounds_equal_with_the_repair(self):
        """As shipped, the storm's rounds climb alike and the port's calm
        drains no slower than the reference's."""
        got = run_storm("cpu", SIDES["yoda_tpu_torch"])
        want = run_storm("cpu", SIDES["yoda_tpu"])
        assert got["levels"][:STORM_ROUNDS] == want["levels"][:STORM_ROUNDS]
        assert got["storm_shed"] == want["storm_shed"] > 0
        assert got["calm_rounds"] <= want["calm_rounds"]
        assert got["left"] == want["left"] == 0 and not got["violations"]


class TestRunQ:
    """chip_smoke's run (q) at its small size on the CPU: (q1) and (q2) on
    both packages (TestStorm holds (q3))."""

    def test_equal_to_reference(self):
        parts = ("q1", "q2")
        got = run_chaos("cpu", CHAOS_SMALL, parts=parts)
        want = run_chaos("cpu", CHAOS_SMALL, mods=SIDES["yoda_tpu"], parts=parts)
        for run in (got, want):
            check_chaos_run(run, card=False)
        for part in parts:
            bad = [k for k in CHAOS_PARITY[part] if got[part][k] != want[part][k]]
            assert not bad, (part, bad)
        assert got["q1"]["devices"] == ["cpu"]
        assert got["q1"]["kernels"]["launches"] == {
            "fleet_eval": 0, "joint_fit": 0, "update_rows": 0}


class TestDriveWorkerDevice:
    def test_cpu_is_asked_for(self, tmp_path, monkeypatch):
        import subprocess

        seen = []

        class Popen:
            def __init__(self, args, **kw):
                seen.append(args)
                self.pid = 0

        monkeypatch.setattr(subprocess, "Popen", Popen)
        w = port_chaos.DriveWorker("sock", "s0", [], tmpdir=str(tmp_path), device="cpu")
        assert w.device == "cpu"
        assert seen[0][2:] == ["yoda_tpu_torch.framework.procserve", "--drive",
                               w.spec_path, "--device", "cpu"]
