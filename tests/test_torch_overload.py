"""The overload brownout ladder and config hot reload, held against
yoda_tpu.

Every case of ``tests/test_overload.py`` that needs no unported part runs
on both packages from the reference's own source
(``torch_refcases.run_case``), with its stepped ``ReplayClock`` and exact
assertions (``TestConfigReloader::test_end_to_end_from_yaml_file``
loads through the port CLI's ``_load_config``); none is left out.
``TestOverloadStormSweep``, the seeded chaos storm, builds each package's
own stack through its own ``testing.chaos`` and keeps the reference's
``slow`` mark.
``TestReloadEqual`` below drives a reload from a candidate config through
both packages' ``apply_reloadable``. ``TestParkedQueueRepairs`` shows the
port's two repairs of a loop left with every draw parked: the reference
stays stuck where the port goes on.
"""

from __future__ import annotations

import dataclasses

import pytest
from torch_refcases import PACKAGES, cases, run_case

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.types as ref_types
import yoda_tpu.config as ref_config
import yoda_tpu.observability as ref_observability
import yoda_tpu.overload as ref_overload
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent as port_agent
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.observability as port_observability
import yoda_tpu_torch.overload as port_overload
import yoda_tpu_torch.standalone as port_standalone

REF = "test_overload.py"
SKIP: dict = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


SIDES = {
    "yoda_tpu": (ref_standalone, ref_config, ref_agent, ref_types, ref_overload),
    "yoda_tpu_torch": (
        port_standalone, port_config, port_agent, port_types, port_overload,
    ),
}


class SteppedClock:
    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


def _ladder_script(pkg):
    """Climb the ladder from queue depth, with pods on both sides of the
    shed priority floor and one spot gang already half in flight, then
    step down; returns what each step shows."""
    standalone, config, agent_mod, types, _ov = SIDES[pkg]
    clock = SteppedClock()
    cfg = config.SchedulerConfig(
        kernel_platform="cpu", overload_queue_high=4,
        overload_cycle_ms_high=0, overload_step_down_hold_s=5.0,
        overload_brownout_admit_per_s=2.0, bind_workers=0,
    )
    stack = standalone.build_stack(config=cfg, clock=clock)
    agent = agent_mod.FakeTpuAgent(stack.cluster)
    for i in range(4):
        agent.add_host(f"h{i}", generation="v5e", chips=8)
    agent.publish_all()
    pod = types.PodSpec
    ov = stack.metrics.overload
    m = stack.metrics
    log = []

    def step(tag):
        log.append((
            tag, ov.level, ov.transitions, ov.shed_total,
            stack.queue.shed_parks, stack.queue.quota_parks,
            m.tracer.sample_rate, stack.rebalancer.gate_fn(),
            stack.nodehealth.gate_fn(), stack.queue.overload_depth(),
            sorted(p.name for p in stack.cluster.list_pods() if p.node_name),
            m.pending.summary()["by_kind"],
        ))

    stack.reconciler.resync()
    step("start")
    # One member of a spot gang is Permit-parked before the flood.
    gl = {"tpu/gang": "sg", "tpu/gang-size": "2", "tpu/chips": "2",
          "tpu/priority": "0"}
    stack.cluster.create_pod(pod("sg-0", namespace="spot", labels=dict(gl)))
    stack.scheduler.run_until_idle(max_wall_s=0.2)
    for i in range(20):
        stack.cluster.create_pod(pod(
            f"spot-{i}", namespace="spot",
            labels={"tpu/chips": "1", "tpu/priority": "0"},
        ))
    for lvl in range(3):
        clock.now += 1.0
        ov.evaluate()
        step(f"climb{lvl}")
    stack.cluster.create_pod(pod("sg-1", namespace="spot", labels=dict(gl)))
    stack.cluster.create_pod(pod(
        "prod-0", namespace="prod",
        labels={"tpu/chips": "2", "tpu/priority": "10"},
    ))
    # Every later drain runs to its end (no Permit waiter is left once
    # sg-1 binds), whatever the machine's speed.
    stack.scheduler.run_until_idle(max_wall_s=60)
    step("shed")
    for _ in range(8):
        clock.now += 10.0
        ov.evaluate()
        stack.scheduler.run_until_idle(max_wall_s=60)
        step("down")
    return log


class TestLadderEqual:
    def test_ladder_script_equal_on_both(self):
        """NOMINAL -> ELEVATED -> BROWNOUT -> SHED and back down on a
        stepped clock from queue depth alone: levels, transitions, shed
        and quota parks, the feature pause (tracing 0, both repair gates
        shut) and its restore, bindings and why-pending kinds equal."""
        got = {pkg: _ladder_script(pkg) for pkg in PACKAGES}
        assert got["yoda_tpu"] == got["yoda_tpu_torch"]
        log = got["yoda_tpu_torch"]
        levels = [row[1] for row in log]
        assert levels[:4] == ["NOMINAL", "ELEVATED", "BROWNOUT", "SHED"]
        assert levels[-1] == "NOMINAL"
        shed_row = log[4]
        assert shed_row[6] == 0.0 and not shed_row[7] and not shed_row[8]
        assert "prod-0" in shed_row[10]
        assert {"sg-0", "sg-1"} <= set(shed_row[10])  # mid-flight gang admitted
        assert shed_row[3] > 0
        # BROWNOUT on the way down admits brownout_admit_per_s (2) of the
        # requeued spot pods and quota-parks the rest.
        brown = next(row for row in log[5:] if row[1] == "BROWNOUT")
        assert len(brown[10]) == len(shed_row[10]) + 2
        assert brown[5] == 18 and brown[11] == {"quota-park": 18}
        final = log[-1]
        assert final[6] == 1.0 and final[7] and final[8]
        assert len(final[10]) == 23


def _reload(pkg, candidate_changes):
    standalone, config, _agent, _types, ov_mod = SIDES[pkg]
    base = config.SchedulerConfig(kernel_platform="cpu")
    stack = standalone.build_stack(config=base)
    live = ov_mod.LiveConfig(base)
    candidate = dataclasses.replace(base, **candidate_changes)
    reloader = ov_mod.ConfigReloader(
        lambda: candidate, live,
        lambda cfg: standalone.apply_reloadable([stack], cfg),
    )
    report = reloader.reload()
    m = stack.metrics
    live_values = (
        m.tracer.sample_rate, stack.speculation.size,
        stack.rebalancer.max_moves, m.overload.queue_high,
        live.current.trace_sample_rate,
        live.current.scheduler_name, live.generation,
    )
    return report, live_values


class TestReloadEqual:
    def test_reload_report_and_live_values_equal(self):
        """A reload changing reloadable knobs (trace sampling, the
        speculative cache's size, the rebalancer's move budget, an
        overload threshold) and an immutable one (the kernel backend):
        the same report and the same live values on both packages."""
        changes = dict(
            trace_sample_rate=0.5, spec_cache_size=4, rebalance_max_moves=3,
            overload_queue_high=77, scheduler_name="other-scheduler",
        )
        got = {pkg: _reload(pkg, changes) for pkg in PACKAGES}
        assert got["yoda_tpu"] == got["yoda_tpu_torch"]
        report, live = got["yoda_tpu_torch"]
        assert report["applied"] == [
            "overload_queue_high", "rebalance_max_moves", "spec_cache_size",
            "trace_sample_rate",
        ]
        assert report["immutable"] == ["scheduler_name"]
        assert live[:4] == (0.5, 4, 3, 77)


class TestParkedQueueRepairs:
    """A loop whose every draw is parked and no bind is in flight runs no
    cycle and sees no cluster event. The reference then waits for good:
    its cycle signal keeps the p99 of cycles long past, and BROWNOUT's
    capped draws wait for an event. The port reads the cycle signal only
    over new cycles and re-admits capped draws at each evaluation."""

    def _monitor(self, pkg):
        ov_mod = SIDES[pkg][4]
        obs = {"yoda_tpu": ref_observability, "yoda_tpu_torch": port_observability}[pkg]
        clock = SteppedClock()
        mon = ov_mod.OverloadMonitor(clock=clock, cycle_ms_high=250.0, step_down_hold_s=5.0)
        latency = obs.Histogram("cycle_seconds", "serve-cycle wall")
        mon.attach(latency=latency)
        return mon, latency, clock

    def test_cycle_signal_reads_only_new_cycles(self):
        levels = {}
        for pkg in PACKAGES:
            mon, latency, clock = self._monitor(pkg)
            latency.observe(0.6, phase="total")  # one slow cycle: pressure 2.4
            seen = []
            for _ in range(6):
                clock.now += 6.0
                seen.append(mon.evaluate())
            levels[pkg] = seen
            if pkg == "yoda_tpu_torch":
                assert mon.pressure()["cycle"] == 0.0
                latency.observe(0.6, phase="total")
                assert mon.pressure()["cycle"] == pytest.approx(2.4)
                assert mon.evaluate() == "ELEVATED"
        assert levels["yoda_tpu"] == ["ELEVATED"] + ["BROWNOUT"] * 5
        assert levels["yoda_tpu_torch"] == ["ELEVATED", "ELEVATED", "NOMINAL"] + [
            "NOMINAL"] * 3

    def test_capped_draws_reenter_without_an_event(self):
        bound = {}
        for pkg in PACKAGES:
            standalone, config, agent_mod, types, ov_mod = SIDES[pkg]
            clock = SteppedClock()
            cfg = config.SchedulerConfig(
                kernel_platform="cpu", overload_queue_high=0, overload_cycle_ms_high=0,
                overload_step_down_hold_s=1e9, overload_brownout_admit_per_s=2.0,
                bind_workers=0,
            )
            stack = standalone.build_stack(config=cfg, clock=clock)
            agent = agent_mod.FakeTpuAgent(stack.cluster)
            for i in range(4):
                agent.add_host(f"h{i}", generation="v5e", chips=8)
            agent.publish_all()
            stack.reconciler.resync()
            ov = stack.metrics.overload
            ov._transition_locked(ov_mod.ELEVATED)
            ov._transition_locked(ov_mod.BROWNOUT)

            def create(names):
                for n in names:
                    stack.cluster.create_pod(types.PodSpec(n, labels={"tpu/chips": "1"}))
                stack.scheduler.run_until_idle(max_wall_s=60)

            def n_bound():
                return sum(1 for p in stack.cluster.list_pods() if p.node_name)

            create(["a0", "a1"])  # the burst's two tokens
            create([f"b{i}" for i in range(6)])  # no token left: all park
            seen = [n_bound(), stack.queue.depths()[2]]
            for _ in range(4):
                clock.now += 1.0
                ov.evaluate()
                stack.scheduler.run_until_idle(max_wall_s=60)
                seen.append(n_bound())
            bound[pkg] = seen
        # The reference leaves the six parked however long the cap holds.
        assert bound["yoda_tpu"] == [2, 6, 2, 2, 2, 2]
        # The port admits them at the cap's rate, two a second.
        assert bound["yoda_tpu_torch"] == [2, 6, 4, 6, 8, 8]
