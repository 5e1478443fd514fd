"""The fleet SLO engine, held against yoda_tpu.

Every case of ``tests/test_slo.py`` runs on both packages from the
reference's own source (``torch_refcases.run_case``), with its fake
clocks and exact assertions; none is left out.
``TestTraceReplayDeterminism`` drives each package's own
``testing.tracegen`` (its replay on the host, as the harness maps the
port's "auto").
"""

from __future__ import annotations

import json
import urllib.request

import pytest
from torch_refcases import PACKAGES, cases, run_case

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.types as ref_types
import yoda_tpu.config as ref_config
import yoda_tpu.metrics_server as ref_server
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent as port_agent
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.metrics_server as port_server
import yoda_tpu_torch.standalone as port_standalone

REF = "test_slo.py"
SKIP: dict = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


SIDES = {
    "yoda_tpu": (ref_standalone, ref_config, ref_agent, ref_types, ref_server),
    "yoda_tpu_torch": (
        port_standalone, port_config, port_agent, port_types, port_server,
    ),
}


class SteppedClock:
    def __init__(self) -> None:
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


def _drive(pkg):
    """One script on one package, on a stepped scheduling clock: pods of
    two namespaces bind at different times, one never fits, one gang
    binds through the Permit release."""
    standalone, config, agent_mod, types, _server = SIDES[pkg]
    clock = SteppedClock()
    stack = standalone.build_stack(
        config=config.SchedulerConfig(kernel_platform="cpu"), clock=clock
    )
    agent = agent_mod.FakeTpuAgent(stack.cluster)
    for i in range(3):
        agent.add_host(f"h{i}", generation="v5e", chips=4)
    agent.publish_all()
    pod = types.PodSpec
    for i in range(3):
        stack.cluster.create_pod(
            pod(f"a{i}", namespace="team-a", labels={"tpu/chips": "1"})
        )
    clock.now += 7.0
    stack.scheduler.run_until_idle(max_wall_s=10)
    stack.cluster.create_pod(
        pod("big", namespace="team-b", labels={"tpu/chips": "64"})
    )
    for m in range(2):
        stack.cluster.create_pod(
            pod(
                f"g-{m}", namespace="team-b",
                labels={"tpu/gang": "g", "tpu/gang-size": "2", "tpu/chips": "4"},
            )
        )
    clock.now += 30.0
    stack.scheduler.run_until_idle(max_wall_s=10)
    clock.now += 90.0
    return stack, clock


class TestPendingSide:
    def test_tenant_blind_pending_and_evaluation_equal(self):
        """With fairness off both queues bill every entry to tenant "":
        the pending side, the starvation windows and the whole
        evaluation agree at tolerance 0 on a stepped clock."""
        got = {}
        for pkg in PACKAGES:
            stack, clock = _drive(pkg)
            stats = stack.queue.tenant_wait_stats()
            out = stack.metrics.slo.evaluate(now=clock.now)
            got[pkg] = (stats, out)
        assert got["yoda_tpu"] == got["yoda_tpu_torch"]
        stats, out = got["yoda_tpu_torch"]
        assert stats == {"": (1, 107.0)}
        assert out["tenants"]["team-a"]["admissions_total"] == 3
        assert out["tenants"]["team-b"]["admissions_total"] == 2
        assert out["tenants"][""]["pending"] == 1


class TestDebugSloHttp:
    def test_endpoint_equal_on_both(self):
        """``GET /debug/slo`` serves a FRESH evaluation, the same JSON on
        both packages for the same script and clock."""
        got = {}
        for pkg in PACKAGES:
            stack, clock = _drive(pkg)
            server = SIDES[pkg][4].MetricsServer(
                stack.metrics, host="127.0.0.1", port=0
            )
            server.start()
            try:
                got[pkg] = json.loads(
                    urllib.request.urlopen(
                        f"http://127.0.0.1:{server.port}/debug/slo"
                    ).read()
                )
            finally:
                server.stop()
        assert got["yoda_tpu"] == got["yoda_tpu_torch"]
        assert got["yoda_tpu"]["enabled"] is True
        assert "targets" in got["yoda_tpu"] and "fleet" in got["yoda_tpu"]
