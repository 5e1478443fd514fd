"""Per-tenant DRF fair queuing and quota admission
(``framework/tenancy.py`` and the tenant-aware ``SchedulingQueue``), held
against yoda_tpu.

Every case of ``tests/test_tenancy.py`` runs on both packages from the
reference's own source (``torch_refcases.run_case``), with its exact
assertions; none is left out. ``TestMultiTenantSoak`` keeps the
reference's ``slow`` mark, so it runs under ``-m slow`` only.

Beside them: the stack the shipped ConfigMap builds (2 ms ingest window,
tenant fairness; ``kernel_platform: cpu``) runs one stepped script with a
flooding tenant and two light ones through both packages, with fairness
on, off and under a chip quota: pop order, bind steps, per-step shares,
quota parks and queue depths, Events and bindings equal. And chip_smoke's
run (k) at its small size passes its own checks on the CPU.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import pytest
import yaml
from torch_refcases import PACKAGES, cases, run_case

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.types as ref_types
import yoda_tpu.config as ref_config
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent as port_agent
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.standalone as port_standalone

REF = "test_tenancy.py"
SKIP: "dict[str, str]" = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


# --- the shipped ConfigMap's stack, both packages, one stepped script ------

SIDES = {
    "yoda_tpu": (ref_standalone, ref_config, ref_agent, ref_types),
    "yoda_tpu_torch": (port_standalone, port_config, port_agent, port_types),
}
REPO = Path(__file__).resolve().parents[1]


def configmap() -> dict:
    docs = yaml.safe_load_all((REPO / "deploy/yoda-tpu-scheduler.yaml").read_text())
    (cm,) = [d for d in docs if d and d.get("kind") == "ConfigMap"]
    return yaml.safe_load(cm["data"]["config.yaml"])


class SteppedClock:
    def __init__(self) -> None:
        self.now = 5000.0

    def __call__(self) -> float:
        return self.now


def stepped_drive(pkg: str, *, fairness: bool = True, quota: int = 0) -> dict:
    """The ConfigMap's stack on the CPU (2 ms ingest window, tenant
    fairness) over 4 v5e hosts x 8 chips and 2 v5p 2x2x1 slices: a flood
    of 40 one-chip singletons, then two light tenants' 4 singletons and a
    gang of 2 x 4 chips each. Each step (1 s of the scheduling clock)
    republishes two hosts, deletes two bound flood pods and runs up to 6
    loop turns with the batcher flushed before each."""
    standalone, config, agent_mod, types = SIDES[pkg]
    cfg = dataclasses.replace(
        config.SchedulerConfig.from_dict(configmap()),
        kernel_platform="cpu", tenant_fairness=fairness, tenant_quota_chips=quota,
    )
    clock = SteppedClock()
    stack = standalone.build_stack(config=cfg, clock=clock)
    agent = agent_mod.FakeTpuAgent(stack.cluster)
    for h in range(4):
        agent.add_host(f"e{h}", generation="v5e", chips=8)
    for s in range(2):
        agent.add_slice(f"p{s}", generation="v5p", host_topology=(2, 2, 1))
    agent.publish_all()
    stack.ingestor.flush()
    hosts = sorted(t.name for t in stack.cluster.list_tpu_metrics())
    pod = types.PodSpec
    flood = [pod(f"f{i:02d}", namespace="flood", labels={"tpu/chips": "1"})
             for i in range(40)]
    light = []
    for t in ("team-a", "team-b"):
        light += [pod(f"{t}-s{i}", namespace=t, labels={"tpu/chips": str(1 + i % 4)})
                  for i in range(4)]
        light += [pod(f"{t}-g{m}", namespace=t, labels={
            "tpu/chips": "4", "tpu/gang": f"{t}-g", "tpu/gang-size": "2"})
            for m in range(2)]
    sched, queue = stack.scheduler, stack.queue
    pops, steps, bound_at = [], [], {}
    for step in range(30):
        for p in flood if step == 0 else light if step == 1 else ():
            stack.cluster.create_pod(p)
        if step > 1:
            for h in (hosts + hosts)[2 * step % len(hosts):][:2]:
                agent.refresh(h)
            for key in sorted(k for k in bound_at if k.startswith("flood/")
                              and stack.cluster.get_pod(k))[:2]:
                stack.cluster.delete_pod(key)
        for _turn in range(6):
            stack.ingestor.flush()
            qpi = queue.pop(timeout=0)
            if qpi is None:
                break
            for q in sched._pop_batch(qpi):
                pops.append(q.pod.key)
                sched.schedule_one(q)
        stack.ingestor.flush()
        for p in stack.cluster.list_pods():
            if p.node_name:
                bound_at.setdefault(p.key, clock.now)
        steps.append((
            stack.tenants.shares() if stack.tenants else {},
            stack.metrics.tenant_quota_parks.value(),
            queue.depths(),
        ))
        clock.now += 1.0
    assert stack.events.flush()
    out = {
        "pops": pops,
        "bound_at": bound_at,
        "steps": steps,
        "events": sorted(
            (e["reason"], e["involvedObject"]["name"], e["count"])
            for e in stack.cluster.list_events()
        ),
        "bindings": sorted((p.key, p.node_name) for p in stack.cluster.list_pods()),
        "ingest_in": stack.ingestor.events_in,
    }
    stack.ingestor.stop()
    stack.events.close()
    return out


class TestConfigMapStack:
    @pytest.mark.parametrize(
        "fairness,quota", [(True, 0), (False, 0), (True, 20)],
        ids=["fair", "fairness-off", "quota"],
    )
    def test_stepped_drive_equal(self, fairness, quota):
        ref = stepped_drive("yoda_tpu", fairness=fairness, quota=quota)
        port = stepped_drive("yoda_tpu_torch", fairness=fairness, quota=quota)
        assert port == ref
        light = [k for k in port["bound_at"] if k.startswith("team-")]
        assert len(light) == 12
        if quota:
            assert port["steps"][-1][1] > 0  # quota parks counted
        else:
            assert len(port["bound_at"]) == 52

    def test_fairness_gates_the_light_tenants_wait(self):
        def light_wait(run):
            return sorted(t for k, t in run["bound_at"].items() if k.startswith("team-"))

        fair = stepped_drive("yoda_tpu_torch")
        unfair = stepped_drive("yoda_tpu_torch", fairness=False)
        assert light_wait(fair)[-1] < light_wait(unfair)[-1]

    def test_chip_smoke_reads_the_configmap_as_yaml_does(self):
        from chip_smoke import CONFIGMAP_PATH, configmap_config

        assert configmap_config(str(REPO / CONFIGMAP_PATH)) == configmap()


class TestRunK:
    def test_small_run_k_passes_its_checks_on_the_cpu(self):
        """chip_smoke's run (k) at TENANCY_SMALL on the CPU, every part:
        the script's own checks hold (all pods bound, light tenants ahead
        of the flood and delayed with fairness off, quota parks that
        retire, one Scheduled Event per bind, no split gang), so the card's
        run (k) fails only on what the card changes."""
        from chip_smoke import TENANCY_SMALL, check_tenancy_run, run_tenancy

        run = run_tenancy("cpu", TENANCY_SMALL)
        check_tenancy_run(run, TENANCY_SMALL)
        for part in run.values():
            assert not any(part["launches"].values())
