"""The port's package rules and configuration, held against the JAX package:

- yoda_tpu_torch, chip_smoke.py and kernel_phases.py import neither JAX
  nor yoda_tpu;
- the same config dicts (the shipped ConfigMap included) are accepted or
  rejected alike, with equal effective weights;
- entry points run on the card unless asked for the CPU: "auto" raises
  without a GPU;
- knobs of parts the port lacks are refused by build_stack; gang pods,
  refused by the first slice, now schedule whole (tests/test_torch_gang.py
  holds the gang path against the JAX package).
"""

import ast
import dataclasses
import logging
from pathlib import Path

import pytest
import torch
import yaml

from yoda_tpu.config import SchedulerConfig as RefConfig
from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
from yoda_tpu_torch.config import SchedulerConfig
from yoda_tpu_torch.standalone import (
    UNPORTED_KNOB_VALUES,
    build_stack,
    unported_settings,
)

REPO = Path(__file__).resolve().parents[1]


def _imports(path: Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.append(node.module)
    return out


def _forbidden(module: str) -> bool:
    # Match the package exactly or as a prefix with a dot: yoda_tpu_torch
    # itself starts with "yoda_tpu".
    return any(
        module == bad or module.startswith(bad + ".")
        for bad in ("jax", "jaxlib", "yoda_tpu")
    )


class TestImportGuard:
    def test_port_imports_neither_jax_nor_reference(self):
        files = sorted((REPO / "yoda_tpu_torch").rglob("*.py"))
        files += [REPO / "chip_smoke.py", REPO / "kernel_phases.py"]
        assert len(files) > 20
        bad = {
            f"{f.relative_to(REPO)}: {m}"
            for f in files
            for m in _imports(f)
            if _forbidden(m)
        }
        assert not bad, sorted(bad)

    @pytest.mark.parametrize(
        "module,forbidden",
        [
            ("yoda_tpu", True),
            ("yoda_tpu.ops.kernel", True),
            ("jax.numpy", True),
            ("yoda_tpu_torch.ops.kernel", False),
            ("yoda_tpu_torchvision", False),
        ],
    )
    def test_guard_matches_packages_not_prefixes(self, module, forbidden):
        assert _forbidden(module) is forbidden


def _configmap() -> dict:
    docs = yaml.safe_load_all((REPO / "deploy/yoda-tpu-scheduler.yaml").read_text())
    (cm,) = [d for d in docs if d and d.get("kind") == "ConfigMap"]
    return yaml.safe_load(cm["data"]["config.yaml"])


CONFIG_CASES = [
    {},
    {"scoring_strategy": "most-allocated"},
    {"weights": {"hbm_free": 5, "clock": 0}, "batch_requests": 16},
    {"kernel_backend": "pallas", "batch_requests": 8},
    {"max_metrics_age_s": 60, "kernel_platform": "cpu"},
    {"slo_targets": {"admission_wait_p99_s": 30}},
    {"profiles": [{"scheduler_name": "b", "scoring_strategy": "most-allocated"}]},
    # Rejected alike:
    {"kernel_backend": "pallas", "kernel_platform": "cpu"},
    {"kernel_backend": "pallas", "mesh_devices": 4},
    {"kernel_backend": "mosaic"},
    {"kernel_platform": "gpu"},
    {"batch_requests": 0},
    {"batch_requests": 4, "mode": "loop"},
    {"weights": {"hbm_free": -1}},
    {"weights": {"bogus": 1}},
    {"scoring_strategy": "binpack"},
    {"mode": "stream"},
    {"slo_targets": {"admission_wait_slo": 1.5}},
]


class TestConfigParity:
    @pytest.mark.parametrize(
        "d",
        CONFIG_CASES + [_configmap()],
        ids=[f"case{i}" for i in range(len(CONFIG_CASES))] + ["configmap"],
    )
    def test_same_verdict_and_weights(self, d):
        try:
            want = RefConfig.from_dict(d)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                SchedulerConfig.from_dict(d)
            # The same knob is blamed (message texts may name the port's
            # own device).
            assert str(got.value).split()[0] == str(e).split()[0]
            return
        got = SchedulerConfig.from_dict(d)
        assert dataclasses.asdict(got.effective_weights()) == dataclasses.asdict(
            want.effective_weights()
        )
        assert [f.name for f in dataclasses.fields(got)] == [
            f.name for f in dataclasses.fields(want)
        ]

    def test_configmap_parses_and_names_what_is_not_ported(self):
        # The shipped ConfigMap turns on batched ingest and tenant fairness,
        # which this port does not have yet: it loads, and build_stack
        # names exactly those two knobs.
        cfg = SchedulerConfig.from_dict(_configmap())
        assert sorted(s.split("=")[0] for s in unported_settings(cfg)) == [
            "ingest_batch_window_ms",
            "tenant_fairness",
        ]


class TestDevicePolicy:
    @pytest.mark.parametrize("platform", ["auto", "device"])
    def test_card_platforms_raise_without_gpu(self, platform, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA device"):
            build_stack(config=SchedulerConfig(kernel_platform=platform))

    def test_pallas_backend_needs_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA device"):
            build_stack(config=SchedulerConfig(kernel_backend="pallas"))

    def test_cpu_is_asked_for(self):
        stack = build_stack(config=SchedulerConfig(kernel_platform="cpu"))
        assert stack.batch.device == torch.device("cpu")


class TestUnportedKnobs:
    @pytest.mark.parametrize(
        "knob,value",
        [
            ("mode", "loop"),
            ("mesh_devices", 2),
            ("kernel_device_min_elems", 1024),
            ("shard_count", 2),
            ("journal_path", "/var/lib/yoda"),
            ("tenant_fairness", True),
            ("ingest_batch_window_ms", 5.0),
            ("bind_pipeline", "on"),
            ("percentage_nodes_to_score", 50),
        ],
    )
    def test_raises_naming_the_knob(self, knob, value):
        cfg = dataclasses.replace(
            SchedulerConfig(kernel_platform="cpu"), **{knob: value}
        )
        with pytest.raises(NotImplementedError, match=knob):
            build_stack(config=cfg)

    @pytest.mark.parametrize(
        "knob,value",
        [
            ("enable_preemption", False),
            ("spec_enabled", False),
            ("bind_workers", 0),
            ("trace_sample_rate", 0.0),
            ("node_health_period_s", 0),
            ("slo_enabled", False),
            ("overload_period_s", 0),
        ],
    )
    def test_switching_an_absent_part_off_is_accepted(self, knob, value):
        cfg = dataclasses.replace(
            SchedulerConfig(kernel_platform="cpu"), **{knob: value}
        )
        assert unported_settings(cfg) == []
        build_stack(config=cfg)


class TestNotBuilt:
    """The parts yoda_tpu builds by default and this port does not: named
    once in a warning and listed on the stack, never silently absent."""

    def test_defaults_are_named(self, caplog):
        with caplog.at_level(logging.WARNING, logger="yoda_tpu_torch.standalone"):
            stack = build_stack(config=SchedulerConfig(kernel_platform="cpu"))
        knobs = sorted(part.split("(")[1].split("=")[0] for part in stack.not_built)
        assert knobs == sorted(UNPORTED_KNOB_VALUES)
        # The background parts are ported: built, and never named.
        for part in ("speculative placement cache", "reconciler", "rebalancer"):
            assert not [p for p in stack.not_built if p.startswith(part)]
        # So are the node health monitor, node repair and the bind
        # executor: built by default and absent from not_built.
        assert stack.nodehealth is not None and stack.nodehealth.repair
        assert stack.bind_executor is not None and stack.bind_executor.workers == 8
        for part in ("node health monitor", "node repair", "bind executor"):
            assert not [p for p in stack.not_built if p.startswith(part)]
        assert sorted(p.split(" (")[0] for p in stack.not_built) == [
            "SLO engine", "bind pipeline", "overload controller", "tracing",
        ]
        warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
        assert len(warnings) == 1
        assert all(part in warnings[0].getMessage() for part in stack.not_built)

    def test_switched_off_parts_are_not_named(self, caplog):
        off = {knob: values[0] for knob, (_part, values) in UNPORTED_KNOB_VALUES.items()}
        cfg = dataclasses.replace(SchedulerConfig(kernel_platform="cpu"), **off)
        with caplog.at_level(logging.WARNING, logger="yoda_tpu_torch.standalone"):
            stack = build_stack(config=cfg)
        assert stack.not_built == ()
        assert not [r for r in caplog.records if r.levelno == logging.WARNING]


class TestBackgroundParts:
    """The reconciler, the rebalancer, the speculative placement cache, the
    node health monitor and the bind executor are built by default, wired
    as the reference wires them, and their knobs are honoured at every
    valid value."""

    def test_built_and_wired(self):
        stack = build_stack(config=SchedulerConfig(kernel_platform="cpu"))
        assert stack.reconciler is not None and stack.rebalancer is not None
        assert stack.scheduler.speculation is stack.speculation
        assert stack.rebalancer.speculator is stack.speculation
        assert stack.speculation.device == stack.batch.device
        assert stack.speculation.enabled
        # The drain pass reads the node health monitor's draining nodes.
        assert stack.rebalancer.draining_fn == stack.nodehealth.draining_nodes
        assert stack.informer.fence_fn == stack.nodehealth.fenced_nodes
        assert not stack.rebalancer.gate_fn()  # until the first resync
        assert not stack.nodehealth.gate_fn()

    @pytest.mark.parametrize(
        "knob,value,attr",
        [
            ("spec_enabled", False, ("speculation", "enabled")),
            ("spec_cache_size", 4, ("speculation", "size")),
            ("spec_shapes_max", 8, ("speculation", "shapes_max")),
            ("rebalance_min_gain", 0.2, ("rebalancer", "min_gain")),
            ("rebalance_max_moves", 3, ("rebalancer", "max_moves")),
            ("rebalance_max_victims", 2, ("rebalancer", "max_victims")),
            ("rebalance_preemption", False, ("rebalancer", "enable_preemption")),
            ("rebalance_elastic", False, ("rebalancer", "enable_elastic")),
            ("failover_adopt_window_s", 0, ("reconciler", "adopt_window_s")),
            ("reconcile_period_s", 0, None),
            ("reconcile_period_s", 5.0, None),
            ("rebalance_period_s", 0, None),
            ("rebalance_period_s", 10.0, None),
            ("bind_workers", 3, ("bind_executor", "workers")),
            ("bind_workers", 0, ("bind_executor", None)),
            ("node_suspect_after_s", 5.0, ("nodehealth", "suspect_after_s")),
            ("node_down_after_s", 90.0, ("nodehealth", "down_after_s")),
            ("node_drain_deadline_s", 10.0, ("nodehealth", "drain_deadline_s")),
            ("node_repair", False, ("nodehealth", "repair")),
            ("node_health_period_s", 0, None),
            ("node_health_period_s", 2.0, None),
        ],
    )
    def test_knob_honoured(self, knob, value, attr):
        cfg = dataclasses.replace(
            SchedulerConfig(kernel_platform="cpu"), **{knob: value}
        )
        assert unported_settings(cfg) == []
        stack = build_stack(config=cfg)
        if attr is not None:
            part, name = attr
            obj = getattr(stack, part)
            assert (obj is None) if name is None else getattr(obj, name) == value
        assert not [p for p in stack.not_built if knob in p]

    @pytest.mark.parametrize(
        "module",
        [
            "framework/speculation.py", "framework/reconciler.py",
            "rebalance/__init__.py", "rebalance/score.py", "rebalance/rebalancer.py",
            "nodehealth/__init__.py", "nodehealth/monitor.py",
        ],
    )
    def test_background_modules_are_guarded(self, module):
        path = REPO / "yoda_tpu_torch" / module
        assert path in set((REPO / "yoda_tpu_torch").rglob("*.py"))
        assert not [m for m in _imports(path) if _forbidden(m)]


class TestPreemptionKnob:
    """Preemption is ported: on by default as in the reference, off when
    asked, and never named as an unported setting."""

    def test_on_by_default(self):
        stack = build_stack(config=SchedulerConfig(kernel_platform="cpu"))
        assert stack.preemption is not None
        assert stack.preemption in stack.framework.post_filter_plugins
        # Victim selection shares the scheduler's cycle lock.
        assert stack.preemption.select_lock is stack.scheduler.cycle_lock

    def test_off_when_asked(self):
        stack = build_stack(
            config=SchedulerConfig(kernel_platform="cpu", enable_preemption=False)
        )
        assert stack.preemption is None
        assert stack.framework.post_filter_plugins == []

    @pytest.mark.parametrize("value", [True, False])
    def test_never_unported(self, value):
        cfg = SchedulerConfig(kernel_platform="cpu", enable_preemption=value)
        assert not [s for s in unported_settings(cfg) if "preemption" in s]


class TestGangPodsRefused:
    """The first slice refused every gang pod as not ported; the gang path
    is ported now, so the same four cases assert the new behaviour: a
    complete gang of each label kind binds whole, and a lone member parks
    with its gang's own message."""

    @pytest.mark.parametrize(
        "labels,size,slices",
        [
            ({"tpu/gang": "g1", "tpu/gang-size": "2", "tpu/chips": "4"}, 2, 0),
            ({"tpu/gang": "g2", "tpu/topology": "2x2x1", "tpu/chips": "4"}, 4, 1),
            ({"pod-group.scheduling.sigs.k8s.io/name": "pg",
              "pod-group.scheduling.sigs.k8s.io/min-available": "2"}, 2, 0),
            ({"tpu/gang": "g3", "tpu/topology": "2x2x1", "tpu/multislice": "2",
              "tpu/chips": "4"}, 8, 2),
        ],
        ids=["gang", "topology", "coscheduling", "multislice"],
    )
    def test_not_yet_ported_status(self, labels, size, slices):
        stack = build_stack(config=SchedulerConfig(kernel_platform="cpu"))
        agent = FakeTpuAgent(stack.cluster)
        for h in range(4):
            agent.add_host(f"h{h}", generation="v5p")
        for s in range(slices):
            agent.add_slice(f"s{s}", generation="v5p", host_topology=(2, 2, 1))
        agent.publish_all()
        for i in range(size):
            stack.cluster.create_pod(PodSpec(f"member-{i}", labels=dict(labels)))
        stack.scheduler.run_until_idle(max_wall_s=5)
        nodes = [stack.cluster.get_pod(f"default/member-{i}").node_name for i in range(size)]
        assert all(nodes), nodes
        if slices:  # one member per host of the planned block(s)
            assert len(set(nodes)) == size
            assert all(n.startswith("s") for n in nodes)
        assert all(r.outcome in ("waiting", "bound") for r in stack.scheduler.stats.results)
        assert not any("not yet ported" in r.message for r in stack.scheduler.stats.results)
        assert stack.queue.depths() == (0, 0, 0)
        assert stack.batch.dispatch_count == 1  # one gang-fused evaluation

    def test_status_code_is_unresolvable(self):
        """A lone member of a 2-member gang is not refused as unported: it
        reserves and parks at the Permit barrier with its gang's message,
        and a gang the fleet cannot admit parks at admission with the
        gang's own reason."""
        stack = build_stack(config=SchedulerConfig(kernel_platform="cpu"))
        agent = FakeTpuAgent(stack.cluster)
        agent.add_host("h0", generation="v5p")
        agent.publish_all()
        stack.cluster.create_pod(
            PodSpec("m", labels={"tpu/gang": "g", "tpu/gang-size": "2"})
        )
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        (result,) = stack.scheduler.stats.results
        assert result.outcome == "waiting"
        (waiter,) = stack.framework.waiting_pods()
        assert waiter.pod.name == "m"
        assert stack.gang.gang_status("g") == (2, 1, 0)
        stack.cluster.create_pod(
            PodSpec("big", labels={"tpu/gang": "b", "tpu/gang-size": "3",
                                   "tpu/chips": "4"})
        )
        stack.scheduler.run_until_idle(max_wall_s=0.2)
        parked = [r for r in stack.scheduler.stats.results if r.pod_key == "default/big"]
        assert parked[0].outcome == "unschedulable"
        assert parked[0].message.startswith("gang b: 3 members still need placement")
        assert "not yet ported" not in parked[0].message
