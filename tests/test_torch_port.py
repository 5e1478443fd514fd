"""The port's package rules and configuration, held against the JAX package:

- yoda_tpu_torch, chip_smoke.py and kernel_phases.py import neither JAX
  nor yoda_tpu;
- the same config dicts (the shipped ConfigMap included) are accepted or
  rejected alike, with equal effective weights;
- entry points run on the card unless asked for the CPU: "auto" raises
  without a GPU;
- knobs of parts the port lacks are refused by build_stack, and pods that
  need them (gangs) are refused with an explicit status.
"""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch
import yaml

from yoda_tpu.config import SchedulerConfig as RefConfig
from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
from yoda_tpu_torch.config import SchedulerConfig
from yoda_tpu_torch.framework.interfaces import Code
from yoda_tpu_torch.standalone import build_stack, unported_settings

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
        ],
    )
    def test_switching_an_absent_part_off_is_accepted(self, knob, value):
        cfg = dataclasses.replace(
            SchedulerConfig(kernel_platform="cpu"), **{knob: value}
        )
        assert unported_settings(cfg) == []
        build_stack(config=cfg)


class TestGangPodsRefused:
    @pytest.mark.parametrize(
        "labels",
        [
            {"tpu/gang": "g1", "tpu/gang-size": "2", "tpu/chips": "4"},
            {"tpu/gang": "g2", "tpu/topology": "2x2x1"},
            {"pod-group.scheduling.sigs.k8s.io/name": "pg",
             "pod-group.scheduling.sigs.k8s.io/min-available": "2"},
        ],
        ids=["gang", "topology", "coscheduling"],
    )
    def test_not_yet_ported_status(self, labels):
        stack = build_stack(config=SchedulerConfig(kernel_platform="cpu"))
        agent = FakeTpuAgent(stack.cluster)
        for h in range(4):
            agent.add_host(f"h{h}", generation="v5p")
        agent.publish_all()
        stack.cluster.create_pod(PodSpec("member", labels=labels))
        stack.scheduler.run_until_idle(max_wall_s=5)
        assert stack.cluster.get_pod("default/member").node_name is None
        (result,) = stack.scheduler.stats.results
        assert result.outcome == "unschedulable"
        assert "gang scheduling is not yet ported" in result.message
        assert stack.queue.depths() == (0, 0, 1)  # parked unresolvable
        assert stack.batch.dispatch_count == 0

    def test_status_code_is_unresolvable(self):
        from yoda_tpu_torch.framework.cyclestate import CycleState
        from yoda_tpu_torch.framework.interfaces import Snapshot
        from yoda_tpu_torch.plugins.yoda.filter_plugin import YodaPreFilter

        pod = PodSpec("m", labels={"tpu/gang": "g", "tpu/gang-size": "2"})
        st = YodaPreFilter().pre_filter(CycleState(), pod, Snapshot({}))
        assert st.code == Code.UNSCHEDULABLE_AND_UNRESOLVABLE
