"""The port's package rules and configuration, held against the JAX package:

- yoda_tpu_torch, chip_smoke.py and kernel_phases.py import neither JAX
  nor yoda_tpu;
- the same config dicts (the shipped ConfigMap included) are accepted or
  rejected alike, with equal effective weights;
- entry points run on the card unless asked for the CPU: "auto" raises
  without a GPU;
- knobs of parts the port lacks are refused by build_stack, and the
  shipped ConfigMap sets none of them; gang pods,
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
from yoda_tpu_torch.cluster.fake import FakeCluster
from yoda_tpu_torch.standalone import (
    UNPORTED_KNOB_VALUES,
    build_proc_parent,
    build_profile_stacks,
    build_sharded_stacks,
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
        # The process slice's modules are among them.
        for rel in ("cli.py", "demo.py", "cluster/kube.py", "cluster/lease.py",
                    "testing/__init__.py", "testing/fake_kube_api.py",
                    "parallel/__init__.py", "parallel/sharded.py",
                    "plugins/yoda/collection.py", "plugins/yoda/score.py",
                    "journal/__init__.py", "journal/journal.py",
                    "journal/tail.py", "framework/shards.py",
                    "framework/procserve.py", "testing/chaos.py",
                    "testing/tracegen.py", "federation/__init__.py",
                    "federation/federation.py", "federation/health.py",
                    "agent/native.py", "agent/runtime.py",
                    "agent/tpu_metrics.py", "testing/fake_libtpu.py"):
            assert REPO / "yoda_tpu_torch" / rel in files, rel
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

    def test_configmap_is_ported_and_builds_a_stack(self):
        # The shipped ConfigMap turns on batched ingest and tenant fairness:
        # every knob it sets is ported, and build_stack builds the stack it
        # describes (on the CPU here), leaving nothing out.
        cfg = SchedulerConfig.from_dict(_configmap())
        assert unported_settings(cfg) == []
        stack = build_stack(config=dataclasses.replace(cfg, kernel_platform="cpu"))
        try:
            assert stack.ingestor is not None and stack.tenants is not None
            assert stack.events is not None
            assert stack.ingestor.window_s == cfg.ingest_batch_window_ms / 1000.0
            assert stack.ingestor.batch_max == cfg.ingest_batch_max
            assert stack.not_built == ()
        finally:
            stack.close()


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


class TestHostPool:
    """A process evaluating on the host bounds torch's intra-op pool (the
    six-process collapse of ROADMAP queue 3's F4); the card's kernels
    leave it alone, and a wider pool is never lowered further than asked
    nor raised."""

    @pytest.fixture(autouse=True)
    def _restore_pool(self):
        before = torch.get_num_threads()
        yield
        torch.set_num_threads(before)

    @pytest.mark.parametrize("cores,lanes,want", [(8, 1, 2), (8, 4, 2), (8, 5, 1),
                                                  (1, 1, 1), (64, 16, 2)])
    def test_threads_from_cores_and_lanes(self, cores, lanes, want, monkeypatch):
        import os

        from yoda_tpu_torch.ops import kernel

        monkeypatch.setattr(os, "cpu_count", lambda: cores)
        assert kernel.host_threads(lanes) == want

    def test_host_kernel_bounds_the_card_kernel_does_not(self, monkeypatch):
        import os

        from yoda_tpu_torch.config import Weights
        from yoda_tpu_torch.ops.kernel import DeviceFleetKernel, TorchFleetKernel

        monkeypatch.setattr(os, "cpu_count", lambda: 8)
        torch.set_num_threads(6)
        TorchFleetKernel(Weights(), torch.device("cuda", 0))
        assert torch.get_num_threads() == 6
        DeviceFleetKernel(Weights(), torch.device("cpu"))
        assert torch.get_num_threads() == 2
        torch.set_num_threads(1)
        TorchFleetKernel(Weights(), torch.device("cpu"))
        assert torch.get_num_threads() == 1

    def test_device_fleet_kernel_defaults_to_the_card(self, monkeypatch):
        from yoda_tpu_torch.config import Weights
        from yoda_tpu_torch.ops.kernel import DeviceFleetKernel

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA device"):
            DeviceFleetKernel(Weights())

    def test_worker_entry_bounds_on_the_host_only(self, monkeypatch):
        import os

        from yoda_tpu_torch.framework import procserve

        monkeypatch.setattr(os, "cpu_count", lambda: 8)
        for device, lanes, want in (("cuda", 8, 6), ("cpu", 8, 1)):
            torch.set_num_threads(6)
            with pytest.raises(SystemExit):
                procserve.main(["--device", device, "--shard-count", str(lanes)])
            assert torch.get_num_threads() == want


class TestUnportedKnobs:
    @pytest.mark.parametrize("knob,value", [("kernel_device_min_elems", 1024)])
    def test_raises_naming_the_knob(self, knob, value):
        cfg = dataclasses.replace(
            SchedulerConfig(kernel_platform="cpu", shard_count=2), **{knob: value}
        )
        with pytest.raises(NotImplementedError, match=knob) as err:
            build_stack(config=cfg)
        assert "ROADMAP item" not in str(err.value)

    @pytest.mark.parametrize(
        "knob,value",
        [
            ("federation_degraded_after_s", 2.0),
            ("federation_partitioned_after_s", 20.0),
            ("federation_lost_after_s", 60.0),
            ("federation_probe_period_s", 0.5),
            ("federation_spillover", False),
        ],
    )
    def test_federation_knob_builds_everything(self, knob, value):
        """The ``federation_*`` knobs are ported: a stack takes each with
        nothing left out, and ``build_federation`` hands it to the health
        monitors and the spillover switch as the reference does."""
        from yoda_tpu_torch.standalone import build_federation

        cfg = dataclasses.replace(
            SchedulerConfig(kernel_platform="cpu"), **{knob: value}
        )
        assert unported_settings(cfg) == []
        stack = build_stack(config=cfg)
        stack.close()
        assert stack.not_built == ()
        fed = build_federation([("home", FakeCluster()), ("remote", FakeCluster())], cfg)
        try:
            for m in fed.members:
                assert m.stack.not_built == ()
                assert m.stack.batch.device == torch.device("cpu")
                assert (m.health.degraded_after_s, m.health.partitioned_after_s,
                        m.health.lost_after_s) == (
                    cfg.federation_degraded_after_s,
                    cfg.federation_partitioned_after_s, cfg.federation_lost_after_s)
            assert fed.spillover is cfg.federation_spillover
            assert len({id(m.stack.metrics) for m in fed.members}) == 1
        finally:
            for m in fed.members:
                m.stack.close()

    @pytest.mark.parametrize(
        "knob,value",
        [
            ("shard_count", 2),
            ("journal_path", None),
            ("journal_sync", "always"),
            ("profiles", None),
            ("shard_mode", "process"),
            ("commit_listen", "127.0.0.1:7000"),
            ("commit_endpoint", "127.0.0.1:7000"),
        ],
    )
    def test_durability_knob_builds_everything(self, knob, value, tmp_path):
        """The durable journal, the thread lanes, profiles, the process
        lanes' parent and the commit transport's knobs are ported: each
        knob builds its assembly on the host with nothing left out, every
        lane or profile on the kernel_platform asked for."""
        if knob == "journal_path":
            value = str(tmp_path)
        if knob == "profiles":
            value = (SchedulerConfig(scheduler_name="b", kernel_platform="cpu"),)
        cfg = dataclasses.replace(
            SchedulerConfig(kernel_platform="cpu"), **{knob: value}
        )
        assert unported_settings(cfg) == []
        assert unported_settings(dataclasses.replace(cfg, shard_count=2)) == []
        if knob == "shard_count":
            stacks = build_sharded_stacks(config=cfg).stacks
            assert [st.scheduler.shard for st in stacks] == ["global", "s0", "s1"]
        elif knob == "shard_mode":
            # The parent of process lanes: only the global lane is built
            # here; the shard lanes are worker processes.
            ss = build_proc_parent(config=dataclasses.replace(cfg, shard_count=2))
            stacks = ss.stacks
            assert [st.scheduler.shard for st in stacks] == ["global"]
            assert ss.supervisor is None
        elif knob == "profiles":
            stacks = build_profile_stacks(FakeCluster(), cfg)
            assert len({id(st.accountant) for st in stacks}) == 1
        else:
            stacks = [build_stack(config=cfg)]
            assert (stacks[0].journal is not None) == (knob == "journal_path")
        try:
            for st in stacks:
                assert st.not_built == ()
                assert st.batch.device == torch.device("cpu")
        finally:
            for st in stacks:
                st.close()

    @pytest.mark.parametrize(
        "entry",
        ["sharded", "profiles", "process", "drive_worker", "replay", "federation"],
    )
    def test_assemblies_run_on_the_card_by_default(self, entry, monkeypatch,
                                                   tmp_path):
        """``build_sharded_stacks``, ``build_profile_stacks``,
        ``build_proc_parent``, ``build_federation``, the chaos harness's
        ``DriveWorker`` and the trace replayer's ``replay`` keep the card as
        their default: with none present they raise naming the card (the
        drive worker before it spawns), never fall back to the host lane by
        lane or member by member."""
        import subprocess

        from yoda_tpu_torch.testing import chaos, tracegen

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        spawned = []
        monkeypatch.setattr(subprocess, "Popen", lambda *a, **kw: spawned.append(a))
        with pytest.raises(RuntimeError, match="CUDA device"):
            if entry == "drive_worker":
                chaos.DriveWorker("sock", "s0", [], tmpdir=str(tmp_path))
            elif entry == "replay":
                tracegen.replay(tracegen.TraceSpec(duration_s=5.0), hosts=1)
            elif entry == "sharded":
                build_sharded_stacks(config=SchedulerConfig(shard_count=2))
            elif entry == "federation":
                from yoda_tpu_torch.standalone import build_federation

                build_federation([("home", FakeCluster()), ("remote", FakeCluster())])
            elif entry == "process":
                build_proc_parent(
                    config=SchedulerConfig(shard_count=2, shard_mode="process")
                )
            else:
                build_profile_stacks(
                    FakeCluster(),
                    SchedulerConfig(
                        profiles=(SchedulerConfig(scheduler_name="b"),)
                    ),
                )
        assert not spawned

    @pytest.mark.parametrize(
        "knob,value",
        [
            ("mode", "loop"),
            ("mesh_devices", 2),
            ("percentage_nodes_to_score", 50),
        ],
    )
    def test_evaluation_knob_builds_everything(self, knob, value):
        """The knobs that pick how a pod is evaluated (loop mode, its
        search cap, the node-sharded evaluation) are ported: each builds a
        stack with nothing left out."""
        cfg = dataclasses.replace(
            SchedulerConfig(kernel_platform="cpu"), **{knob: value}
        )
        assert unported_settings(cfg) == []
        stack = build_stack(config=cfg)
        try:
            assert stack.not_built == ()
            assert (stack.batch is None) == (knob == "mode")
        finally:
            stack.close()

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
        # Tracing, the SLO engine, the overload controller and the bind
        # pipeline are ported: nothing is named, and nothing is warned.
        assert stack.not_built == ()
        assert "bind_pipeline" not in UNPORTED_KNOB_VALUES
        assert stack.gang.bind_executor is stack.bind_executor
        warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
        assert warnings == []

    @pytest.mark.parametrize(
        "part,knob", [
            ("tracing", "trace_sample_rate"),
            ("SLO engine", "slo_enabled"),
            ("overload controller", "overload_period_s"),
        ],
    )
    def test_observability_part_built(self, part, knob):
        # Each part the reference builds by default is built and wired on
        # stack.metrics, and never named in not_built.
        stack = build_stack(config=SchedulerConfig(kernel_platform="cpu"))
        m = stack.metrics
        assert not [p for p in stack.not_built if p.startswith(part)]
        assert knob not in UNPORTED_KNOB_VALUES
        if part == "tracing":
            assert m.tracer.enabled and m.tracer.sample_rate == 1.0
            assert stack.framework.tracer is m.tracer
            assert stack.gang.tracer is m.tracer and stack.batch.tracer is m.tracer
            assert stack.gang.pending is m.pending
        elif part == "SLO engine":
            assert m.slo.enabled and stack.queue in m.slo._queues
            assert m.slo.goodput_fn is not None
        else:
            assert m.overload.period_s == 1.0
            assert stack.queue in m.overload._queues
            assert m.overload.tracer is m.tracer and m.overload.slo is m.slo

    def test_switched_off_parts_are_not_named(self, caplog):
        off = {knob: values[0] for knob, (_part, values) in UNPORTED_KNOB_VALUES.items()}
        cfg = dataclasses.replace(SchedulerConfig(kernel_platform="cpu"), **off)
        with caplog.at_level(logging.WARNING, logger="yoda_tpu_torch.standalone"):
            stack = build_stack(config=cfg)
        assert stack.not_built == ()
        assert not [r for r in caplog.records if r.levelno == logging.WARNING]


class TestBindPipeline:
    """The bind pipeline is built as the reference builds it: the executor
    carries the CLI's stop event, and a gang's release fans out on it when
    ``bind_pipeline`` is "on", or "auto" with binds that are real I/O."""

    @pytest.mark.parametrize(
        "pipeline,latency,remote,workers,want",
        [
            ("auto", 0.0, False, 8, False),
            ("auto", 0.002, False, 8, True),
            ("auto", 0.0, True, 8, True),
            ("on", 0.0, False, 8, True),
            ("off", 0.002, True, 8, False),
            ("on", 0.002, True, 0, False),
        ],
    )
    def test_parallel_release_gate(self, pipeline, latency, remote, workers, want):
        import threading

        from yoda_tpu_torch.cluster.fake import FakeCluster

        cluster = FakeCluster(bind_latency_s=latency)
        if remote:
            cluster.remote_binds = True
        stop = threading.Event()
        cfg = dataclasses.replace(
            SchedulerConfig(kernel_platform="cpu"),
            bind_pipeline=pipeline, bind_workers=workers,
        )
        assert unported_settings(cfg) == []
        stack = build_stack(cluster, cfg, stop_event=stop)
        try:
            assert stack.gang.parallel_release is want
            assert stack.not_built == ()
            if workers:
                assert stack.bind_executor.stop_event is stop
                assert stack.binder.stop_event is stop
                assert stack.scheduler.bind_executor is stack.bind_executor
            else:
                assert stack.bind_executor is None and stack.binder.stop_event is None
            assert stack.binder.fenced_fn.__self__ is stack.scheduler
            assert stack.preemption.fenced_fn.__self__ is stack.scheduler
        finally:
            stack.close()
        if workers:
            # Stack.close shuts the gang's executor down, its stop event set.
            assert stop.is_set() and stack.gang.bind_executor is None


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


class TestObservabilityModules:
    """The observability modules exist, are covered by the import guard,
    and their knobs are honoured at any valid value."""

    @pytest.mark.parametrize(
        "module",
        [
            "tracing.py", "observability.py", "overload.py", "metrics_server.py",
            "logging_setup.py", "slo/__init__.py", "slo/engine.py",
            "framework/tenancy.py",
        ],
    )
    def test_observability_modules_are_guarded(self, module):
        path = REPO / "yoda_tpu_torch" / module
        assert path in set((REPO / "yoda_tpu_torch").rglob("*.py"))
        assert not [m for m in _imports(path) if _forbidden(m)]

    @pytest.mark.parametrize(
        "knob,value,read",
        [
            ("trace_sample_rate", 0.25, lambda m: m.tracer.sample_rate),
            ("trace_capacity", 64, lambda m: m.tracer.capacity),
            ("pending_index_max", 32, lambda m: m.pending.capacity),
            ("slo_enabled", False, lambda m: m.slo.enabled),
            ("slo_burn_threshold", 3.0, lambda m: m.slo.burn_threshold),
            ("overload_period_s", 0.5, lambda m: m.overload.period_s),
            ("overload_queue_high", 7, lambda m: m.overload.queue_high),
            ("overload_cycle_ms_high", 0.0, lambda m: m.overload.cycle_ms_high),
            ("overload_shed_priority", 3, lambda m: m.overload.shed_priority_floor),
        ],
    )
    def test_knob_honoured(self, knob, value, read):
        cfg = dataclasses.replace(
            SchedulerConfig(kernel_platform="cpu"), **{knob: value}
        )
        assert unported_settings(cfg) == []
        assert read(build_stack(config=cfg).metrics) == value


def _quota_ask(stack, chips: int, hbm_mib: int = 0) -> "str | None":
    """The queue's quota verdict for a pod of tenant "t" asking ``chips``
    chips (and ``hbm_mib`` MiB of HBM per chip)."""
    labels = {"tpu/chips": str(chips)}
    if hbm_mib:
        labels["tpu/hbm"] = str(hbm_mib)
    return stack.queue._quota_fn("t", PodSpec("ask", namespace="t", labels=labels))


class TestTenancyAndIngest:
    """Tenancy, batched ingest and the Event recorder are ported: their
    modules are under the import guard, and their knobs are honoured at
    any valid value."""

    @pytest.mark.parametrize(
        "module",
        ["cluster/__init__.py", "cluster/ingest.py", "cluster/events.py",
         "framework/tenancy.py", "framework/queue.py"],
    )
    def test_modules_are_guarded(self, module):
        path = REPO / "yoda_tpu_torch" / module
        assert path in set((REPO / "yoda_tpu_torch").rglob("*.py"))
        assert not [m for m in _imports(path) if _forbidden(m)]

    def test_events_built_by_default(self):
        stack = build_stack(config=SchedulerConfig(kernel_platform="cpu"))
        assert stack.events is not None
        assert stack.gang.on_rollback == stack.events.gang_rollback
        assert stack.scheduler.on_bound == stack.events.scheduled
        assert stack.scheduler.on_unschedulable == stack.events.failed_scheduling
        assert stack.preemption.on_victim is not None
        assert stack.ingestor is None and stack.tenants is None
        stack.close()

    @pytest.mark.parametrize(
        "knob,value,extra,read",
        [
            ("tenant_fairness", True, {},
             lambda st: st.tenants is not None and st.queue._tenant_of is not None),
            ("ingest_batch_window_ms", 2.0, {},
             lambda st: st.ingestor.window_s * 1000.0),
            ("ingest_batch_max", 64, {"ingest_batch_window_ms": 2.0},
             lambda st: st.ingestor.batch_max),
            ("tenant_quota_chips", 512, {"tenant_fairness": True},
             lambda st: (_quota_ask(st, 512) is None) * 512
             + (_quota_ask(st, 513) is None)),
            ("tenant_quota_hbm_gib", 2.0, {"tenant_fairness": True},
             lambda st: (_quota_ask(st, 1, 2048) is None) * 2.0
             + (_quota_ask(st, 1, 2049) is None)),
        ],
    )
    def test_knob_honoured(self, knob, value, extra, read):
        cfg = dataclasses.replace(
            SchedulerConfig(kernel_platform="cpu"), **{knob: value, **extra}
        )
        assert unported_settings(cfg) == []
        stack = build_stack(config=cfg)
        try:
            assert read(stack) == value
            assert not [p for p in stack.not_built if knob in p]
        finally:
            stack.close()


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
