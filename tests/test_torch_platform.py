"""The platform policy (``kernel_platform``, the dispatch-floor probe and
its gauge, the refused ``kernel_device_min_elems``) held against yoda_tpu
on the CPU.

The reference's ``YodaBatch._device_for`` decides, from a fleet's padded
shape and its dispatch floor, whether it evaluates on its accelerator
(``None``) or on the host (the JAX CPU device). The port's plugin keeps
the device ``kernel_platform`` names at every shape: ``cpu`` the host,
``auto`` and ``device`` the card. Over a grid of platform x dispatch floor
x fleet size both agree, except where the reference's two TPU-measured
cut-offs send a fleet to the host under ``auto``, each asserted by name:

- ``size_cutoff``: fleets under ``AUTO_DEVICE_MIN_ELEMS`` (2^22 padded
  elements) go to the host (on an H100 the card beat the host at every
  shape measured, chip_smoke.py run (t2), so the port refuses the
  ``kernel_device_min_elems`` knob that moves this cut);
- ``floor_alarm``: a device whose dispatch floor is over
  ``AUTO_REMOTE_FLOOR_MS`` counts as remote (the port logs the floor as an
  error and keeps the card).

The card is a stand-in here: ``resolve_device`` is patched to give
``cpu:0``, a device that compares unequal to the host's ``cpu``, while
every evaluation runs the plain version.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import types

import pytest
import torch

import yoda_tpu.api.types as ref_types
import yoda_tpu.framework as ref_framework
import yoda_tpu.ops as ref_ops
import yoda_tpu.plugins.yoda.batch as ref_batch
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.framework as port_framework
import yoda_tpu_torch.ops.arrays as port_arrays
import yoda_tpu_torch.plugins.yoda.batch as port_batch
from yoda_tpu.agent import FakeTpuAgent as RefAgent
from yoda_tpu.config import SchedulerConfig as RefConfig
from yoda_tpu.standalone import build_stack as ref_build_stack
from yoda_tpu_torch.agent import FakeTpuAgent
from yoda_tpu_torch.config import SchedulerConfig
from yoda_tpu_torch.standalone import (
    NOT_CARRIED_OVER,
    PORTED_KNOBS,
    build_stack,
    unported_settings,
)

CARD = torch.device("cpu", 0)  # the stand-in card
HOST = torch.device("cpu")
FLOOR_CUT = port_batch.AUTO_REMOTE_FLOOR_MS


@pytest.fixture
def card(monkeypatch):
    """A card on the CPU: "auto" and "device" resolve to ``CARD``."""
    real = port_batch.resolve_device

    def resolve(platform):
        return CARD if platform in ("auto", "device") else real(platform)

    monkeypatch.setattr(port_batch, "resolve_device", resolve)
    return CARD


def _fleets(hosts: int):
    """The same hosts as each package's FleetArrays."""
    out = []
    for types_, framework, from_snapshot in (
        (ref_types, ref_framework, ref_ops.FleetArrays.from_snapshot),
        (port_types, port_framework, port_arrays.FleetArrays.from_snapshot),
    ):
        nodes = [types_.make_node(f"n{i}", chips=4) for i in range(hosts)]
        snap = framework.Snapshot(
            {x.name: framework.NodeInfo(x.name, tpu=x) for x in nodes}
        )
        out.append(from_snapshot(snap))
    return out


PLATFORMS = ("auto", "cpu", "device")
FLOORS = (0.1, 95.0)
HOSTS = (2, 52, 600)


def departures(platform, floor, elems) -> "tuple[str, ...]":
    """The reference's cut-offs that send one grid cell to the host."""
    if platform != "auto":
        return ()
    return tuple(
        name for name, hit in (
            ("size_cutoff", elems < ref_batch.AUTO_DEVICE_MIN_ELEMS),
            ("floor_alarm", floor > FLOOR_CUT),
        ) if hit
    )


@pytest.mark.parametrize("hosts", HOSTS)
@pytest.mark.parametrize("floor", FLOORS)
@pytest.mark.parametrize("platform", PLATFORMS)
def test_decision_against_the_reference(card, platform, floor, hosts):
    import jax

    ref_arrays, port_arrays_ = _fleets(hosts)
    assert ref_arrays.padded_shape == port_arrays_.padded_shape
    n, c = port_arrays_.padded_shape

    ref = ref_batch.YodaBatch(platform=platform)
    ref._floor_ms = floor
    got = ref._device_for(ref_arrays)
    assert got is None or got == jax.devices("cpu")[0]
    ref_side = "card" if got is None else "host"

    port = port_batch.YodaBatch(platform=platform)
    port_side = {CARD: "card", HOST: "host"}[port.device]

    why = departures(platform, floor, n * c)
    if not why:
        assert port_side == ref_side
    else:
        assert (ref_side, port_side) == ("host", "card"), why


@pytest.mark.parametrize("platform", ("auto", "device"))
def test_no_card_raises(monkeypatch, platform):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        port_batch.YodaBatch(platform=platform)
    with pytest.raises(RuntimeError, match="CUDA device"):
        build_stack(config=SchedulerConfig(kernel_platform=platform))


# --- a resident fleet that grows -------------------------------------------


def _script(side_build, side_agent, pod_cls, config, grow_to):
    """52 v5e hosts, 24 singletons, the fleet grown to ``grow_to`` hosts
    through the agent, 24 more singletons. Returns (bindings, stack)."""
    stack = side_build(config=config)
    agent = side_agent(stack.cluster)
    for i in range(52):
        agent.add_host(f"h{i:03d}", generation="v5e", chips=8)
    agent.publish_all()
    binds = {}
    names = []
    for wave, start in ((0, 0), (1, 52)):
        if wave:
            for i in range(start, grow_to):
                agent.add_host(f"h{i:03d}", generation="v5e", chips=8)
            agent.publish_all()
        for j in range(24):
            name = f"w{wave}-p{j}"
            names.append(name)
            stack.cluster.create_pod(
                pod_cls(name, labels={"tpu/chips": str(1 + j % 4)})
            )
        stack.scheduler.run_until_idle(max_wall_s=30)
    for name in names:
        pod = stack.cluster.get_pod(f"default/{name}")
        binds[name] = pod.node_name if pod is not None else None
    return binds, stack


def test_a_growing_fleet_stays_on_the_card(card, monkeypatch):
    """The default stack keeps a fleet on the card as it grows from 64 x 8
    to 1,024 x 8 padded elements and re-stacks, probing the floor once;
    the reference, at its default, keeps the same fleet on the host.
    Bindings are equal."""
    probes = []
    real_probe = port_batch.YodaBatch._dispatch_floor_ms

    def probe(plugin):
        probes.append(plugin._floor_ms)
        return real_probe(plugin)

    monkeypatch.setattr(port_batch.YodaBatch, "_dispatch_floor_ms", probe)
    ref_binds, ref_stack = _script(
        ref_build_stack, RefAgent, ref_types.PodSpec,
        RefConfig(enable_preemption=False), 600,
    )
    binds, stack = _script(
        build_stack, FakeTpuAgent, port_types.PodSpec,
        SchedulerConfig(enable_preemption=False), 600,
    )
    try:
        assert binds == ref_binds
        assert all(binds.values())
        b = stack.batch
        assert b.device == CARD and b._kern.device == CARD
        assert b._resident.restacks >= 2
        assert probes == [None]                  # once, at the first re-stack
        ref_b = next(
            p for p in ref_stack.framework.batch_plugins
            if isinstance(p, ref_batch.YodaBatch)
        )
        assert ref_b._kern_device is not None    # the reference's host
    finally:
        stack.close()


# --- the floor probe and its gauge -----------------------------------------


def _gauge(stack) -> float:
    for line in stack.metrics.registry.render_prometheus().splitlines():
        if line.startswith("yoda_kernel_dispatch_floor_ms "):
            return float(line.split()[1])
    raise AssertionError("yoda_kernel_dispatch_floor_ms not exported")


def _serve_one(stack) -> None:
    agent = FakeTpuAgent(stack.cluster)
    agent.add_host("h0", generation="v5e", chips=8)
    agent.publish_all()
    stack.cluster.create_pod(port_types.PodSpec("p", labels={"tpu/chips": "1"}))
    stack.scheduler.run_until_idle(max_wall_s=10)


def test_floor_gauge_reads_the_probe(card):
    stack = build_stack(config=SchedulerConfig())
    try:
        assert _gauge(stack) == 0.0            # not probed before a dispatch
        _serve_one(stack)
        floor = stack.batch._floor_ms
        assert floor is not None and floor > 0
        assert _gauge(stack) == pytest.approx(floor)
        assert stack.batch._dispatch_floor_ms() == floor  # cached
        stack.batch._floor_ms = 0.25
        assert _gauge(stack) == 0.25
    finally:
        stack.close()


def test_cpu_platform_never_probes():
    stack = build_stack(config=SchedulerConfig(kernel_platform="cpu"))
    try:
        _serve_one(stack)
        assert stack.batch._floor_ms is None and _gauge(stack) == 0.0
    finally:
        stack.close()


def test_slow_floor_is_logged_and_the_card_kept(card, caplog, monkeypatch):
    """A floor over AUTO_REMOTE_FLOOR_MS (95 ms a round trip here) is
    logged once as an error; the plugin stays on the card."""
    clock = itertools.count(step=0.095)
    monkeypatch.setattr(port_batch.time, "perf_counter", lambda: next(clock))
    b = port_batch.YodaBatch(platform="auto")
    with caplog.at_level(logging.ERROR, logger="yoda_tpu_torch.batch"):
        assert b._dispatch_floor_ms() == pytest.approx(95.0)
        b._dispatch_floor_ms()
    alarms = [r for r in caplog.records if "dispatch floor" in r.getMessage()]
    assert len(alarms) == 1 and alarms[0].levelno == logging.ERROR
    assert b.device == CARD


def test_probe_launches_are_counted_where_made(card, monkeypatch):
    """Seven launches a probe (the input's fill, the warm-up, five timed
    round trips), each counted by ``_probe_launch`` when it ran on the
    card, and never again once the floor is cached."""
    calls = []
    real = port_batch._probe_launch
    monkeypatch.setattr(
        port_batch, "_probe_launch", lambda op: calls.append(op) or real(op)
    )
    b = port_batch.YodaBatch(platform="auto")
    b._dispatch_floor_ms()
    b._dispatch_floor_ms()
    assert len(calls) == 7
    before = port_batch.floor_probe_launches
    real(lambda: torch.zeros(8))               # a host tensor: not counted
    assert port_batch.floor_probe_launches == before
    real(lambda: types.SimpleNamespace(is_cuda=True))  # as on the card
    assert port_batch.floor_probe_launches == before + 1


# --- the refused knob -------------------------------------------------------


def test_every_other_reference_knob_is_ported():
    ref_fields = {f.name for f in dataclasses.fields(RefConfig)}
    assert ref_fields - PORTED_KNOBS == {"kernel_device_min_elems"}
    assert set(NOT_CARRIED_OVER) == {"kernel_device_min_elems"}


@pytest.mark.parametrize("value", [1, 4096, 1 << 22])
def test_min_elems_knob_is_refused_naming_the_measurement(value):
    cfg = SchedulerConfig(kernel_platform="cpu", kernel_device_min_elems=value)
    (why,) = unported_settings(cfg)
    assert why.startswith(f"kernel_device_min_elems={value}")
    assert "run (t2)" in why and "ROADMAP item" not in why
    with pytest.raises(NotImplementedError, match="kernel_device_min_elems"):
        build_stack(config=cfg)
