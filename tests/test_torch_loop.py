"""Loop mode (``mode: loop``, ``percentage_nodes_to_score``) held against
yoda_tpu.

The reference's own cases run on both packages from its source
(``torch_refcases.run_case``), with their exact assertions:

- every case of ``tests/test_yoda_plugin.py`` (the chip predicates,
  ``YodaFilter``, collection, scoring, the whole per-node plugin set through
  the framework driver, the stale-freed credit in both modes);
- the loop cases of ``tests/test_ops.py``: ``test_batch_and_loop_agree``
  (16 seeded fleets, both scoring strategies), the feasible sets of
  ``YodaFilter`` against the fused evaluation, and the tie-break; the
  other cases of that file run too, but for the ones that need a part the
  port has under another name or not at all (``SKIP``);
- every case of ``tests/test_framework.py`` (its
  ``TestPercentageNodesToScore`` and ``TestSearchTruncation`` drive the
  truncated, rotating search);
- ``tests/test_stress.py::test_serve_forever_loop_mode_truncated_search``
  and ``tests/test_burst.py::TestBurstConfig``.

Beside them: the loop-mode predicates, collection and scores of both
packages on one seeded fleet (tolerance 0), a seeded loop-mode stack of
singletons and gangs at ``percentage_nodes_to_score`` 25 whose bindings
equal the reference's, and chip_smoke's run (m) at its small size.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
from chip_smoke import SteppedClock
from torch_refcases import PACKAGES, cases, run_case

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.types as ref_types
import yoda_tpu.config as ref_config
import yoda_tpu.framework as ref_framework
import yoda_tpu.plugins.yoda as ref_plugins
import yoda_tpu.plugins.yoda.collection as ref_collection
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent as port_agent
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.framework as port_framework
import yoda_tpu_torch.plugins.yoda as port_plugins
import yoda_tpu_torch.plugins.yoda.collection as port_collection
import yoda_tpu_torch.standalone as port_standalone

def _class_skip(ref: str, reasons: "dict[str, str]") -> "dict[str, str]":
    """Every case of the named test classes of ``ref``, with its reason."""
    return {
        c[0].split("[")[0]: reasons[c[1]] for c in cases(ref, {}) if c[1] in reasons
    }


OPS_SKIP = _class_skip("test_ops.py", {
    "TestDeviceFleetKernel": "run by test_torch_parity_ops.py",
    "TestBatchPlatformPolicy": "the TPU-measured auto platform policy, not "
    "carried over (ROADMAP B7)",
})

REFS = {
    "test_yoda_plugin.py": {},
    "test_ops.py": OPS_SKIP,
    "test_framework.py": {},
}

ONE_CASE = [
    ("test_stress.py", "test_serve_forever_loop_mode_truncated_search"),
    ("test_burst.py", "TestBurstConfig::test_batch_requests_requires_batch_mode"),
]


def _all_cases():
    # None of these reference files marks a case slow, so every case comes
    # as a plain tuple.
    out = [
        pytest.param(ref, c, id=f"{ref}::{c[0]}")
        for ref, skip in REFS.items()
        for c in cases(ref, skip)
    ]
    for ref, case_id in ONE_CASE:
        (c,) = [c for c in cases(ref, {}) if c[0] == case_id]
        out.append(pytest.param(ref, c, id=f"{ref}::{case_id}"))
    return out


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("ref,case", _all_cases())
def test_reference_case(pkg, ref, case, request, monkeypatch):
    run_case(pkg, ref, case, request, monkeypatch)


SIDES = {
    "yoda_tpu": (ref_standalone, ref_config, ref_agent, ref_types),
    "yoda_tpu_torch": (port_standalone, port_config, port_agent, port_types),
}


def loop_script(pkg: str, seed: int = 23) -> dict:
    """A seeded loop-mode stack at percentage_nodes_to_score 25 on a held
    scheduling clock: 40 v5e hosts of 8 chips and four v5p 2x2x1 slices,
    two plain gangs of 4 x 8 chips, a topology gang and 24 singletons in a
    seeded order, drained; returns pod -> node."""
    standalone, config, agent_mod, types = SIDES[pkg]
    kw = {"kernel_platform": "cpu"} if pkg == "yoda_tpu_torch" else {}
    stack = standalone.build_stack(
        config=config.SchedulerConfig(mode="loop", percentage_nodes_to_score=25, **kw),
        clock=SteppedClock(0.0),
    )
    agent = agent_mod.FakeTpuAgent(stack.cluster)
    for h in range(40):
        agent.add_host(f"v5e-{h:02d}", generation="v5e", chips=8)
    for s in range(4):
        agent.add_slice(f"v5p-{s}", generation="v5p", host_topology=(2, 2, 1))
    agent.publish_all()
    rng = np.random.default_rng(seed)
    pods = []
    for g in range(2):
        pods += [(f"g{g}-{m}", {"tpu/chips": "8", "tpu/gang": f"g{g}",
                                "tpu/gang-size": "4", "tpu/generation": "v5e"})
                 for m in range(4)]
    pods += [(f"t-{m}", {"tpu/gang": "t", "tpu/topology": "2x2x1", "tpu/chips": "4",
                         "tpu/generation": "v5p"}) for m in range(4)]
    for i in range(24):
        labels = {"tpu/chips": str(int(rng.choice([1, 2, 4, 8])))}
        if rng.random() < 0.5:
            labels["tpu/hbm"] = f"{int(rng.integers(1, 12))}Gi"
        pods.append((f"s-{i}", labels))
    for i in rng.permutation(len(pods)):
        name, labels = pods[i]
        stack.cluster.create_pod(types.PodSpec(name, labels=labels))
    stack.scheduler.run_until_idle(max_wall_s=60)
    bound = {p.name: p.node_name for p in stack.cluster.list_pods()}
    if pkg == "yoda_tpu_torch":
        assert stack.batch is None and stack.not_built == ()
        stack.close()
    return bound


class TestLoopStackParity:
    def test_bindings_equal_reference(self):
        got = loop_script("yoda_tpu_torch")
        assert got == loop_script("yoda_tpu")
        assert all(got.values())


class TestLoopPlugins:
    """The loop-mode plugins of both packages on one seeded fleet and pod,
    tolerance 0: each node's filter verdict and message, the collected
    maxima, and every score plugin's per-node score and normalized
    scores."""

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_filter_collect_score_equal(self, seed):
        side = {}
        for pkg, (types, fw, plugins, coll) in {
            "ref": (ref_types, ref_framework, ref_plugins, ref_collection),
            "port": (port_types, port_framework, port_plugins, port_collection),
        }.items():
            r = random.Random(seed)
            nodes = []
            for i in range(r.randrange(4, 16)):
                chips = r.choice([1, 2, 4, 8])
                nodes.append(types.make_node(
                    f"n{i:02d}", chips=chips, hbm_per_chip=r.choice([16, 32]) << 30,
                    hbm_free_per_chip=r.randrange(0, 16) << 30,
                    generation=r.choice(["v5e", "v5p"]),
                    clock_mhz=r.choice([840, 940, 1200]),
                    unhealthy=[j for j in range(chips) if r.random() < 0.1],
                ))
            snapshot = fw.Snapshot({n.name: fw.NodeInfo(n.name, tpu=n) for n in nodes})
            labels = {"tpu/chips": str(r.choice([1, 2, 4])),
                      "tpu/hbm": f"{r.choice([1, 4, 8])}Gi"}
            pod = types.PodSpec("p", labels=labels)
            state = fw.CycleState()
            assert plugins.YodaPreFilter().pre_filter(state, pod, snapshot).success
            reserved = {n.name: r.randrange(0, 3) for n in nodes}
            filt_plugin = plugins.YodaFilter(reserved.get)
            verdicts = {
                ni.name: (st.success, st.message)
                for ni in snapshot.infos()
                for st in [filt_plugin.filter(state, pod, ni)]
            }
            feasible = sorted(n for n, (ok, _) in verdicts.items() if ok)
            plugins.YodaPreScore().pre_score(state, pod, snapshot, feasible)
            maxima = vars(state.read(coll.MAX_KEY))
            scores = {}
            for plugin in (plugins.YodaScore(), plugins.SliceProtectScore(),
                           plugins.PreferredAffinityScore(), plugins.ImageLocalityScore()):
                per = {n: plugin.score(state, pod, snapshot.get(n))[0] for n in feasible}
                normalized = dict(per)
                plugin.normalize(state, pod, normalized)
                scores[plugin.name] = (per, normalized)
            side[pkg] = (verdicts, maxima, scores)
        assert side["ref"] == side["port"]


class TestRunM:
    """chip_smoke's run (m) at its small size on the CPU: (m1) loop and
    batch agree pod by pod, (m2) binds every gang whole."""

    def test_loop_run_holds_its_checks(self):
        from chip_smoke import LOOP_SMALL, run_loop

        out = run_loop("cpu", LOOP_SMALL)
        assert out["m1"]["launches"] == 0 and out["m1"]["pods"] == LOOP_SMALL["singles"]
        assert out["m2"]["filter_calls"] >= out["m2"]["pods"]


class TestLoopFamilies:
    def test_loop_stack_registers_the_reference_families(self):
        """A loop-mode stack builds no batch plugin, so neither package
        registers its counters (the fleet gauges stay): the same families,
        types and help strings."""
        from chip_smoke import close_stack
        from test_torch_observability import scrape

        got = {}
        for pkg in PACKAGES:
            standalone, config, _agent, _types = SIDES[pkg]
            stack = standalone.build_stack(
                config=config.SchedulerConfig(mode="loop", kernel_platform="cpu")
            )
            types, _samples = scrape(stack.metrics.registry.render_prometheus())
            helps = {f.name: f.help for f in stack.metrics.registry._metrics}
            got[pkg] = (types, helps)
            close_stack(stack)
        assert got["yoda_tpu"] == got["yoda_tpu_torch"]
        assert "yoda_kernel_dispatches_total" not in got["yoda_tpu_torch"][0]
