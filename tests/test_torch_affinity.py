"""The port's inter-pod affinity, anti-affinity and topology spread
(yoda_tpu_torch/api/affinity.py and the PreFilter, batch, gang and
preemption paths that read it) held against the JAX package's on the CPU,
tolerance 0.

- Evaluators: seeded snapshots of 12-48 nodes over 2-4 zones, with bound
  pods in three namespaces, pending (Permit-parked) placements and
  incoming pods carrying random required and preferred (anti-)affinity
  terms and spread constraints (namespace lists, namespaceSelector with and
  without Namespace data, matchLabelKeys, minDomains). Every node's
  ``feasible`` / ``required_affinity_feasible`` / ``preference`` and
  ``SpreadEvaluator.feasible`` / ``score`` must be equal.
- Whole stacks: the same seeded fleet and pods through
  yoda_tpu.standalone.build_stack and the port's, as singletons at
  batch_requests 1 and 16 and as gangs with self anti-affinity and self
  affinity: bindings, the last cycle outcome and message of every pod, and
  the dispatch, burst, admission-cache and gang counters must be equal.
  The reference runs with the speculative placement cache off.
- The two faults the port had before inter-pod affinity was ported: a
  Deployment's anti-affinity replicas were refused, and one bound pod with
  anti-affinity made the port refuse every later pod.
- The admission cache: an affinity-bearing pod never reads a cached
  admission row, so a replica bound after a row was built still repels.
- chip_smoke.py's run (g) at a small size on the plain version, with the
  placement checks its card run makes.

Every script is built from plain dicts, made with numpy's generator, into
each package's own objects (``Side.pod``, ``Side.node``)."""

import dataclasses
from dataclasses import dataclass

import numpy as np
import pytest

import yoda_tpu.api.affinity as ref_aff
import yoda_tpu.api.types as ref_types
import yoda_tpu.framework.interfaces as ref_if
import yoda_tpu_torch.api.affinity as port_aff
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.framework.interfaces as port_if
from yoda_tpu.agent import FakeTpuAgent as RefAgent
from yoda_tpu.config import SchedulerConfig as RefConfig
from yoda_tpu.standalone import build_stack as ref_build_stack
from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
from yoda_tpu_torch.config import SchedulerConfig
from yoda_tpu_torch.standalone import build_stack

HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"
RACK = "rack"
KEYS = (HOST, ZONE, RACK)
APPS = ("web", "db", "cache")
NAMESPACES = {"default": {"team": "a"}, "team-b": {"team": "b"},
              "team-c": {"team": "c", "env": "prod"}}


@dataclass(frozen=True)
class Side:
    """One package: builds its own objects from the plain-dict script."""

    name: str
    types: object
    aff: object
    interfaces: object

    def selector(self, d):
        if d is None:
            return None
        return self.aff.LabelSelector(
            match_labels=tuple(sorted(d.get("labels", {}).items())),
            match_expressions=tuple(
                self.types.NodeSelectorRequirement(k, op, tuple(v))
                for k, op, v in d.get("exprs", ())
            ),
        )

    def term(self, d):
        return self.aff.PodAffinityTerm(
            d["key"], self.selector(d["sel"]), tuple(d.get("ns", ())),
            self.selector(d.get("ns_sel")),
        )

    def spread(self, d):
        return self.aff.TopologySpreadConstraint(
            d["skew"], d["key"], d["when"], self.selector(d["sel"]),
            tuple(d.get("mlk", ())), d.get("min_domains", 0),
        )

    def pod(self, d):
        return self.types.PodSpec(
            d["name"],
            namespace=d.get("ns", "default"),
            labels=dict(d["labels"]),
            scheduler_name=d.get("scheduler", "yoda-tpu"),
            node_name=d.get("node"),
            phase="Running" if d.get("node") else "Pending",
            node_selector=dict(d.get("node_selector", {})),
            pod_affinity=tuple(self.term(t) for t in d.get("aff", ())),
            pod_anti_affinity=tuple(self.term(t) for t in d.get("anti", ())),
            preferred_pod_affinity=tuple((w, self.term(t)) for w, t in d.get("paff", ())),
            preferred_pod_anti_affinity=tuple(
                (w, self.term(t)) for w, t in d.get("panti", ())
            ),
            topology_spread=tuple(self.spread(c) for c in d.get("spread", ())),
            pvc_names=tuple(d.get("pvcs", ())),
        )

    def pvc(self, d):
        return self.types.K8sPvc(
            d["name"], namespace=d.get("ns", "default"),
            selected_node=d.get("selected_node"), zone=d.get("zone"),
            access_modes=tuple(d.get("modes", ())), volume_name=d.get("volume"),
        )

    def pv(self, d):
        return self.types.K8sPv(
            d["name"],
            node_affinity=tuple(
                self.types.NodeSelectorTerm(match_expressions=tuple(
                    self.types.NodeSelectorRequirement(k, op, tuple(v)) for k, op, v in term
                ))
                for term in d.get("affinity", ())
            ),
            claim_ref=d.get("claim"),
            driver=d.get("driver"),
        )

    def pdb(self, d):
        return self.types.K8sPdb(
            d["name"], namespace=d.get("ns", "default"),
            selector=self.selector(d.get("sel")),
            min_available=d.get("min_available"),
            max_unavailable=d.get("max_unavailable"),
            disruptions_allowed=d.get("allowed"),
        )

    def namespace(self, d):
        return self.types.K8sNamespace(d["name"], dict(d.get("labels", {})))

    def node(self, h):
        labels = {HOST: h["name"], ZONE: h["zone"]}
        if h.get("rack"):
            labels[RACK] = h["rack"]
        labels.update(h.get("labels", {}))
        return self.types.K8sNode(
            h["name"], labels=labels, attach_limits=dict(h.get("attach", {}))
        )


REF = Side("ref", ref_types, ref_aff, ref_if)
PORT = Side("port", port_types, port_aff, port_if)


# --- seeded scripts (plain dicts) ---


def rand_selector(rng):
    r = rng.random()
    if r < 0.06:
        return None  # absent: matches nothing
    if r < 0.12:
        return {}  # empty: matches everything
    d = {"labels": {"app": str(rng.choice(APPS))}}
    if rng.random() < 0.25:
        d["exprs"] = [("tier", str(rng.choice(["In", "NotIn"])), ["fe"])]
    return d


def rand_term(rng):
    d = {"key": str(rng.choice(KEYS)), "sel": rand_selector(rng)}
    u = rng.random()
    if u < 0.15:
        d["ns"] = [str(rng.choice(list(NAMESPACES)))]
    elif u < 0.3:
        d["ns_sel"] = {"labels": {"team": str(rng.choice(["b", "c", "z"]))}}
    elif u < 0.35:
        d["ns_sel"] = {}
    return d


def rand_spread(rng):
    return {
        "skew": int(rng.integers(1, 3)),
        "key": str(rng.choice([ZONE, ZONE, HOST, RACK])),
        "when": str(rng.choice(["DoNotSchedule", "ScheduleAnyway"])),
        "sel": rand_selector(rng),
        "mlk": ["pod-template-hash"] if rng.random() < 0.3 else [],
        "min_domains": int(rng.choice([0, 0, 0, 3, 5])),
    }


def rand_pod(rng, name, *, ns=None, heavy=0.3, chips=None):
    labels = {"app": str(rng.choice(APPS))}
    if rng.random() < 0.5:
        labels["tier"] = str(rng.choice(["fe", "be"]))
    if rng.random() < 0.5:
        labels["pod-template-hash"] = str(rng.choice(["h1", "h2"]))
    if chips is not None:
        labels["tpu/chips"] = str(chips)
    if ns is None:
        ns = str(rng.choice(["default", "default", "team-b", "team-c", "unlisted"]))
    d = {"name": name, "ns": ns, "labels": labels}
    for key in ("aff", "anti"):
        if rng.random() < heavy:
            d[key] = [rand_term(rng) for _ in range(int(rng.integers(1, 3)))]
    for key in ("paff", "panti"):
        if rng.random() < heavy:
            d[key] = [(int(rng.integers(1, 101)), rand_term(rng))
                      for _ in range(int(rng.integers(1, 3)))]
    if rng.random() < heavy:
        d["spread"] = [rand_spread(rng) for _ in range(int(rng.integers(1, 3)))]
    return d


def rand_nodes(rng, n: int, zones: int):
    nodes = []
    for i in range(n):
        nodes.append({
            "name": f"n{i:02d}",
            "zone": f"zone-{int(rng.integers(0, zones))}",
            "rack": f"rack-{i // 4}" if rng.random() < 0.7 else None,
        })
    return nodes


def snapshot(side: Side, nodes, placed, ns_labels):
    """``placed``: node name -> list of pod objects of this side."""
    infos = {}
    for i, h in enumerate(nodes):
        infos[h["name"]] = side.interfaces.NodeInfo(
            name=h["name"], pods=list(placed.get(h["name"], [])),
            # Two nodes without a Node object: no labels, no domain.
            node=None if i in (3, 7) else side.node(h),
        )
    return side.interfaces.Snapshot(infos, version=1, namespaces=ns_labels)


def evaluator_rows(side: Side, seed: int):
    rng = np.random.default_rng(seed)
    nodes = rand_nodes(rng, int(rng.integers(12, 49)), int(rng.integers(2, 5)))
    names = [h["name"] for h in nodes]
    objs = {}

    def make(d):
        objs[d["name"]] = side.pod(d)
        return objs[d["name"]]

    placed: dict[str, list] = {}
    for j in range(int(rng.integers(10, 60))):
        host = str(rng.choice(names))
        placed.setdefault(host, []).append(make(rand_pod(rng, f"b{j}", heavy=0.15)))
    pending = []
    for j in range(int(rng.integers(0, 6))):
        host = str(rng.choice(names + ["gone-host"]))
        pending.append((host, make(rand_pod(rng, f"p{j}", heavy=0.3))))
    if placed:
        # A pending entry whose bind already landed: skipped by uid.
        host, pods = next(iter(placed.items()))
        pending.append((host, pods[0]))
    ns_labels = dict(NAMESPACES) if rng.random() < 0.7 else None
    incoming = [make(rand_pod(rng, f"in{j}", heavy=0.7)) for j in range(6)]
    # A relisted copy of one incoming pod on a node never satisfies its
    # own terms.
    placed.setdefault(names[0], []).append(incoming[0])
    snap = snapshot(side, nodes, placed, ns_labels)
    out = []
    for pod in incoming:
        for pend in ((), pending):
            inter = side.aff.InterPodEvaluator.build(snap, pod, pending=pend)
            spread = side.aff.SpreadEvaluator.build(snap, pod, pending=pend)
            out.append((
                pod.name, inter.trivial, inter.has_preferences,
                spread.trivial, spread.has_soft, spread.has_hard,
                [
                    (ni.name, inter.feasible(ni), inter.required_affinity_feasible(ni),
                     inter.preference(ni), spread.feasible(ni), spread.score(ni))
                    for ni in snap.infos()
                ],
            ))
    return out


class TestEvaluatorParity:
    @pytest.mark.parametrize("seed", range(24))
    def test_every_node_equal(self, seed):
        got, want = evaluator_rows(PORT, seed), evaluator_rows(REF, seed)
        assert got == want

    def test_scripts_reach_every_verdict(self):
        """The seeded scripts exercise what the parity test compares: both
        verdicts of every check, nonzero preferences and spread scores."""
        seen = set()
        for seed in range(24):
            for row in evaluator_rows(PORT, seed):
                for _name, (ok, _), req_ok, pref, (sok, _), score in row[6]:
                    seen |= {("inter", ok), ("req", req_ok), ("spread", sok)}
                    seen |= {("pref", pref != 0), ("score", 0 < score < 100)}
        assert {(k, v) for k in ("inter", "req", "spread", "pref", "score")
                for v in (True, False)} <= seen

    @pytest.mark.parametrize(
        "case",
        ["first_pod", "keyless_bootstrap", "symmetry", "ns_selector_unknown",
         "match_label_keys", "min_domains"],
    )
    def test_named_rules(self, case):
        """One hand-made snapshot per rule of the module docstring, equal
        on both sides and as the rule says."""
        nodes = [{"name": "a", "zone": "z1", "rack": "r1"},
                 {"name": "b", "zone": "z1", "rack": None},
                 {"name": "c", "zone": "z2", "rack": "r2"}]
        web = {"key": ZONE, "sel": {"labels": {"app": "web"}}}
        bound: dict[str, list] = {}
        ns_labels = dict(NAMESPACES)
        if case == "first_pod":
            pod = {"name": "x", "labels": {"app": "web"}, "aff": [web]}
            want = [True, True, True]
        elif case == "keyless_bootstrap":
            pod = {"name": "x", "labels": {"app": "web"},
                   "aff": [{"key": RACK, "sel": {"labels": {"app": "web"}}}]}
            want = [True, False, True]
        elif case == "symmetry":
            bound = {"a": [{"name": "o", "labels": {"app": "db"}, "node": "a",
                            "anti": [{"key": ZONE, "sel": {"labels": {"app": "web"}}}]}]}
            pod = {"name": "x", "labels": {"app": "web"}}
            want = [False, False, True]
        elif case == "ns_selector_unknown":
            bound = {"c": [{"name": "o", "ns": "nowhere", "labels": {"app": "web"},
                            "node": "c"}]}
            sel = {"key": ZONE, "sel": {"labels": {"app": "web"}},
                   "ns_sel": {"labels": {"team": "b"}}}
            pod = {"name": "x", "labels": {"app": "db"}, "anti": [sel]}
            want = [True, True, False]  # unknown namespaces still repel
        elif case == "match_label_keys":
            bound = {"a": [{"name": f"o{i}", "labels": {"app": "web",
                                                        "pod-template-hash": "old"},
                            "node": "a"} for i in range(3)]}
            pod = {"name": "x", "labels": {"app": "web", "pod-template-hash": "new"},
                   "spread": [{"skew": 1, "key": ZONE, "when": "DoNotSchedule",
                               "sel": {"labels": {"app": "web"}},
                               "mlk": ["pod-template-hash"]}]}
            want = [True, True, True]  # the old rollout's replicas do not count
        else:
            bound = {"a": [{"name": "o", "labels": {"app": "web"}, "node": "a"}]}
            pod = {"name": "x", "labels": {"app": "web"},
                   "spread": [{"skew": 1, "key": ZONE, "when": "DoNotSchedule",
                               "sel": {"labels": {"app": "web"}}, "min_domains": 3}]}
            want = [False, False, True]  # global min is 0: z1 is at skew 2
        rows = {}
        for side in (REF, PORT):
            placed = {h: [side.pod(d) for d in ds] for h, ds in bound.items()}
            snap = snapshot(side, nodes, placed, ns_labels)
            incoming = side.pod(pod)
            inter = side.aff.InterPodEvaluator.build(snap, incoming)
            spread = side.aff.SpreadEvaluator.build(snap, incoming)
            rows[side.name] = [
                inter.feasible(ni)[0] and spread.feasible(ni)[0] for ni in snap.infos()
            ]
        assert rows["port"] == rows["ref"] == want


# --- whole stacks ---


def stack_fleet(seed: int, n: int = 24, zones: int = 3):
    rng = np.random.default_rng(seed)
    return [
        {"name": f"h{i:02d}", "zone": f"zone-{i % zones}",
         "rack": f"rack-{i // 4}" if rng.random() < 0.8 else None,
         "chips": 8 if i % 4 else 4}
        for i in range(n)
    ]


def singleton_script(seed: int, n_pods: int = 36):
    """Two waves of singleton pods with random terms (chips 1-4); the first
    wave also holds plain pods, whose cycles still build evaluators once a
    bound pod declares terms."""
    rng = np.random.default_rng(seed)
    waves = []
    for w in range(2):
        pods = []
        for j in range(n_pods // 2):
            heavy = 0.0 if (w == 0 and j % 3 == 0) else 0.45
            d = rand_pod(rng, f"w{w}-{j:02d}", heavy=heavy,
                         chips=int(rng.choice([1, 2, 2, 4])))
            if rng.random() < 0.5:
                d["ns"] = "default"
            pods.append(d)
        waves.append(pods)
    return waves


def gang_script(seed: int):
    """Plain gangs with self anti-affinity over hostname or rack and self
    affinity over zone (one of them too big for any zone: refused whole at
    admission), with singletons around them."""
    rng = np.random.default_rng(seed)
    pods = []

    def gang(name, size, chips, **terms):
        for m in range(size):
            labels = {"app": name, "tpu/gang": name, "tpu/gang-size": str(size),
                      "tpu/chips": str(chips)}
            pods.append({"name": f"{name}-{m}", "labels": labels, **terms})

    self_sel = lambda name, key: {"key": key, "sel": {"labels": {"app": name}}}  # noqa: E731
    spread_key = str(rng.choice([HOST, RACK]))
    gang("spread", int(rng.integers(3, 7)), 4, anti=[self_sel("spread", spread_key)])
    gang("pack", int(rng.integers(3, 6)), 8, aff=[self_sel("pack", ZONE)])
    gang("huge", 12, 8, aff=[self_sel("huge", ZONE)])
    gang("soft", 3, 2, panti=[(50, self_sel("soft", HOST))])
    for j in range(8):
        pods.append(rand_pod(rng, f"s{j}", ns="default", heavy=0.4,
                             chips=int(rng.choice([1, 2]))))
    order = rng.permutation(len(pods))
    return [[pods[i] for i in order]], spread_key


COUNTERS = (
    "dispatch_count", "burst_dispatches", "burst_served", "burst_invalidated",
    "admission_reuse", "admission_patched", "admission_rebuilds",
    "gang_burst_dispatches", "gang_burst_served", "joint_dispatches",
    "joint_gangs", "joint_parked", "fused_plan_dispatches", "plan_served",
    "plan_invalidated",
)


def run_stack(side: Side, hosts, waves, *, batch_requests=1, preemption=True,
              pre_bound=(), max_wall_s=3):
    """One script through one package's build_stack: Namespaces and Node
    objects first, then each wave, drained. A wave holds pod dicts and
    (kind, dict) items, applied in order: ("pvc" | "pv" | "pdb" |
    "namespace", object) puts the object, ("delete", pod) deletes the pod.
    Returns the observation."""
    kw = {"spec_enabled": False} if side is REF else {}
    build, config, agent_cls = (
        (ref_build_stack, RefConfig, RefAgent) if side is REF
        else (build_stack, SchedulerConfig, FakeTpuAgent)
    )
    stack = build(
        config=config(kernel_platform="cpu", batch_requests=batch_requests,
                      enable_preemption=preemption, gang_permit_timeout_s=5, **kw),
    )
    agent = agent_cls(stack.cluster)
    for ns, labels in NAMESPACES.items():
        stack.cluster.put_namespace(side.types.K8sNamespace(ns, dict(labels)))
    for h in hosts:
        stack.cluster.put_node(side.node(h))
        agent.add_host(h["name"], generation="v5e", chips=h["chips"])
    agent.publish_all()
    keys = {}
    for i, wave in enumerate([pre_bound, *waves]):
        for item in wave:
            if isinstance(item, tuple):
                kind, d = item
                if kind == "delete":
                    stack.cluster.delete_pod(f"{d.get('ns', 'default')}/{d['name']}")
                else:
                    getattr(stack.cluster, f"put_{kind}")(getattr(side, kind)(d))
                continue
            stack.cluster.create_pod(side.pod(item))
            keys[item["name"]] = f"{item.get('ns', 'default')}/{item['name']}"
        if i:
            stack.scheduler.run_until_idle(max_wall_s=max_wall_s)
    bindings, last = {}, {}
    for name, key in keys.items():
        pod = stack.cluster.get_pod(key)
        bindings[name] = "evicted" if pod is None else pod.node_name
    for r in stack.scheduler.stats.results:
        last[r.pod_key] = (r.outcome, r.node, r.message)
    (batch,) = stack.framework.batch_plugins
    return {
        "bindings": bindings,
        "last": last,
        "counters": {c: getattr(batch, c) for c in COUNTERS},
        "preempted": stack.preemption.preempted_total if stack.preemption else None,
        "waiting": len(stack.framework.waiting_pods()),
        "stack": stack,
    }


def both(hosts, waves, **kw):
    want = run_stack(REF, hosts, waves, **kw)
    got = run_stack(PORT, hosts, waves, **kw)
    for key in ("bindings", "last", "counters", "preempted", "waiting"):
        assert got[key] == want[key], key
    assert got["stack"].batch.dispatch_errors == 0
    return got


def check_invariants(got, hosts, waves):
    """Required terms hold in the port's final placement: no two pods that
    a bound pod's required anti-affinity separates share its domain, and
    no host holds more chips than it has."""
    stack = got["stack"]
    snap = stack.informer.snapshot()
    for h in hosts:
        assert stack.accountant.chips_in_use(h["name"]) <= h["chips"]
    for ni in snap.infos():
        for p in ni.pods:
            if not p.pod_anti_affinity:
                continue
            # Its required anti-affinity alone (required affinity may have
            # been met by the first-pod rule, which no longer applies).
            anti_only = dataclasses.replace(p, pod_affinity=(), uid=p.uid)
            ev = PORT.aff.InterPodEvaluator.build(snap, anti_only)
            ok, why = ev.feasible(ni)
            assert ok, (p.name, ni.name, why)


class TestStackParity:
    @pytest.mark.parametrize("batch_requests", [1, 16])
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_singletons(self, seed, batch_requests):
        hosts = stack_fleet(seed)
        waves = singleton_script(seed)
        got = both(hosts, waves, batch_requests=batch_requests)
        assert any(v for v in got["bindings"].values())
        check_invariants(got, hosts, waves)

    @pytest.mark.parametrize("batch_requests", [1, 16])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_gangs_with_self_terms(self, seed, batch_requests):
        hosts = stack_fleet(seed, n=20, zones=4)
        waves, spread_key = gang_script(seed)
        got = both(hosts, waves, batch_requests=batch_requests)
        b = got["bindings"]

        def members(g):
            return [v for k, v in b.items() if k.startswith(f"{g}-")]

        spread, pack = members("spread"), members("pack")
        assert all(spread) and all(pack) and not any(members("huge"))
        # One member per domain of the key; hosts without a rack label
        # belong to no domain.
        labels = {h["name"]: PORT.node(h).labels for h in hosts}
        domains = [labels[n][spread_key] for n in spread if spread_key in labels[n]]
        assert len(set(domains)) == len(domains)
        zone_of = {h["name"]: h["zone"] for h in hosts}
        assert len({zone_of[n] for n in pack}) == 1
        huge = [r for k, r in got["last"].items() if k.startswith("default/huge-")]
        assert all("slots are free" in r[2] for r in huge)
        assert got["waiting"] == 0

    @pytest.mark.parametrize("seed", [4, 5])
    def test_preemption_keeps_required_affinity(self, seed):
        """A full fleet: a higher-priority pod with required affinity to a
        zone preempts only inside that zone."""
        hosts = stack_fleet(seed, n=8, zones=2)
        fill = [{"name": f"f{i}", "labels": {"tpu/chips": str(h["chips"]),
                                              "tpu/priority": "1", "app": "fill"},
                 "node_selector": {HOST: h["name"]}} for i, h in enumerate(hosts)]
        want_zone = hosts[1]["zone"]
        hi = {"name": "hi", "labels": {"tpu/chips": "4", "tpu/priority": "9",
                                        "app": "hi"},
              "aff": [{"key": ZONE, "sel": {"labels": {"app": "anchor"}}}]}
        # Another scheduler's chip-free pod: never a victim.
        anchor = {"name": "anchor", "labels": {"app": "anchor"},
                  "scheduler": "default-scheduler", "node": hosts[1]["name"]}
        got = both(hosts, [fill, [hi]], pre_bound=[anchor])
        zone_of = {h["name"]: h["zone"] for h in hosts}
        assert got["bindings"]["hi"] is not None
        assert zone_of[got["bindings"]["hi"]] == want_zone
        evicted = [k for k, v in got["bindings"].items() if v == "evicted"]
        assert evicted and all(zone_of[hosts[int(k[1:])]["name"]] == want_zone
                               for k in evicted)


# --- the two faults, pinned ---


def three_hosts():
    return [{"name": f"h{i}", "zone": "z", "chips": 8} for i in range(3)]


class TestFaultsPinned:
    def test_anti_affinity_replicas_bind_one_per_host(self):
        """Three replicas of one Deployment with required anti-affinity
        over hostname on three hosts: the reference binds one per host; the
        port used to park all three as unresolvable."""
        term = {"key": HOST, "sel": {"labels": {"app": "web"}}}
        pods = [{"name": f"web-{i}", "labels": {"app": "web", "tpu/chips": "2"},
                 "anti": [term]} for i in range(3)]
        got = both(three_hosts(), [pods])
        assert got["bindings"] == {"web-0": "h2", "web-1": "h1", "web-2": "h0"}

    def test_one_bound_anti_affinity_pod_blocks_nothing(self):
        """One Running pod with required anti-affinity on h0, then four
        plain pods of 2 chips: the reference binds all four; the port used
        to bind none ("bound pods declare inter-pod affinity terms")."""
        term = {"key": HOST, "sel": {"labels": {"app": "web"}}}
        anti = {"name": "anti", "labels": {"app": "web", "tpu/chips": "8"},
                "anti": [term], "node": "h0"}
        pods = [{"name": f"p{i}", "labels": {"tpu/chips": "2"}} for i in range(4)]
        got = both(three_hosts(), [pods], pre_bound=[anti])
        assert got["bindings"] == {"anti": "h0", "p0": "h2", "p1": "h2",
                                   "p2": "h2", "p3": "h2"}


class TestAdmissionCache:
    @pytest.mark.parametrize("batch_requests", [1, 16])
    def test_affinity_pods_never_read_a_cached_row(self, batch_requests):
        """Plain pods warm the cross-snapshot admission cache; then
        anti-affinity replicas arrive one per cycle. Each must see the
        replicas bound before it (a cached row would stack them on the
        best host), and none of their cycles may count as a cache read."""
        hosts = [{"name": f"h{i}", "zone": f"z{i % 2}", "chips": 8} for i in range(4)]
        plain = [{"name": f"p{i}", "labels": {"tpu/chips": "1"}} for i in range(4)]
        term = {"key": HOST, "sel": {"labels": {"app": "web"}}}
        replicas = [[{"name": f"web-{i}", "labels": {"app": "web", "tpu/chips": "1"},
                      "anti": [term]}] for i in range(4)]
        plain_only = run_stack(PORT, hosts, [plain], batch_requests=batch_requests)
        got = both(hosts, [plain, *replicas], batch_requests=batch_requests)
        webs = [got["bindings"][f"web-{i}"] for i in range(4)]
        assert len(set(webs)) == 4
        # Every admission-cache read or rebuild came from a plain pod.
        for c in ("admission_reuse", "admission_patched", "admission_rebuilds"):
            assert got["counters"][c] == plain_only["counters"][c]


class TestRunG:
    def test_small_run_g_holds_on_cpu(self):
        """chip_smoke's run (g) at 160 hosts on the plain version: every
        placement fact its card run asserts holds here too."""
        from chip_smoke import AFFINITY_SMALL, check_affinity_run, run_affinity

        run = run_affinity("cpu", AFFINITY_SMALL)
        check_affinity_run(run, AFFINITY_SMALL)
        assert run["launches"] == 0 and run["fleet_calls"] == run["dispatch_count"]
