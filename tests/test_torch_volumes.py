"""The port's volume awareness, attach limits and PodDisruptionBudgets
(yoda_tpu_torch/plugins/yoda/filter_plugin.py, preemption.py and the
FakeCluster / informer stores behind them) held against the JAX package's
on the CPU, tolerance 0.

- Predicates: seeded snapshots of claims and volumes (zone labels, the
  selected-node annotation, ReadWriteOnce co-location, ReadWriteOncePod,
  PV nodeAffinity over zone and hostname, CSI attach limits) with bound
  users and Permit-parked placements. The PreFilter's status and every
  node's ``AffinityData.feasible`` / ``volumes_feasible`` must be equal,
  and so must preemption's attach guards (``_attach_possible``,
  ``_fits_attach_after``) on every node.
- Whole stacks: seeded volume pods (singletons and gangs) through both
  packages' build_stack; a claim or Namespace that appears reactivates a
  parked pod.
- Budgets: ``K8sPdb`` arithmetic and selectors, FakeCluster's eviction
  check, and budget-aware preemption as tests/test_preemption.py's
  TestPdbAwarePreemption and TestPdbFakeEnforcement hold the reference
  (batch mode).

Scripts are plain dicts built into each package's objects by
test_torch_affinity.Side."""

import numpy as np
import pytest

import yoda_tpu.cluster.fake as ref_fake
import yoda_tpu.framework.cyclestate as ref_cs
import yoda_tpu.plugins.yoda.filter_plugin as ref_fp
import yoda_tpu.plugins.yoda.preemption as ref_pre
import yoda_tpu_torch.cluster.fake as port_fake
import yoda_tpu_torch.framework.cyclestate as port_cs
import yoda_tpu_torch.plugins.yoda.filter_plugin as port_fp
import yoda_tpu_torch.plugins.yoda.preemption as port_pre
from test_torch_affinity import HOST, PORT, REF, ZONE, both, stack_fleet

DRIVERS = ("drv-a", "drv-b")
MODES = ([], ["ReadWriteOnce"], ["ReadWriteOncePod"], ["ReadWriteMany"],
         ["ReadWriteOnce", "ReadWriteMany"])
MODULES = {"ref": (ref_fp, ref_cs, ref_pre, ref_fake),
           "port": (port_fp, port_cs, port_pre, port_fake)}


# --- predicates over seeded snapshots ---


def volume_world(seed: int):
    """Plain dicts: nodes over 3 zones (some with attach limits), PVs,
    claims, bound pods using them, parked placements and incoming pods."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(int(rng.integers(8, 25))):
        attach = {}
        if rng.random() < 0.4:
            attach[f"csi-{DRIVERS[0]}"] = int(rng.integers(1, 3))
        if rng.random() < 0.2:
            attach[DRIVERS[1]] = 1
        nodes.append({"name": f"n{i:02d}", "zone": f"z{int(rng.integers(0, 3))}",
                      "attach": attach})
    names = [h["name"] for h in nodes]
    pvs, pvcs = [], []
    for j in range(int(rng.integers(6, 16))):
        pv = {"name": f"vol-{j}"}
        u = rng.random()
        if u < 0.3:
            pv["affinity"] = [[(ZONE, "In", [f"z{int(rng.integers(0, 3))}"])]]
        elif u < 0.4:
            pv["affinity"] = [[(HOST, "In", [str(rng.choice(names))])],
                              [(ZONE, "In", ["z2"])]]
        if rng.random() < 0.6:
            pv["driver"] = str(rng.choice(DRIVERS))
        pvs.append(pv)
    for j in range(int(rng.integers(6, 18))):
        c = {"name": f"c{j}", "ns": str(rng.choice(["default", "default", "team-b"])),
             "modes": MODES[int(rng.integers(0, len(MODES)))]}
        if rng.random() < 0.2:
            c["selected_node"] = str(rng.choice(names))
        if rng.random() < 0.3:
            c["zone"] = f"z{int(rng.integers(0, 3))}"
        if rng.random() < 0.7:
            c["volume"] = f"vol-{int(rng.integers(0, 18))}"  # some unresolved
        pvcs.append(c)
    claims_of = {"default": [c["name"] for c in pvcs if c["ns"] == "default"],
                 "team-b": [c["name"] for c in pvcs if c["ns"] == "team-b"]}

    def user(name, ns=None):
        ns = ns or str(rng.choice(["default", "team-b"]))
        own = claims_of[ns] + ["missing"] * (rng.random() < 0.1)
        k = int(rng.integers(1, 3))
        picks = [str(x) for x in rng.choice(own, size=min(k, len(own)), replace=False)] \
            if own else []
        return {"name": name, "ns": ns, "labels": {"tpu/chips": "1",
                "tpu/priority": str(int(rng.integers(0, 3)))}, "pvcs": picks}

    bound = [(str(rng.choice(names)), user(f"b{j}")) for j in range(int(rng.integers(4, 14)))]
    pending = [(str(rng.choice(names)), user(f"p{j}")) for j in range(int(rng.integers(0, 4)))]
    incoming = [user(f"in{j}") for j in range(6)]
    return {"nodes": nodes, "pvs": pvs, "pvcs": pvcs, "bound": bound,
            "pending": pending, "incoming": incoming,
            "watch_pvs": rng.random() < 0.8, "watch_pvcs": rng.random() < 0.9}


def predicate_rows(side, seed: int):
    fp, cs, pre_mod, _fake = MODULES[side.name]
    w = volume_world(seed)
    placed: dict[str, list] = {}
    for host, d in w["bound"]:
        d = dict(d, node=host)
        placed.setdefault(host, []).append(side.pod(d))
    pending = [(host, side.pod(d)) for host, d in w["pending"]]
    infos = {
        h["name"]: side.interfaces.NodeInfo(
            name=h["name"], pods=placed.get(h["name"], []), node=side.node(h)
        )
        for h in w["nodes"]
    }
    snap = side.interfaces.Snapshot(
        infos, version=1,
        pvcs={f"{c['ns']}/{c['name']}": side.pvc(c) for c in w["pvcs"]}
        if w["watch_pvcs"] else None,
        pvs={v["name"]: side.pv(v) for v in w["pvs"]} if w["watch_pvs"] else None,
    )
    prefilter = fp.YodaPreFilter(pending_fn=lambda: pending)
    preemption = pre_mod.TpuPreemption(lambda key: True)
    out = []
    for d in w["incoming"]:
        pod = side.pod(d)
        state = cs.CycleState()
        st = prefilter.pre_filter(state, pod, snap)
        row = [d["name"], st.code.value, st.message]
        aff = fp.get_affinity(state) if st.success else None
        if aff is not None:
            req = fp.get_request(state)
            row.append([
                (ni.name, aff.feasible(ni), aff.volumes_feasible(ni),
                 preemption._attach_possible(ni, req, aff),
                 [preemption._fits_attach_after(ni, vs[:k], aff)
                  for vs in [preemption._victims_on(ni, 9)]
                  for k in range(len(vs) + 1)])
                for ni in snap.infos()
            ])
            row.append(sorted(
                (rc.pvc.key, sorted(rc.allowed_nodes or ()), rc.allowed_nodes is None,
                 rc.pv.name if rc.pv else None)
                for rc in aff.pvcs
            ))
            row.append((aff.pv_volumes, sorted((aff.pending_volumes or {}).items())))
        out.append(row)
    return out


class TestVolumePredicateParity:
    @pytest.mark.parametrize("seed", range(20))
    def test_every_node_equal(self, seed):
        assert predicate_rows(PORT, seed) == predicate_rows(REF, seed)

    def test_scripts_reach_every_verdict(self):
        """The seeded worlds reach a missing claim, a parked pod's claim,
        both volume verdicts and both attach verdicts."""
        statuses, verdicts = set(), set()
        for seed in range(20):
            for row in predicate_rows(PORT, seed):
                statuses.add(row[1])
                for _n, (ok, why), (vok, _), possible, _after in row[3] if len(row) > 3 else ():
                    verdicts |= {("all", ok), ("vol", vok), ("attach", possible)}
                    if not ok and vok:
                        verdicts.add(("attach-or-rwo", "limit" in why))
        assert {"Success", "UnschedulableAndUnresolvable"} <= statuses
        assert {("all", True), ("all", False), ("vol", True), ("vol", False),
                ("attach", True), ("attach", False),
                ("attach-or-rwo", True)} <= verdicts


# --- whole stacks ---


def volume_stack_script(seed: int, hosts):
    """Claims pinned by zone, selected node and PV affinity, RWO claims
    shared by several pods, RWOP claims, CSI volumes against attach limits,
    a gang whose members bring distinct volumes, and plain pods."""
    rng = np.random.default_rng(seed)
    names = [h["name"] for h in hosts]
    objs, pods = [], []
    for j in range(10):
        pv = {"name": f"vol-{j}", "driver": DRIVERS[j % 2]}
        if j % 3 == 0:
            pv["affinity"] = [[(ZONE, "In", [hosts[j % len(hosts)]["zone"]])]]
        objs.append(("pv", pv))
        objs.append(("pvc", {"name": f"data-{j}", "volume": f"vol-{j}",
                             "modes": ["ReadWriteOnce"] if j % 4 == 1 else []}))
    for j in range(4):
        objs.append(("pvc", {"name": f"zonal-{j}", "zone": hosts[j]["zone"]}))
        objs.append(("pvc", {"name": f"pinned-{j}", "selected_node": str(rng.choice(names))}))
    objs.append(("pvc", {"name": "solo", "modes": ["ReadWriteOncePod"]}))
    for i in range(24):
        u = rng.random()
        if u < 0.35:
            claims = [f"data-{int(rng.integers(0, 10))}"]
        elif u < 0.55:
            claims = [f"zonal-{int(rng.integers(0, 4))}"]
        elif u < 0.7:
            claims = [f"pinned-{int(rng.integers(0, 4))}"]
        elif u < 0.78:
            claims = ["solo"]
        else:
            claims = []
        pods.append({"name": f"v{i:02d}", "labels": {"tpu/chips": str(int(rng.choice([1, 2, 4])))},
                     "pvcs": claims})
    for m in range(3):
        pods.append({"name": f"vg-{m}", "labels": {"tpu/gang": "vg", "tpu/gang-size": "3",
                                                   "tpu/chips": "2"},
                     "pvcs": [f"data-{m + 6}"]})
    order = rng.permutation(len(pods))
    return [objs + [pods[i] for i in order]]


def attach_hosts(seed: int):
    hosts = stack_fleet(seed, n=12, zones=3)
    for i, h in enumerate(hosts):
        if i % 3 == 0:
            h["attach"] = {f"csi-{DRIVERS[0]}": 1, DRIVERS[1]: 2}
    return hosts


class TestVolumeStackParity:
    @pytest.mark.parametrize("batch_requests", [1, 16])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_volume_pods(self, seed, batch_requests):
        hosts = attach_hosts(seed)
        got = both(hosts, volume_stack_script(seed, hosts), batch_requests=batch_requests)
        stack = got["stack"]
        snap = stack.informer.snapshot()
        # Every bound volume pod sits where its claims allow and no node is
        # past an attach limit.
        for ni in snap.infos():
            for p in ni.pods:
                if p.pvc_names:
                    claims, missing = port_fp.resolve_volumes(snap, p)
                    assert missing is None or "ReadWriteOncePod" in missing
                    claims = [c for c in claims if c.allowed_nodes is None]
                    assert port_fp.node_fits_volumes(claims, ni)[0], (p.name, ni.name)
            ok, why = port_fp.node_fits_attach_limits((), ni, snap.pvcs, snap.pvs)
            assert ok, why
        assert sum(v is not None for v in got["bindings"].values()) > 10

    @pytest.mark.parametrize("kind", ["pvc", "pv", "namespace"])
    def test_appearing_object_reactivates_parked_pod(self, kind):
        """A pod parked on a missing claim, on a claim zone the PV will
        overrule, or on a namespaceSelector whose Namespace is not known
        yet binds once that object arrives."""
        hosts = stack_fleet(0, n=6, zones=2)
        z1 = [h for h in hosts if h["zone"] == "zone-1"]
        if kind == "pvc":
            first = [{"name": "w", "labels": {"tpu/chips": "1"}, "pvcs": ["late"]}]
            later = [("pvc", {"name": "late", "zone": "zone-1"})]
        elif kind == "pv":
            # The claim's zone names no host; its PV (once seen) pins zone-1.
            first = [("pvc", {"name": "c", "zone": "zone-9", "volume": "vol"}),
                     {"name": "w", "labels": {"tpu/chips": "1"}, "pvcs": ["c"]}]
            later = [("pv", {"name": "vol", "affinity": [[(ZONE, "In", ["zone-1"])]]})]
        else:
            first = [{"name": "db", "ns": "fresh", "labels": {"app": "db"},
                      "scheduler": "default-scheduler", "node": z1[0]["name"]},
                     {"name": "w", "labels": {"tpu/chips": "1", "app": "web"},
                      "aff": [{"key": ZONE, "sel": {"labels": {"app": "db"}},
                               "ns_sel": {"labels": {"team": "fresh"}}}]}]
            later = [("namespace", {"name": "fresh", "labels": {"team": "fresh"}})]
        got = both(hosts, [first, later])
        node = got["bindings"]["w"]
        assert node in {h["name"] for h in z1}
        outcomes = [r for k, r in got["last"].items() if k == "default/w"]
        assert outcomes[0][0] == "bound"

    def test_gang_siblings_cannot_overcommit_attachments(self):
        """A Permit-parked sibling's volume counts against the limit: a
        2-member gang with distinct volumes against one 1-slot node binds
        nothing (reference TestAttachLimitsEdge)."""
        hosts = [{"name": "v5e-0", "zone": "z", "chips": 8,
                  "attach": {f"csi-{DRIVERS[0]}": 1}}]
        objs = [("pv", {"name": f"vol-{i}", "driver": DRIVERS[0]}) for i in range(2)]
        objs += [("pvc", {"name": f"d{i}", "volume": f"vol-{i}"}) for i in range(2)]
        pods = [{"name": f"g{i}", "labels": {"tpu/gang": "vg", "tpu/gang-size": "2",
                                             "tpu/chips": "1"}, "pvcs": [f"d{i}"]}
                for i in range(2)]
        got = both(hosts, [objs + pods], preemption=False, max_wall_s=1)
        assert got["bindings"] == {"g0": None, "g1": None}

    def test_preemption_evicts_volume_holder_not_chip_pods(self):
        """Attach pressure is curable only by evicting the volume's holder:
        with a non-evictable holder the chip pod is spared; once the holder
        is gone the pod binds (reference TestAttachLimitsEdge)."""
        hosts = [{"name": "v5e-0", "zone": "z", "chips": 8,
                  "attach": {f"csi-{DRIVERS[0]}": 1}}]
        objs = [("pv", {"name": "vol-h", "driver": DRIVERS[0]}),
                ("pvc", {"name": "held", "volume": "vol-h"}),
                ("pv", {"name": "vol-m", "driver": DRIVERS[0]}),
                ("pvc", {"name": "mine", "volume": "vol-m"})]
        holder = {"name": "holder", "labels": {"tpu/chips": "1", "tpu/priority": "9"},
                  "pvcs": ["held"]}
        chips = {"name": "chips", "labels": {"tpu/chips": "1", "tpu/priority": "1"}}
        wants = {"name": "wants-vol", "labels": {"tpu/chips": "1", "tpu/priority": "5"},
                 "pvcs": ["mine"]}
        got = both(hosts, [objs + [holder, chips], [wants]])
        assert got["bindings"]["chips"] == "v5e-0"
        assert got["bindings"]["wants-vol"] is None and got["preempted"] == 0
        got = both(hosts, [objs + [holder, chips], [wants], [("delete", holder)]])
        assert got["bindings"]["wants-vol"] == "v5e-0"


    def test_attach_pressure_buys_the_holder(self):
        """Chips are free but the attach limit is saturated by an evictable
        holder: victims are bought, in eviction order, until the limit fits
        (a lower-priority chip pod goes first), and the pod binds."""
        hosts = [{"name": "v5e-0", "zone": "z", "chips": 8,
                  "attach": {f"csi-{DRIVERS[0]}": 1}}]
        objs = [("pv", {"name": "vol-h", "driver": DRIVERS[0]}),
                ("pvc", {"name": "held", "volume": "vol-h"}),
                ("pv", {"name": "vol-m", "driver": DRIVERS[0]}),
                ("pvc", {"name": "mine", "volume": "vol-m"})]
        holder = {"name": "holder", "labels": {"tpu/chips": "1", "tpu/priority": "1"},
                  "pvcs": ["held"]}
        chips = {"name": "chips", "labels": {"tpu/chips": "1", "tpu/priority": "0"}}
        wants = {"name": "wants-vol", "labels": {"tpu/chips": "1", "tpu/priority": "5"},
                 "pvcs": ["mine"]}
        got = both(hosts, [objs + [holder, chips], [wants]])
        assert got["bindings"] == {"holder": "evicted", "chips": "evicted",
                                   "wants-vol": "v5e-0"}
        assert got["preempted"] == 2


# --- PodDisruptionBudgets ---


PDB_MATH = [
    (dict(allowed=2), 9, 2),
    (dict(min_available=3), 5, 2),
    (dict(min_available=5), 5, 0),
    (dict(min_available="50%"), 5, 2),
    (dict(max_unavailable="50%"), 5, 2),
    (dict(max_unavailable=1), 4, 1),
    (dict(min_available=1, allowed=0), 10, 0),
    (dict(max_unavailable=9), 3, 3),
    (dict(), 4, 4),
]


class TestPdbModel:
    @pytest.mark.parametrize("spec,matching,want", PDB_MATH)
    def test_allowed_disruptions(self, spec, matching, want):
        d = {"name": "b", "sel": {}, **spec}
        assert PORT.pdb(d).allowed_disruptions(matching) == want
        assert REF.pdb(d).allowed_disruptions(matching) == want

    @pytest.mark.parametrize(
        "sel,ns,labels,want",
        [
            ({"labels": {"app": "db"}}, "default", {"app": "db"}, True),
            ({"labels": {"app": "web"}}, "default", {"app": "db"}, False),
            ({}, "default", {"app": "db"}, True),  # empty selector: all pods
            (None, "default", {"app": "db"}, False),  # absent: none
            ({"labels": {"app": "db"}}, "prod", {"app": "db"}, False),
        ],
    )
    def test_selector_semantics(self, sel, ns, labels, want):
        for side in (PORT, REF):
            pdb = side.pdb({"name": "m", "sel": sel})
            assert pdb.matches(side.pod({"name": "p", "ns": ns, "labels": labels})) is want

    def test_published_status_decrements_across_evictions(self):
        """A published disruptionsAllowed=1 admits ONE eviction and refuses
        the second until the controller republishes (reference
        TestPdbFakeEnforcement)."""
        seen = {}
        for side in (REF, PORT):
            cluster = MODULES[side.name][3].FakeCluster()
            for i in range(2):
                pod = side.pod({"name": f"db-{i}", "labels": {"app": "db"}})
                cluster.create_pod(pod)
                cluster.bind_pod(pod.key, "n1")
            pdb = side.pdb({"name": "db", "sel": {"labels": {"app": "db"}}, "allowed": 1})
            cluster.put_pdb(pdb)
            got = [cluster.evict_pod("default/db-0"), cluster.evict_pod("default/db-1")]
            cluster.put_pdb(pdb)  # the controller republishes
            got.append(cluster.evict_pod("default/db-1"))
            seen[side.name] = got
        assert seen["port"] == seen["ref"] == [True, False, True]

    def test_pending_pods_protect_nothing(self):
        """Only bound pods count toward a derived budget."""
        seen = {}
        for side in (REF, PORT):
            cluster = MODULES[side.name][3].FakeCluster()
            for i in range(3):
                pod = side.pod({"name": f"db-{i}", "labels": {"app": "db"}})
                cluster.create_pod(pod)
                if i == 0:
                    cluster.bind_pod(pod.key, "n1")
            cluster.put_pdb(side.pdb({"name": "db", "sel": {"labels": {"app": "db"}},
                                      "min_available": 1}))
            seen[side.name] = cluster.evict_pod("default/db-0")
        assert seen["port"] is seen["ref"] is False


def pinned(name, host, priority, **labels):
    return {"name": name, "labels": {"tpu/chips": "2", "tpu/priority": str(priority),
                                     **labels},
            "node_selector": {HOST: host}}


class TestPdbAwarePreemption:
    """Victim sets that violate no budget win, across nodes and within a
    node's eviction order; with only protected victims the eviction is
    attempted and refused (reference TestPdbAwarePreemption, batch mode)."""

    HOSTS2 = [{"name": "host-a", "zone": "z", "chips": 2},
              {"name": "host-b", "zone": "z", "chips": 2}]

    def test_routes_around_pdb_protected_cheapest_victim(self):
        waves = [
            [pinned("cheap", "host-a", 1), pinned("pricey", "host-b", 3)],
            [("pdb", {"name": "protect-cheap", "sel": {"labels": {"tpu/priority": "1"}},
                      "min_available": 1}),
             {"name": "train", "labels": {"tpu/chips": "2", "tpu/priority": "9"}}],
        ]
        got = both(self.HOSTS2, waves)
        assert got["bindings"] == {"cheap": "host-a", "pricey": "evicted",
                                   "train": "host-b"}

    def test_defers_protected_victim_within_node(self):
        hosts = [{"name": "host", "zone": "z", "chips": 4}]
        waves = [
            [{"name": "guarded", "labels": {"tpu/chips": "2", "tpu/priority": "1",
                                            "app": "db"}},
             {"name": "plain", "labels": {"tpu/chips": "2", "tpu/priority": "2"}}],
            [("pdb", {"name": "db", "sel": {"labels": {"app": "db"}}, "min_available": 1}),
             {"name": "train", "labels": {"tpu/chips": "2", "tpu/priority": "9"}}],
        ]
        got = both(hosts, waves)
        assert got["bindings"] == {"guarded": "host", "plain": "evicted", "train": "host"}

    def test_exhausted_budget_still_attempted_as_last_resort(self):
        hosts = [{"name": "host", "zone": "z", "chips": 2}]
        waves = [
            [{"name": "guarded", "labels": {"tpu/chips": "2", "tpu/priority": "1",
                                            "app": "db"}}],
            [("pdb", {"name": "db", "sel": {"labels": {"app": "db"}}, "min_available": 1}),
             {"name": "train", "labels": {"tpu/chips": "2", "tpu/priority": "9"}}],
        ]
        got = both(hosts, waves)
        assert got["bindings"] == {"guarded": "host", "train": None}
        assert got["preempted"] == 0

    @pytest.mark.parametrize("allowed", [0, 1, 3])
    def test_gang_slots_bought_around_budgets(self, allowed):
        """A plain gang buys member slots; a budget on half the victims
        decides which hosts sell them."""
        hosts = [{"name": f"h{i}", "zone": "z", "chips": 2} for i in range(4)]
        fill = [pinned(f"f{i}", f"h{i}", 1, app="db" if i % 2 else "batch")
                for i in range(4)]
        gang = [{"name": f"g{m}", "labels": {"tpu/gang": "g", "tpu/gang-size": "2",
                                             "tpu/chips": "2", "tpu/priority": "9"}}
                for m in range(2)]
        waves = [fill, [("pdb", {"name": "db", "sel": {"labels": {"app": "db"}},
                                 "allowed": allowed}), *gang]]
        got = both(hosts, waves)
        evicted = sorted(k for k, v in got["bindings"].items() if v == "evicted")
        # Two hosts are bought; no more protected pods go than the budget
        # allows.
        assert len(evicted) == 2
        assert sum(int(k[1:]) % 2 for k in evicted) <= allowed
        freed = {f"h{k[1:]}" for k in evicted}
        assert {got["bindings"]["g0"], got["bindings"]["g1"]} == freed
