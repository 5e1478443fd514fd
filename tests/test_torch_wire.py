"""The port's API-server wire format (``to_obj`` / ``from_obj`` in
yoda_tpu_torch/api/types.py and api/affinity.py, the container-spec parsers
behind them and the v1.Pod affinity / spread parsers), held against
yoda_tpu, tolerance 0.

Every pair is driven by API objects drawn from a numpy seed (names,
labels, quantities in every notation the parsers accept, a few they
reject, optional blocks present or absent): both packages parse the same
dict into equal dataclasses, emit identical dicts from them, and give
equal dataclasses after a full round trip.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import yoda_tpu.api.affinity as ref_aff
import yoda_tpu.api.types as ref_types
import yoda_tpu_torch.api.affinity as port_aff
import yoda_tpu_torch.api.types as port_types

SEEDS = range(4)
OPS = ("In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt")
CPUS = ("100m", "500m", "2", "1.5", "0.25", "3000m", "x1")
MEMS = ("1Gi", "512Mi", "1000", "2G", "64Ki", "1.5Gi", "lots")
TPUS = ("1", "4", "8", "1k", "1Ki", "2.5", None)


def plain(obj):
    """A dataclass (nested ones, tuples and lists included) as plain data
    with its class name, so objects of the two packages compare."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, {
            f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        })
    if isinstance(obj, (list, tuple)):
        return type(obj).__name__, [plain(x) for x in obj]
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    return obj


class Draw:
    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def coin(self, p: float = 0.5) -> bool:
        return bool(self.rng.random() < p)

    def pick(self, seq):
        return seq[int(self.rng.integers(len(seq)))]

    def int(self, lo: int, hi: int) -> int:
        return int(self.rng.integers(lo, hi))

    def name(self, prefix: str = "o") -> str:
        return f"{prefix}-{self.int(0, 10_000)}"

    def labels(self, n: "int | None" = None) -> dict:
        n = self.int(0, 4) if n is None else n
        return {f"k{self.int(0, 6)}": f"v{self.int(0, 4)}" for _ in range(n)}

    def requirement(self) -> dict:
        op = self.pick(OPS)
        out = {"key": f"k{self.int(0, 6)}", "operator": op}
        if op in ("In", "NotIn"):
            out["values"] = [f"v{self.int(0, 4)}" for _ in range(self.int(1, 3))]
        elif op in ("Gt", "Lt"):
            out["values"] = [str(self.int(0, 100))]
        return out

    def term(self) -> dict:
        out = {}
        if self.coin(0.8):
            out["matchExpressions"] = [self.requirement() for _ in range(self.int(1, 3))]
        if self.coin(0.3):
            out["matchFields"] = [{"key": "metadata.name", "operator": "In",
                                   "values": [self.name("node")]}]
        return out

    def selector(self) -> "dict | None":
        if self.coin(0.15):
            return None
        out = {}
        if self.coin(0.7):
            out["matchLabels"] = self.labels(self.int(1, 3))
        if self.coin(0.4):
            out["matchExpressions"] = [self.requirement() for _ in range(self.int(1, 3))]
        return out

    def toleration(self) -> dict:
        op = self.pick(("Equal", "Exists"))
        out = {"operator": op}
        if self.coin(0.8):
            out["key"] = f"taint{self.int(0, 3)}"
        if op == "Equal":
            out["value"] = f"v{self.int(0, 3)}"
        if self.coin(0.6):
            out["effect"] = self.pick(("NoSchedule", "PreferNoSchedule", "NoExecute"))
        return out

    def pod_affinity_term(self) -> dict:
        out = {"topologyKey": self.pick(("kubernetes.io/hostname",
                                         "topology.kubernetes.io/zone"))}
        sel = self.selector()
        if sel is not None:
            out["labelSelector"] = sel
        if self.coin(0.3):
            out["namespaces"] = [f"ns{self.int(0, 3)}" for _ in range(self.int(1, 3))]
        if self.coin(0.3):
            out["namespaceSelector"] = self.selector() or {}
        return out

    def spread(self) -> dict:
        out = {"maxSkew": self.int(1, 4),
               "topologyKey": self.pick(("kubernetes.io/hostname",
                                         "topology.kubernetes.io/zone")),
               "whenUnsatisfiable": self.pick(("DoNotSchedule", "ScheduleAnyway"))}
        sel = self.selector()
        if sel is not None:
            out["labelSelector"] = sel
        if self.coin(0.3):
            out["matchLabelKeys"] = ["pod-template-hash"]
        if self.coin(0.3):
            out["minDomains"] = self.int(1, 5)
        return out

    def resources(self) -> dict:
        out = {}
        for part in ("requests", "limits"):
            block = {}
            if self.coin(0.6):
                block["cpu"] = self.pick(CPUS)
            if self.coin(0.6):
                block["memory"] = self.pick(MEMS)
            if part == "limits" and self.coin(0.5):
                tpu = self.pick(TPUS)
                if tpu is not None:
                    block["google.com/tpu"] = tpu
            if block:
                out[part] = block
        return out

    def container(self, init: bool = False) -> dict:
        out = {"name": self.name("c"), "resources": self.resources()}
        if self.coin(0.6):
            out["image"] = f"gcr.io/img{self.int(0, 5)}:{self.int(0, 3)}"
        if self.coin(0.3):
            out["ports"] = [{"containerPort": 80,
                             **({"hostPort": self.int(1, 9000)} if self.coin(0.8) else {}),
                             **({"protocol": self.pick(("TCP", "UDP"))}
                                if self.coin() else {}),
                             **({"hostIP": "10.0.0.1"} if self.coin(0.3) else {})}
                            for _ in range(self.int(1, 3))]
        if init and self.coin():
            out["restartPolicy"] = "Always"
        return out

    def pod_spec(self) -> dict:
        spec = {"schedulerName": self.pick(("yoda-tpu", "default-scheduler")),
                "nodeName": self.name("node") if self.coin(0.3) else None,
                "containers": [self.container() for _ in range(self.int(0, 3))]}
        if self.coin(0.4):
            spec["initContainers"] = [self.container(True) for _ in range(self.int(1, 3))]
        if self.coin(0.3):
            spec["overhead"] = {"cpu": self.pick(CPUS[:3]), "memory": self.pick(MEMS[:3])}
        if self.coin(0.4):
            spec["tolerations"] = [self.toleration() for _ in range(self.int(1, 3))]
        if self.coin(0.4):
            spec["nodeSelector"] = self.labels(self.int(1, 3))
        affinity = {}
        if self.coin(0.4):
            na = {}
            if self.coin(0.7):
                na["requiredDuringSchedulingIgnoredDuringExecution"] = {
                    "nodeSelectorTerms": [self.term() for _ in range(self.int(1, 3))]}
            if self.coin(0.5):
                na["preferredDuringSchedulingIgnoredDuringExecution"] = [
                    {"weight": self.int(1, 100), "preference": self.term()}
                    for _ in range(self.int(1, 3))]
            affinity["nodeAffinity"] = na
        for key in ("podAffinity", "podAntiAffinity"):
            if self.coin(0.4):
                block = {}
                if self.coin(0.7):
                    block["requiredDuringSchedulingIgnoredDuringExecution"] = [
                        self.pod_affinity_term() for _ in range(self.int(1, 3))]
                if self.coin(0.5):
                    block["preferredDuringSchedulingIgnoredDuringExecution"] = [
                        {"weight": self.int(1, 100),
                         "podAffinityTerm": self.pod_affinity_term()}
                        for _ in range(self.int(1, 3))]
                affinity[key] = block
        if affinity:
            spec["affinity"] = affinity
        if self.coin(0.3):
            spec["topologySpreadConstraints"] = [self.spread()
                                                 for _ in range(self.int(1, 3))]
        if self.coin(0.3):
            spec["priority"] = self.int(-5, 100)
        if self.coin(0.2):
            spec["preemptionPolicy"] = "Never"
        if self.coin(0.2):
            spec["schedulingGates"] = [{"name": f"gate{i}"} for i in range(self.int(1, 3))]
        if self.coin(0.3):
            spec["volumes"] = [{"name": f"v{i}", "persistentVolumeClaim":
                                {"claimName": self.name("claim")}}
                               for i in range(self.int(1, 3))]
        return spec

    def pod(self) -> dict:
        md = {"name": self.name("pod"), "namespace": self.pick(("default", "ml")),
              "labels": {**self.labels(), "tpu/chips": str(self.int(1, 9))},
              "uid": self.name("uid"),
              "annotations": {ref_types.SEQ_ANNOTATION: str(self.int(1, 1 << 30))}}
        status = {"phase": self.pick(("Pending", "Running"))}
        if self.coin(0.3):
            status["nominatedNodeName"] = self.name("node")
        return {"apiVersion": "v1", "kind": "Pod", "metadata": md,
                "spec": self.pod_spec(), "status": status}

    def tpu(self) -> dict:
        node = ref_types.make_node(
            self.name("host"), chips=self.int(1, 9),
            generation=self.pick(("v4", "v5e", "v5p", "v6e")),
            slice_id=self.name("slice") if self.coin() else "",
            topology_coords=(self.int(0, 4), self.int(0, 4), self.int(0, 2)),
            hbm_free_per_chip=self.int(1, 1 << 34),
            unhealthy=tuple(i for i in range(2) if self.coin(0.2)))
        obj = node.to_obj()
        obj["metadata"]["resourceVersion"] = str(self.int(0, 1000))
        obj["status"]["externalUsedChips"] = self.int(0, 2)
        obj["status"]["source"] = self.pick(("env", "device-files", ""))
        return obj

    def node(self) -> dict:
        alloc = {}
        if self.coin(0.6):
            alloc["cpu"] = self.pick(CPUS)
        if self.coin(0.6):
            alloc["memory"] = self.pick(MEMS)
        if self.coin(0.5):
            alloc["pods"] = self.pick(("110", "32", "many"))
        if self.coin(0.4):
            alloc["attachable-volumes-csi-pd.csi.storage.gke.io"] = self.pick(("127", "x"))
        status = {}
        if alloc:
            status["allocatable"] = alloc
        if self.coin(0.4):
            status["images"] = [{"names": [f"img{i}:a", f"img{i}:b"],
                                 "sizeBytes": self.int(1, 1 << 30)}
                                for i in range(self.int(1, 3))]
        if self.coin(0.4):
            status["conditions"] = [{"type": "Ready",
                                     "status": self.pick(("True", "False"))}]
        spec = {}
        if self.coin(0.3):
            spec["unschedulable"] = True
        if self.coin(0.4):
            spec["taints"] = [{"key": f"taint{i}", "value": f"v{i}",
                               "effect": self.pick(("NoSchedule", "PreferNoSchedule"))}
                              for i in range(self.int(1, 3))]
        out = {"apiVersion": "v1", "kind": "Node",
               "metadata": {"name": self.name("node"), "labels": self.labels()},
               "spec": spec}
        if status:
            out["status"] = status
        return out

    def pvc(self) -> dict:
        md = {"name": self.name("claim"), "namespace": self.pick(("default", "ml"))}
        if self.coin():
            md["annotations"] = {"volume.kubernetes.io/selected-node": self.name("node")}
        if self.coin():
            md["labels"] = {"topology.kubernetes.io/zone": self.pick(("a", "b"))}
        spec = {}
        if self.coin():
            spec["accessModes"] = [self.pick(("ReadWriteOnce", "ReadWriteOncePod",
                                              "ReadOnlyMany"))]
        if self.coin():
            spec["volumeName"] = self.name("pv")
        out = {"apiVersion": "v1", "kind": "PersistentVolumeClaim", "metadata": md}
        if spec:
            out["spec"] = spec
        return out

    def pv(self) -> dict:
        spec = {}
        if self.coin(0.7):
            spec["nodeAffinity"] = {"required": {
                "nodeSelectorTerms": [self.term() for _ in range(self.int(1, 3))]}}
        if self.coin():
            spec["claimRef"] = {"namespace": "default", "name": self.name("claim")}
        if self.coin():
            spec["csi"] = {"driver": "pd.csi.storage.gke.io"}
        return {"apiVersion": "v1", "kind": "PersistentVolume",
                "metadata": {"name": self.name("pv")}, "spec": spec}

    def pdb(self) -> dict:
        spec = {}
        sel = self.selector()
        if sel is not None:
            spec["selector"] = sel
        which = self.int(0, 3)
        if which == 1:
            spec["minAvailable"] = self.pick((1, 2, "50%"))
        elif which == 2:
            spec["maxUnavailable"] = self.pick((1, "25%"))
        out = {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
               "metadata": {"name": self.name("pdb"), "namespace": "default"},
               "spec": spec}
        if self.coin():
            out["status"] = {"disruptionsAllowed": self.int(0, 3)}
        return out

    def namespace(self) -> dict:
        return {"apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": self.name("ns"), "labels": self.labels()}}


# kind -> (reference class, port class, draw of one API object)
CODECS = {
    "TpuNodeMetrics": (ref_types.TpuNodeMetrics, port_types.TpuNodeMetrics, Draw.tpu),
    "Toleration": (ref_types.Toleration, port_types.Toleration, Draw.toleration),
    "NodeSelectorRequirement": (ref_types.NodeSelectorRequirement,
                                port_types.NodeSelectorRequirement, Draw.requirement),
    "NodeSelectorTerm": (ref_types.NodeSelectorTerm, port_types.NodeSelectorTerm, Draw.term),
    "K8sPvc": (ref_types.K8sPvc, port_types.K8sPvc, Draw.pvc),
    "K8sPv": (ref_types.K8sPv, port_types.K8sPv, Draw.pv),
    "K8sPdb": (ref_types.K8sPdb, port_types.K8sPdb, Draw.pdb),
    "K8sNamespace": (ref_types.K8sNamespace, port_types.K8sNamespace, Draw.namespace),
    "K8sNode": (ref_types.K8sNode, port_types.K8sNode, Draw.node),
    "PodSpec": (ref_types.PodSpec, port_types.PodSpec, Draw.pod),
    "LabelSelector": (ref_aff.LabelSelector, port_aff.LabelSelector,
                      lambda d: d.selector() or {}),
    "PodAffinityTerm": (ref_aff.PodAffinityTerm, port_aff.PodAffinityTerm,
                        Draw.pod_affinity_term),
    "TopologySpreadConstraint": (ref_aff.TopologySpreadConstraint,
                                 port_aff.TopologySpreadConstraint, Draw.spread),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", sorted(CODECS))
def test_codec_pair_equals_the_reference(kind, seed):
    ref_cls, port_cls, draw = CODECS[kind]
    d = Draw(seed * 1000 + sorted(CODECS).index(kind))
    for _ in range(8):
        obj = draw(d)
        ref, port = ref_cls.from_obj(obj), port_cls.from_obj(obj)
        assert plain(port) == plain(ref)                      # dict -> dataclass
        assert port.to_obj() == ref.to_obj()                  # dataclass -> dict
        assert plain(port_cls.from_obj(port.to_obj())) == plain(
            ref_cls.from_obj(ref.to_obj()))                   # round trip


def test_absent_label_selector_is_none_in_both():
    assert ref_aff.LabelSelector.from_obj(None) is None
    assert port_aff.LabelSelector.from_obj(None) is None


HELPERS = ("_tpu_limit_of", "_resource_requests_of", "_host_ports_of")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("helper", HELPERS)
def test_container_spec_parser_equals_the_reference(helper, seed):
    d = Draw(10_000 + seed * 10 + HELPERS.index(helper))
    for _ in range(16):
        spec = d.pod_spec()
        assert getattr(port_types, helper)(spec) == getattr(ref_types, helper)(spec)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("parser", ("parse_pod_affinity", "parse_topology_spread"))
def test_pod_spec_parser_equals_the_reference(parser, seed):
    d = Draw(20_000 + seed)
    for _ in range(16):
        spec = d.pod_spec()
        assert plain(getattr(port_aff, parser)(spec)) == plain(
            getattr(ref_aff, parser)(spec))


@pytest.mark.parametrize("seed", SEEDS)
def test_pod_without_sequence_annotation_parses_alike(seed):
    """A relisted pod with no arrival-order annotation takes the next
    sequence of its package's own counter (so only that and the uid
    derived from it may differ)."""
    d = Draw(30_000 + seed)
    for _ in range(8):
        obj = d.pod()
        del obj["metadata"]["annotations"]
        del obj["metadata"]["uid"]
        ref, port = ref_types.PodSpec.from_obj(obj), port_types.PodSpec.from_obj(obj)
        skip = {"creation_seq", "uid"}
        assert {k: v for k, v in plain(port)[1].items() if k not in skip} == {
            k: v for k, v in plain(ref)[1].items() if k not in skip}
        assert port.uid == f"{port.namespace}/{port.name}#{port.creation_seq}"
