"""Core API types: the per-node TPU metrics CR and the pod model.

``TpuNodeMetrics`` is the TPU-native replacement for the reference's SCV CRD:
one cluster-scoped object per node, named after the node (the reference Gets
it by node name, reference pkg/yoda/scheduler.go:70). The field mapping from
the SCV schema (inferred at reference pkg/yoda/filter/filter.go:13-58,
collection/collection.go:59-78, score/algorithm.go:72-87):

    Scv.Status.CardNumber      -> len(TpuNodeMetrics.chips)
    Scv.Status.CardList        -> TpuNodeMetrics.chips
    Scv.Status.FreeMemorySum   -> TpuNodeMetrics.hbm_free_sum
    Scv.Status.TotalMemorySum  -> TpuNodeMetrics.hbm_total_sum
    Card.Health                -> TpuChip.health
    Card.FreeMemory (MB)       -> TpuChip.hbm_free (bytes)
    Card.TotalMemory (MB)      -> TpuChip.hbm_total (bytes)
    Card.Clock (MHz)           -> TpuChip.clock_mhz
    Card.Bandwidth             -> TpuChip.hbm_bandwidth_gbps
    Card.Core                  -> TpuChip.tflops_bf16
    Card.Power                 -> TpuChip.power_w

Net-new fields with no reference analog (required by the topology-aware gang
scheduler): ``generation``, ``topology_coords``, ``slice_id``, ``accel_type``,
and ``last_updated_unix`` (staleness detection — the reference never checks
freshness, see SURVEY.md §5 failure-detection row).

Counterpart of ``yoda_tpu/api/types.py``, whole: every model with its
API-server wire format (``to_obj`` / ``from_obj``, which ``KubeCluster``
parses list and watch objects with) and the container-spec parsers behind
them (``_tpu_limit_of``, ``_resource_requests_of``, ``_host_ports_of``).
"""

from __future__ import annotations

import itertools
import logging
import time
from dataclasses import dataclass, field, asdict
from typing import Any, Iterable, Mapping, Sequence

HEALTHY = "Healthy"

# Rank for ">= generation" admission semantics. The reference demanded an
# EXACT clock match in Filter (card.Clock == clock, reference
# pkg/yoda/filter/filter.go:57) while its own collection/score used >=
# (collection.go:46, algorithm.go:49) — so a pod asking for clock 5705 was
# rejected by nodes with strictly faster cards. We keep one ordering,
# "at least this generation", everywhere.
GENERATION_RANK = {"v2": 2, "v3": 3, "v4": 4, "v5e": 5, "v5p": 6, "v6e": 7}

GROUP = "scheduler.yoda-tpu.dev"
VERSION = "v1"
KIND = "TpuNodeMetrics"

# Pod annotation carrying the scheduler's arrival-order sequence (FIFO
# tie-break that survives restart/relist; annotations persist arbitrary keys
# on real API servers, unlike unknown bare metadata fields).
SEQ_ANNOTATION = f"{GROUP}/creation-seq"

# The extended-resource name GKE TPU node pools expose; pods request chips
# through container resource limits on it (the label API's real-world twin).
TPU_RESOURCE = "google.com/tpu"


# Decimal/binary suffixes K8s integer quantities may carry. Extended
# resources must be whole numbers, so fractional ("0.5", "500m") forms are
# invalid for google.com/tpu and rejected below.
_QTY_SUFFIX = {
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40,
}


def _tpu_limit_of(spec: "Mapping[str, Any]") -> int:
    """Sum the containers' google.com/tpu limits, accepting the integer
    Kubernetes quantity notations ('4', '2k', '1Ki'). Unparseable values
    are logged and skipped — loudly, not silently (the repo's
    no-silent-zero rule): on a real cluster the API server validates
    quantities, so this only fires on hand-written fixtures."""
    total = 0
    for c in spec.get("containers", []) or []:
        raw = (c.get("resources", {}) or {}).get("limits", {}).get(TPU_RESOURCE)
        if raw is None:
            continue
        s = str(raw).strip()
        mult = 1
        for suffix, m in _QTY_SUFFIX.items():
            if s.endswith(suffix):
                s, mult = s[: -len(suffix)], m
                break
        try:
            total += int(s) * mult
        except ValueError:
            logging.getLogger("yoda_tpu_torch.api").warning(
                "ignoring unparseable %s quantity %r", TPU_RESOURCE, raw
            )
            continue
    return total


def _resource_requests_of(spec: "Mapping[str, Any]") -> tuple[int, int]:
    """(cpu millicores, memory bytes) the pod effectively requests —
    upstream NodeResourcesFit accounting: per container, requests fall
    back to that container's limits; the pod total is
    max(sum(regular + restartable-init containers), peak of the ordered
    init phase) — sidecar init containers (restartPolicy: Always) keep
    running alongside the regular set so they join the concurrent sum,
    while each one-shot init container runs WITH the sidecars started
    before it (upstream's ordered scan: a one-shot is charged its own
    request plus the sidecar requests accumulated so far). Pod
    ``spec.overhead`` (RuntimeClass) is added on top, as upstream does.
    Unparseable values are logged and counted as 0 (the API server
    validates quantities on real clusters; our strictness budget is spent
    on tpu/* labels)."""
    from yoda_tpu_torch.api.quantity import QuantityError, parse_cpu, parse_quantity

    def one(c: Mapping[str, Any]) -> tuple[int, int]:
        res = c.get("resources") or {}
        req = res.get("requests") or {}
        lim = res.get("limits") or {}
        # PER-RESOURCE fallback (upstream defaulting): a resource absent
        # from requests takes that resource's limit — not the whole dict.
        cpu_raw = req.get("cpu", lim.get("cpu"))
        mem_raw = req.get("memory", lim.get("memory"))
        cpu = mem = 0
        log = logging.getLogger("yoda_tpu_torch.api")
        if cpu_raw is not None:
            try:
                cpu = parse_cpu(str(cpu_raw))
            except QuantityError as e:
                log.warning("ignoring unparseable cpu request: %s", e)
        if mem_raw is not None:
            try:
                # k8s memory quantities: a bare number is BYTES.
                mem = parse_quantity(str(mem_raw), default_unit=1)
            except QuantityError as e:
                log.warning("ignoring unparseable memory request: %s", e)
        return cpu, mem

    regular = [one(c) for c in spec.get("containers") or []]
    # Ordered init-phase scan (upstream): sidecars accumulate as they
    # start; each one-shot init runs concurrently with the sidecars
    # declared BEFORE it, so its charge is request + accumulated sidecars.
    side_cpu = side_mem = 0        # sidecars started so far
    init_cpu = init_mem = 0        # peak of the init phase
    for c in spec.get("initContainers") or []:
        ccpu, cmem = one(c)
        if c.get("restartPolicy") == "Always":
            side_cpu += ccpu
            side_mem += cmem
        else:
            init_cpu = max(init_cpu, side_cpu + ccpu)
            init_mem = max(init_mem, side_mem + cmem)
    cpu = max(sum(c for c, _ in regular) + side_cpu, init_cpu)
    mem = max(sum(m for _, m in regular) + side_mem, init_mem)
    o_cpu, o_mem = one({"resources": {"requests": spec.get("overhead") or {}}})
    return cpu + o_cpu, mem + o_mem


@dataclass
class TpuChip:
    """One TPU chip on a host — the analog of one SCV ``Card``."""

    index: int
    health: str = HEALTHY
    hbm_free: int = 0          # bytes
    hbm_total: int = 0         # bytes
    clock_mhz: int = 0
    hbm_bandwidth_gbps: int = 0
    tflops_bf16: int = 0
    power_w: int = 0
    # True when hbm_free/hbm_total were read from live hardware counters
    # (PJRT memory_stats or the libtpu metrics service) rather than derived
    # from the spec table + label accounting. Provenance for operators, and
    # the agent's input for classifying unattributable usage into the
    # node-level ``external_used_chips`` count the scheduler's reservation
    # corrections key on (NativeTpuAgent._external_used).
    hw_read: bool = False
    # Tensorcore duty cycle [0, 100] from the libtpu metrics service
    # (agent --libtpu-metrics; tpu-info's utilization column). Purely
    # observational — aggregated on /metrics as the fleet-mean gauge
    # yoda_tpu_duty_cycle_avg_pct (per-chip values live in the CR) for
    # operators chasing underutilized fleets; the scheduler never filters
    # or scores on it (a busy chip is already excluded by its HBM usage
    # under the exclusive-chip model). None = source not available.
    duty_cycle_pct: float | None = None

    @property
    def healthy(self) -> bool:
        return self.health == HEALTHY


@dataclass
class TpuNodeMetrics:
    """Per-node TPU metrics CR, published by the node agent (one per node,
    named after the node — mirrors the SCV Get-by-node-name contract,
    reference pkg/yoda/scheduler.go:70)."""

    name: str
    chips: list[TpuChip] = field(default_factory=list)
    generation: str = "v5e"
    accel_type: str = ""                      # e.g. "v5p-16"
    slice_id: str = ""                        # multi-host slice this node belongs to
    topology_coords: tuple[int, int, int] = (0, 0, 0)  # host coords within slice
    last_updated_unix: float = 0.0
    resource_version: int = 0
    # Which collection path produced these values (agent provenance, e.g.
    # "env", "device-files", "jax-runtime+memstats") — lets operators tell
    # hardware-read metrics from spec-table fallbacks.
    source: str = ""
    # Hardware-read used chips whose consumption the agent could NOT
    # attribute to any running pod on the node at scrape time — an
    # external tenant / foreign process. The scheduler must treat these
    # as occupied-by-nobody: they absorb no accountant reservation
    # (filter_plugin.invisible_reservations) and earn no stale-freed
    # credit. Always 0 for spec-table agents (their usage is label
    # attribution by construction, so every used chip is pod-backed).
    external_used_chips: int = 0

    @property
    def chip_count(self) -> int:
        return len(self.chips)

    @property
    def hbm_free_sum(self) -> int:
        return sum(c.hbm_free for c in self.chips)

    @property
    def hbm_total_sum(self) -> int:
        return sum(c.hbm_total for c in self.chips)

    @property
    def generation_rank(self) -> int:
        return GENERATION_RANK.get(self.generation.strip().lower(), 0)

    def healthy_chips(self) -> list[TpuChip]:
        return [c for c in self.chips if c.healthy]

    def fresh(self, *, max_age_s: float, now: float | None = None) -> bool:
        """Staleness check (net-new vs reference; SURVEY.md §5)."""
        now = time.time() if now is None else now
        return (now - self.last_updated_unix) <= max_age_s

    def values_equal(self, other: "TpuNodeMetrics") -> bool:
        """Equality on every schedulability-relevant field — everything
        except the publish timestamp, resource version, and the purely
        observational per-chip duty cycle (a continuously fluctuating
        telemetry value the scheduler never filters or scores on: leaving
        it relevant would classify EVERY heartbeat as a real change and
        reintroduce the per-heartbeat rebuild storm the elision exists to
        prevent). Otherwise derived from the dataclass so a FUTURE field
        defaults to RELEVANT (consumers: the informer's heartbeat
        classification and the fleet-array incremental diff — a hand-kept
        field list would silently classify real changes as heartbeats)."""
        import dataclasses

        def neutral(t: "TpuNodeMetrics") -> "TpuNodeMetrics":
            return dataclasses.replace(
                t,
                last_updated_unix=0.0,
                resource_version=0,
                chips=[
                    dataclasses.replace(c, duty_cycle_pct=None)
                    for c in t.chips
                ],
            )

        return neutral(self) == neutral(other)

    # --- CR (de)serialization, used by the fake/real API server paths ---

    def to_obj(self) -> dict[str, Any]:
        return {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": KIND,
            "metadata": {
                "name": self.name,
                "resourceVersion": str(self.resource_version),
            },
            "status": {
                "generation": self.generation,
                "accelType": self.accel_type,
                "sliceId": self.slice_id,
                "topologyCoords": list(self.topology_coords),
                "lastUpdatedUnix": self.last_updated_unix,
                "source": self.source,
                "chipCount": self.chip_count,
                "hbmFreeSum": self.hbm_free_sum,
                "hbmTotalSum": self.hbm_total_sum,
                "externalUsedChips": self.external_used_chips,
                "chips": [asdict(c) for c in self.chips],
            },
        }

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any]) -> "TpuNodeMetrics":
        st = obj.get("status", {})
        return cls(
            name=obj["metadata"]["name"],
            chips=[TpuChip(**c) for c in st.get("chips", [])],
            generation=st.get("generation", "v5e"),
            accel_type=st.get("accelType", ""),
            slice_id=st.get("sliceId", ""),
            topology_coords=tuple(st.get("topologyCoords", (0, 0, 0))),
            last_updated_unix=st.get("lastUpdatedUnix", 0.0),
            resource_version=int(obj["metadata"].get("resourceVersion", "0")),
            source=st.get("source", ""),
            external_used_chips=st.get("externalUsedChips", 0),
        )


@dataclass(frozen=True)
class Taint:
    """A v1.Taint (spec.taints entry on a Node)."""

    key: str
    value: str = ""
    effect: str = "NoSchedule"   # NoSchedule | PreferNoSchedule | NoExecute


@dataclass(frozen=True)
class Toleration:
    """A v1.Toleration (spec.tolerations entry on a Pod)."""

    key: str = ""                # empty key + Exists tolerates everything
    operator: str = "Equal"      # Equal | Exists
    value: str = ""
    effect: str = ""             # empty matches every effect

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return not self.key or self.key == taint.key
        return self.key == taint.key and self.value == taint.value

    def to_obj(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.key:
            out["key"] = self.key
        out["operator"] = self.operator
        if self.operator == "Equal":
            out["value"] = self.value
        if self.effect:
            out["effect"] = self.effect
        return out

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any]) -> "Toleration":
        return cls(
            key=obj.get("key", ""),
            operator=obj.get("operator", "Equal"),
            value=obj.get("value", ""),
            effect=obj.get("effect", ""),
        )


@dataclass(frozen=True)
class NodeSelectorRequirement:
    """One matchExpressions entry of a v1.NodeSelectorTerm. Operator
    semantics mirror upstream labels.Selector: NotIn and DoesNotExist also
    match nodes MISSING the key; Gt/Lt compare single integer values;
    unknown operators fail closed."""

    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: tuple[str, ...] = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        v = labels.get(self.key)
        op = self.operator
        if op == "In":
            return v is not None and v in self.values
        if op == "NotIn":
            return v is None or v not in self.values
        if op == "Exists":
            return v is not None
        if op == "DoesNotExist":
            return v is None
        if op in ("Gt", "Lt"):
            if v is None or not self.values:
                return False
            try:
                have, want = int(v), int(self.values[0])
            except ValueError:
                return False
            return have > want if op == "Gt" else have < want
        return False

    def to_obj(self) -> dict[str, Any]:
        out: dict[str, Any] = {"key": self.key, "operator": self.operator}
        if self.values:
            out["values"] = list(self.values)
        return out

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any]) -> "NodeSelectorRequirement":
        return cls(
            key=obj.get("key", ""),
            operator=obj.get("operator", ""),
            values=tuple(obj.get("values") or ()),
        )


@dataclass(frozen=True)
class NodeSelectorTerm:
    """A v1.NodeSelectorTerm: matchExpressions and matchFields AND
    together within the term; terms OR together at the affinity level.
    Upstream semantics: an EMPTY term matches no objects, and the only
    valid matchFields key is ``metadata.name`` (evaluated against the
    node's name); anything else fails closed."""

    match_expressions: tuple[NodeSelectorRequirement, ...] = ()
    match_fields: tuple[NodeSelectorRequirement, ...] = ()

    def matches(self, labels: Mapping[str, str], node_name: str = "") -> bool:
        if not self.match_expressions and not self.match_fields:
            return False  # upstream: an empty term selects nothing
        if not all(r.matches(labels) for r in self.match_expressions):
            return False
        for f in self.match_fields:
            if f.key != "metadata.name":
                return False  # the only upstream-valid field key
            if not f.matches({"metadata.name": node_name}):
                return False
        return True

    def to_obj(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.match_expressions:
            out["matchExpressions"] = [
                r.to_obj() for r in self.match_expressions
            ]
        if self.match_fields:
            out["matchFields"] = [r.to_obj() for r in self.match_fields]
        return out

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any]) -> "NodeSelectorTerm":
        return cls(
            match_expressions=tuple(
                NodeSelectorRequirement.from_obj(r)
                for r in obj.get("matchExpressions") or ()
            ),
            match_fields=tuple(
                NodeSelectorRequirement.from_obj(r)
                for r in obj.get("matchFields") or ()
            ),
        )


def _host_ports_of(spec: "Mapping[str, Any]") -> tuple[tuple[int, str, str], ...]:
    """(hostPort, protocol, hostIP) triples claimed by the pod's containers
    — upstream NodePorts accounting (regular + restartable init containers;
    one-shot init containers release their ports before the pod runs, but
    upstream counts all containers conservatively and so do we)."""
    out: list[tuple[int, str, str]] = []
    for c in list(spec.get("containers") or ()) + list(
        spec.get("initContainers") or ()
    ):
        for p in c.get("ports") or ():
            hp = p.get("hostPort")
            if not hp:
                continue
            out.append(
                (int(hp), p.get("protocol") or "TCP", p.get("hostIP") or "0.0.0.0")
            )
    return tuple(out)


def host_ports_conflict(
    a: tuple[int, str, str], b: tuple[int, str, str]
) -> bool:
    """Upstream NodePorts conflict rule: same protocol + port, and the
    hostIPs overlap (equal, or either side is the 0.0.0.0 wildcard)."""
    pa, prota, ipa = a
    pb, protb, ipb = b
    return (
        pa == pb
        and prota == protb
        and (ipa == ipb or ipa == "0.0.0.0" or ipb == "0.0.0.0")
    )


@dataclass
class K8sPvc:
    """The scheduler-relevant slice of a v1.PersistentVolumeClaim — minimal
    volume awareness (the reference inherited upstream's VolumeBinding and
    volume-zone filters, reference pkg/register/register.go:10):

    - ``selected_node``: the ``volume.kubernetes.io/selected-node``
      annotation the volume binder writes for WaitForFirstConsumer claims —
      once set, pods using the claim may only land there.
    - ``zone``: the claim's ``topology.kubernetes.io/zone`` label (the
      minimal stand-in for the bound PV's node-affinity zone): nodes
      labeled with a DIFFERENT zone are rejected.
    - ``access_modes``: ``spec.accessModes`` — the upstream
      VolumeRestrictions inputs: a ``ReadWriteOnce`` claim already mounted
      by pods on some node forces co-location there (single-node
      attachment); ``ReadWriteOncePod`` additionally forbids any second
      pod at all.
    """

    name: str
    namespace: str = "default"
    selected_node: str | None = None
    zone: str | None = None
    access_modes: tuple[str, ...] = ()
    # spec.volumeName — the bound PersistentVolume. When the PV watch is
    # live, the filter resolves this to the PV's REAL spec.nodeAffinity
    # (superseding the zone-label stand-in above).
    volume_name: str | None = None

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def to_obj(self) -> dict[str, Any]:
        md: dict[str, Any] = {"name": self.name, "namespace": self.namespace}
        if self.selected_node:
            md["annotations"] = {
                "volume.kubernetes.io/selected-node": self.selected_node
            }
        if self.zone:
            md["labels"] = {"topology.kubernetes.io/zone": self.zone}
        out: dict[str, Any] = {
            "apiVersion": "v1",
            "kind": "PersistentVolumeClaim",
            "metadata": md,
        }
        spec: dict[str, Any] = {}
        if self.access_modes:
            spec["accessModes"] = list(self.access_modes)
        if self.volume_name:
            spec["volumeName"] = self.volume_name
        if spec:
            out["spec"] = spec
        return out

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any]) -> "K8sPvc":
        md = obj.get("metadata", {})
        spec = obj.get("spec") or {}
        return cls(
            name=md["name"],
            namespace=md.get("namespace", "default"),
            selected_node=(md.get("annotations") or {}).get(
                "volume.kubernetes.io/selected-node"
            ),
            zone=(md.get("labels") or {}).get("topology.kubernetes.io/zone"),
            access_modes=tuple(spec.get("accessModes") or ()),
            volume_name=spec.get("volumeName") or None,
        )


@dataclass
class K8sPv:
    """The scheduler-relevant slice of a v1.PersistentVolume: its REAL
    ``spec.nodeAffinity`` (a local volume's node pin, a regional disk's
    zone set) and the claim it is bound to. Closes the admitted r4 gap
    ("the zone is read off the claim, not the bound PV" — PARITY.md): the
    reference inherited the full upstream VolumeBinding filter
    (pkg/register/register.go:10), whose hard predicate is exactly the
    bound PV's node affinity."""

    name: str  # cluster-scoped
    # spec.nodeAffinity.required.nodeSelectorTerms — terms OR, a term's
    # expressions AND (the NodeSelectorTerm type used by pod nodeAffinity).
    node_affinity: tuple["NodeSelectorTerm", ...] = ()
    claim_ref: str | None = None  # "namespace/name" of the bound claim
    # spec.csi.driver — which attach limit (K8sNode.attach_limits) this
    # volume counts against (upstream NodeVolumeLimits). None: not a
    # CSI volume, exempt from attach counting.
    driver: str | None = None

    def allows_node(self, node: "K8sNode | None") -> tuple[bool, str]:
        """Hard VolumeBinding predicate. Fail-closed when the PV
        constrains but the Node object is unknown (the pod_admits_on
        convention: scheduling onto an unlabeled mystery node would
        strand the workload next to a volume it cannot mount)."""
        if not self.node_affinity:
            return True, ""
        if node is None:
            return False, (
                f"pv {self.name} has node affinity but the node object "
                "is unknown"
            )
        if any(
            term.matches(node.labels, node.name) for term in self.node_affinity
        ):
            return True, ""
        return False, f"node fails pv {self.name}'s node affinity"

    def to_obj(self) -> dict[str, Any]:
        spec: dict[str, Any] = {}
        if self.node_affinity:
            spec["nodeAffinity"] = {
                "required": {
                    "nodeSelectorTerms": [
                        t.to_obj() for t in self.node_affinity
                    ]
                }
            }
        if self.claim_ref:
            ns, _, name = self.claim_ref.partition("/")
            spec["claimRef"] = {"namespace": ns, "name": name}
        if self.driver:
            spec["csi"] = {"driver": self.driver}
        return {
            "apiVersion": "v1",
            "kind": "PersistentVolume",
            "metadata": {"name": self.name},
            "spec": spec,
        }

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any]) -> "K8sPv":
        spec = obj.get("spec") or {}
        terms = (
            ((spec.get("nodeAffinity") or {}).get("required") or {})
            .get("nodeSelectorTerms") or ()
        )
        ref = spec.get("claimRef") or None
        return cls(
            name=obj["metadata"]["name"],
            node_affinity=tuple(NodeSelectorTerm.from_obj(t) for t in terms),
            claim_ref=(
                f"{ref.get('namespace', 'default')}/{ref['name']}"
                if ref and ref.get("name")
                else None
            ),
            driver=(spec.get("csi") or {}).get("driver") or None,
        )


@dataclass
class K8sPdb:
    """The scheduler-relevant slice of a policy/v1 PodDisruptionBudget.

    Upstream DefaultPreemption (inherited by the reference via
    pkg/register/register.go:10) prefers candidate victim sets that
    violate no PDB; this type carries what that check needs: the pod
    selector and the disruption allowance. ``disruptions_allowed`` is
    ``status.disruptionsAllowed`` when the disruption controller has
    published it — the authoritative number; otherwise the allowance is
    derived from spec against the CURRENT matching-pod count (an
    approximation of the controller's expectedPods, adequate for victim
    *preference* — the eviction API remains the enforcement point).

    policy/v1 selector semantics: an empty selector ({}) matches every
    pod in the namespace; an absent selector matches none (modeled as
    ``selector=None``)."""

    name: str
    namespace: str = "default"
    selector: "Any | None" = None            # affinity.LabelSelector | None
    min_available: "int | str | None" = None      # int or "N%"
    max_unavailable: "int | str | None" = None    # int or "N%"
    disruptions_allowed: int | None = None        # status, when published

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def matches(self, pod: "PodSpec") -> bool:
        if pod.namespace != self.namespace or self.selector is None:
            return False
        return self.selector.matches(pod.labels)

    def allowed_disruptions(self, matching_running: int) -> int:
        """How many matching pods may be evicted right now. Percentage
        fields scale against ``matching_running`` (minAvailable rounds
        up, maxUnavailable rounds down — upstream's conservative
        directions)."""
        if self.disruptions_allowed is not None:
            return max(int(self.disruptions_allowed), 0)

        def scaled(v, *, round_up: bool) -> int:
            if isinstance(v, str) and v.endswith("%"):
                pct = int(v[:-1])
                exact = matching_running * pct / 100.0
                return int(-(-exact // 1)) if round_up else int(exact)
            return int(v)

        if self.max_unavailable is not None:
            return max(
                min(scaled(self.max_unavailable, round_up=False), matching_running),
                0,
            )
        if self.min_available is not None:
            return max(
                matching_running - scaled(self.min_available, round_up=True), 0
            )
        return matching_running  # no constraint declared

    def to_obj(self) -> dict[str, Any]:
        spec: dict[str, Any] = {}
        if self.selector is not None:
            spec["selector"] = self.selector.to_obj()
        if self.min_available is not None:
            spec["minAvailable"] = self.min_available
        if self.max_unavailable is not None:
            spec["maxUnavailable"] = self.max_unavailable
        out: dict[str, Any] = {
            "apiVersion": "policy/v1",
            "kind": "PodDisruptionBudget",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": spec,
        }
        if self.disruptions_allowed is not None:
            out["status"] = {"disruptionsAllowed": self.disruptions_allowed}
        return out

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any]) -> "K8sPdb":
        # Deferred import: affinity builds on this module's selector types.
        from yoda_tpu_torch.api.affinity import LabelSelector

        md = obj.get("metadata", {})
        spec = obj.get("spec") or {}
        status = obj.get("status") or {}
        return cls(
            name=md["name"],
            namespace=md.get("namespace", "default"),
            selector=LabelSelector.from_obj(spec.get("selector")),
            min_available=spec.get("minAvailable"),
            max_unavailable=spec.get("maxUnavailable"),
            disruptions_allowed=status.get("disruptionsAllowed"),
        )


@dataclass
class K8sNamespace:
    """The scheduler-relevant slice of a v1.Namespace: its labels, which
    pod-affinity ``namespaceSelector`` terms select over (api.affinity).
    The reference's upstream scheduler watched namespaces for the same
    reason."""

    name: str
    labels: dict[str, str] = field(default_factory=dict)

    def to_obj(self) -> dict[str, Any]:
        return {
            "apiVersion": "v1",
            "kind": "Namespace",
            "metadata": {"name": self.name, "labels": dict(self.labels)},
        }

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any]) -> "K8sNamespace":
        return cls(
            name=obj["metadata"]["name"],
            labels=dict(obj.get("metadata", {}).get("labels", {})),
        )


@dataclass
class K8sNode:
    """The scheduler-relevant slice of a v1.Node.

    The reference never reads Node objects itself, but its upstream
    snapshot carries them (reference pkg/yoda/scheduler.go:101), so cordon
    (spec.unschedulable), NoSchedule taints, and node deletion are honored
    for free there. This type restores that awareness first-party: the
    cluster backends watch /api/v1/nodes and the informer folds these into
    each NodeInfo."""

    name: str
    unschedulable: bool = False
    taints: list[Taint] = field(default_factory=list)
    labels: dict[str, str] = field(default_factory=dict)
    # status.conditions[type=Ready]: False when the node controller
    # reports the kubelet unreachable/NotReady. Deliberately NOT part of
    # pod_admits_on — readiness policy belongs to the node health
    # monitor (yoda_tpu_torch/nodehealth), which fences and repairs; hard
    # admission here would silently drop a whole failure-handling layer.
    ready: bool = True
    # status.allocatable, parsed (0 = undeclared -> that resource is not
    # enforced): the upstream NodeResourcesFit inputs. TPU chips are NOT
    # tracked here — the TpuNodeMetrics CR is the authority for those.
    alloc_cpu_milli: int = 0
    alloc_memory: int = 0
    alloc_pods: int = 0
    # status.images flattened to image-name -> sizeBytes (every name/tag
    # of an image maps to its size) — the ImageLocality scoring input
    # (plugins/yoda/image_locality.py). Empty = kubelet reports none.
    images: dict[str, int] = field(default_factory=dict)
    # status.allocatable "attachable-volumes-*" keys: limit-key suffix ->
    # max attachable volumes (upstream NodeVolumeLimits inputs, e.g.
    # "csi-pd.csi.storage.gke.io" -> 127). A K8sPv's driver counts
    # against the "csi-<driver>" (or bare "<driver>") key. Empty = no
    # declared limits, the filter is not enforced.
    attach_limits: dict[str, int] = field(default_factory=dict)

    def to_obj(self) -> dict[str, Any]:
        spec: dict[str, Any] = {}
        if self.unschedulable:
            spec["unschedulable"] = True
        if self.taints:
            spec["taints"] = [
                {"key": t.key, "value": t.value, "effect": t.effect}
                for t in self.taints
            ]
        out: dict[str, Any] = {
            "apiVersion": "v1",
            "kind": "Node",
            "metadata": {"name": self.name, "labels": dict(self.labels)},
            "spec": spec,
        }
        alloc: dict[str, str] = {}
        if self.alloc_cpu_milli:
            alloc["cpu"] = f"{self.alloc_cpu_milli}m"
        if self.alloc_memory:
            alloc["memory"] = str(self.alloc_memory)
        if self.alloc_pods:
            alloc["pods"] = str(self.alloc_pods)
        for suffix, limit in sorted(self.attach_limits.items()):
            alloc[f"attachable-volumes-{suffix}"] = str(limit)
        status: dict[str, Any] = {}
        if alloc:
            status["allocatable"] = alloc
        if self.images:
            status["images"] = [
                {"names": [name], "sizeBytes": size}
                for name, size in sorted(self.images.items())
            ]
        if not self.ready:
            # Emitted only when NotReady so ready nodes round-trip to the
            # same minimal object they always did.
            status["conditions"] = [{"type": "Ready", "status": "False"}]
        if status:
            out["status"] = status
        return out

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any]) -> "K8sNode":
        from yoda_tpu_torch.api.quantity import QuantityError, parse_cpu, parse_quantity

        spec = obj.get("spec", {})
        alloc = (obj.get("status") or {}).get("allocatable") or {}
        cpu = mem = pods = 0
        log = logging.getLogger("yoda_tpu_torch.api")
        # Per-field: one bad field must not drop the others (and the
        # warning must be truthful about WHICH field is unenforced).
        if "cpu" in alloc:
            try:
                cpu = parse_cpu(str(alloc["cpu"]))
            except QuantityError:
                log.warning(
                    "node %s: unparseable allocatable cpu %r; not enforcing",
                    obj["metadata"]["name"], alloc["cpu"],
                )
        if "memory" in alloc:
            try:
                mem = parse_quantity(str(alloc["memory"]), default_unit=1)
            except QuantityError:
                log.warning(
                    "node %s: unparseable allocatable memory %r; not "
                    "enforcing", obj["metadata"]["name"], alloc["memory"],
                )
        if "pods" in alloc:
            try:
                pods = int(str(alloc["pods"]).strip())
            except ValueError:
                log.warning(
                    "node %s: unparseable allocatable pods %r; not enforcing",
                    obj["metadata"]["name"], alloc["pods"],
                )
        images: dict[str, int] = {}
        for img in (obj.get("status") or {}).get("images") or ():
            size = int(img.get("sizeBytes") or 0)
            for name in img.get("names") or ():
                images[name] = size
        attach_limits: dict[str, int] = {}
        for key, value in alloc.items():
            if not key.startswith("attachable-volumes-"):
                continue
            try:
                attach_limits[key[len("attachable-volumes-"):]] = int(
                    str(value).strip()
                )
            except ValueError:
                log.warning(
                    "node %s: unparseable %s %r; not enforcing",
                    obj["metadata"]["name"], key, value,
                )
        return cls(
            name=obj["metadata"]["name"],
            unschedulable=bool(spec.get("unschedulable", False)),
            taints=[
                Taint(
                    key=t.get("key", ""),
                    value=t.get("value", ""),
                    effect=t.get("effect", "NoSchedule"),
                )
                for t in spec.get("taints", [])
            ],
            labels=dict(obj.get("metadata", {}).get("labels", {})),
            alloc_cpu_milli=cpu,
            alloc_memory=mem,
            alloc_pods=pods,
            images=images,
            attach_limits=attach_limits,
            ready=not any(
                c.get("type") == "Ready"
                and str(c.get("status", "True")) == "False"
                for c in (obj.get("status") or {}).get("conditions") or ()
            ),
        )


def node_admits_pod(
    node: "K8sNode | None",
    tolerations: Sequence[Toleration],
    node_selector: Mapping[str, str] | None = None,
    node_affinity: Sequence[NodeSelectorTerm] = (),
) -> tuple[bool, str]:
    """Cordon + taint + nodeSelector + required-node-affinity admission:
    can the pod be placed on the node at all?

    Mirrors what upstream kube-scheduler's NodeUnschedulable,
    TaintToleration, and NodeAffinity plugins give the reference for free
    via its snapshot (reference pkg/yoda/scheduler.go:101). ``node is
    None`` (no Node object known — e.g. a fake-cluster test without node
    records) admits UNLESS the pod has a selector/affinity constraint:
    the scheduler is the enforcement point for those (kubelet does not
    re-check them), so an unverifiable constraint must reject, not pass
    vacuously. Only hard taint effects reject: NoSchedule / NoExecute;
    PreferNoSchedule (and preferred affinity) are scoring concerns, not
    filters."""
    if node_selector and (
        node is None
        or any(node.labels.get(k) != v for k, v in node_selector.items())
    ):
        return False, (
            "node labels do not match the pod's nodeSelector"
            if node is not None
            else "pod has a nodeSelector but the node object is unknown"
        )
    if node_affinity:
        # Terms OR; a term's matchExpressions AND (upstream semantics).
        if node is None:
            return False, (
                "pod has required node affinity but the node object is "
                "unknown"
            )
        if not any(t.matches(node.labels, node.name) for t in node_affinity):
            return False, (
                "node labels do not match the pod's required node affinity"
            )
    if node is None:
        return True, ""
    if node.unschedulable:
        return False, "node is cordoned (spec.unschedulable)"
    for taint in node.taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return False, f"node has untolerated taint {taint.key}:{taint.effect}"
    return True, ""


def pod_admits_on(node: "K8sNode | None", pod: "PodSpec") -> tuple[bool, str]:
    """:func:`node_admits_pod` with the pod's own constraint set — the
    form every scheduler-side caller wants (filter, batch admission
    vector, gang planning, preemption eligibility)."""
    return node_admits_pod(
        node, pod.tolerations, pod.node_selector, pod.node_affinity
    )


def untolerated_soft_taints(node: "K8sNode | None", pod: "PodSpec") -> int:
    """How many PreferNoSchedule taints on the node the pod does NOT
    tolerate — the soft companion to the hard taint filter (upstream
    TaintToleration's scoring half). 0 when no Node object is known."""
    if node is None:
        return 0
    return sum(
        1
        for taint in node.taints
        if taint.effect == "PreferNoSchedule"
        and not any(t.tolerates(taint) for t in pod.tolerations)
    )


def preferred_affinity_score(node: "K8sNode | None", pod: "PodSpec") -> int:
    """Soft steering: [0, 100] fraction of the pod's
    preferredDuringSchedulingIgnoredDuringExecution term weights this node
    satisfies (upstream NodeAffinity scoring). 0 when the pod declares no
    preferences or the node object is unknown — soft constraints degrade
    gracefully, unlike the hard ones, which fail closed."""
    prefs = pod.preferred_node_affinity
    if not prefs or node is None:
        return 0
    total = sum(w for w, _ in prefs)
    if total <= 0:
        return 0
    matched = sum(
        w for w, t in prefs if t.matches(node.labels, node.name)
    )
    return matched * 100 // total


_pod_seq = itertools.count()


@dataclass
class PodSpec:
    """Minimal pod model: everything the scheduler reads off a v1.Pod.

    The reference reads only pod name and labels (reference
    pkg/yoda/filter/filter.go:12,19,36; sort/sort.go:13) plus the node's
    already-placed pods' labels for allocation scoring
    (score/algorithm.go:77-80).
    """

    name: str
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    scheduler_name: str = "yoda-tpu"
    node_name: str | None = None
    phase: str = "Pending"
    uid: str = ""
    tolerations: list[Toleration] = field(default_factory=list)
    # spec.nodeSelector — how unmodified GKE TPU workloads steer onto node
    # pools (cloud.google.com/gke-tpu-accelerator / -topology node labels).
    # Enforced by node_admits_pod against K8sNode.labels: the scheduler is
    # the selector's enforcement point.
    node_selector: dict[str, str] = field(default_factory=dict)
    # spec.affinity.nodeAffinity.requiredDuringSchedulingIgnoredDuring
    # Execution.nodeSelectorTerms — the hard-affinity terms (OR of terms,
    # AND within a term).
    node_affinity: tuple[NodeSelectorTerm, ...] = ()
    # preferredDuringSchedulingIgnoredDuringExecution — (weight, term)
    # pairs, scored by preferred_affinity_score (soft steering).
    preferred_node_affinity: tuple[tuple[int, NodeSelectorTerm], ...] = ()
    # spec.affinity.podAffinity / podAntiAffinity (api.affinity module):
    # required terms filter, preferred terms score, existing pods'
    # anti-affinity is enforced symmetrically. The reference inherited
    # these from the upstream default plugins it ran alongside
    # (deploy/yoda-scheduler.yaml:15-27 adds yoda to the defaults).
    pod_affinity: tuple = ()          # tuple[PodAffinityTerm, ...]
    pod_anti_affinity: tuple = ()     # tuple[PodAffinityTerm, ...]
    preferred_pod_affinity: tuple = ()       # tuple[(int, PodAffinityTerm)]
    preferred_pod_anti_affinity: tuple = ()  # tuple[(int, PodAffinityTerm)]
    # spec.topologySpreadConstraints (api.affinity.TopologySpreadConstraint).
    topology_spread: tuple = ()
    # Sum of the containers' google.com/tpu resource limits — how
    # unmodified GKE TPU workloads request chips (requests.pod_request uses
    # it as the chip count when no tpu/chips label is present).
    tpu_resource_limit: int = 0
    # Effective cpu (millicores) / memory (bytes) requests across the
    # pod's containers (_resource_requests_of: per-container requests fall
    # back to limits; init containers contribute their max). Enforced
    # against K8sNode allocatable by node_fits_resources — the upstream
    # NodeResourcesFit half the reference inherited.
    cpu_milli_request: int = 0
    memory_request: int = 0
    # spec.priority — what the admission controller resolves from
    # priorityClassName; the fallback when no tpu/priority label is set
    # (upstream preemption orders by this field).
    spec_priority: int = 0
    # status.nominatedNodeName — written by preemption when victims were
    # evicted to make room (upstream parity: kubectl's NOMINATED NODE
    # column; other components see the earmarked capacity).
    nominated_node_name: str | None = None
    # spec.preemptionPolicy — "Never" pods queue at their priority but
    # must not trigger evictions (upstream PriorityClass preemptionPolicy).
    preemption_policy: str = "PreemptLowerPriority"
    # spec.schedulingGates — gate names; while non-empty the pod must NOT
    # be scheduled (upstream PodSchedulingReadiness: how Kueue and quota
    # controllers hold pods until admission).
    scheduling_gates: tuple[str, ...] = ()
    # spec.containers[].ports[].hostPort occupations as (port, protocol,
    # hostIP) — the upstream NodePorts filter the reference inherited
    # (reference pkg/register/register.go:10 runs the full default plugin
    # set): two pods claiming a conflicting host port cannot share a node
    # (host_ports_conflict).
    host_ports: tuple[tuple[int, str, str], ...] = ()
    # spec.volumes[].persistentVolumeClaim.claimName — minimal volume
    # awareness (upstream VolumeBinding/volume-zone parity):
    # pod placement honors the claim's selected-node annotation and zone
    # label (filter_plugin.node_fits_volumes against the PVC watch).
    pvc_names: tuple[str, ...] = ()
    # spec.containers[].image (regular containers, upstream ImageLocality's
    # scoring inputs — init containers run once and are not scored).
    container_images: tuple[str, ...] = ()
    creation_seq: int = field(default_factory=lambda: next(_pod_seq))

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"{self.namespace}/{self.name}#{self.creation_seq}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def to_obj(self) -> dict[str, Any]:
        spec: dict[str, Any] = {
            "schedulerName": self.scheduler_name,
            "nodeName": self.node_name,
        }
        if self.tolerations:
            spec["tolerations"] = [t.to_obj() for t in self.tolerations]
        if self.node_selector:
            spec["nodeSelector"] = dict(self.node_selector)
        affinity: dict[str, Any] = {}
        if self.node_affinity or self.preferred_node_affinity:
            na: dict[str, Any] = {}
            if self.node_affinity:
                na["requiredDuringSchedulingIgnoredDuringExecution"] = {
                    "nodeSelectorTerms": [
                        t.to_obj() for t in self.node_affinity
                    ]
                }
            if self.preferred_node_affinity:
                na["preferredDuringSchedulingIgnoredDuringExecution"] = [
                    {"weight": w, "preference": t.to_obj()}
                    for w, t in self.preferred_node_affinity
                ]
            affinity["nodeAffinity"] = na
        for key, req, pref in (
            ("podAffinity", self.pod_affinity, self.preferred_pod_affinity),
            (
                "podAntiAffinity",
                self.pod_anti_affinity,
                self.preferred_pod_anti_affinity,
            ),
        ):
            if not req and not pref:
                continue
            block: dict[str, Any] = {}
            if req:
                block["requiredDuringSchedulingIgnoredDuringExecution"] = [
                    t.to_obj() for t in req
                ]
            if pref:
                block["preferredDuringSchedulingIgnoredDuringExecution"] = [
                    {"weight": w, "podAffinityTerm": t.to_obj()}
                    for w, t in pref
                ]
            affinity[key] = block
        if affinity:
            spec["affinity"] = affinity
        if self.topology_spread:
            spec["topologySpreadConstraints"] = [
                c.to_obj() for c in self.topology_spread
            ]
        if self.spec_priority:
            spec["priority"] = self.spec_priority
        if self.preemption_policy != "PreemptLowerPriority":
            spec["preemptionPolicy"] = self.preemption_policy
        if self.scheduling_gates:
            spec["schedulingGates"] = [
                {"name": g} for g in self.scheduling_gates
            ]
        if self.pvc_names:
            spec["volumes"] = [
                {"name": f"vol-{i}", "persistentVolumeClaim": {"claimName": c}}
                for i, c in enumerate(self.pvc_names)
            ]
        if (
            self.tpu_resource_limit
            or self.cpu_milli_request
            or self.memory_request
            or self.host_ports
            or self.container_images
        ):
            resources: dict[str, Any] = {}
            if self.tpu_resource_limit:
                resources["limits"] = {
                    TPU_RESOURCE: str(self.tpu_resource_limit)
                }
            requests: dict[str, str] = {}
            if self.cpu_milli_request:
                requests["cpu"] = f"{self.cpu_milli_request}m"
            if self.memory_request:
                requests["memory"] = str(self.memory_request)
            if requests:
                resources["requests"] = requests
            container: dict[str, Any] = {"name": "main", "resources": resources}
            if self.container_images:
                container["image"] = self.container_images[0]
            if self.host_ports:
                container["ports"] = [
                    {"hostPort": p, "protocol": proto, "hostIP": ip}
                    for p, proto, ip in self.host_ports
                ]
            containers = [container]
            for i, image in enumerate(self.container_images[1:]):
                containers.append({"name": f"c{i + 1}", "image": image})
            spec["containers"] = containers
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "labels": dict(self.labels),
                "uid": self.uid,
                # Arrival-order sequence, preserved across (de)serialization so
                # FIFO tie-breaks survive a scheduler restart / relist. An
                # annotation (not a bare metadata field) so real API servers
                # persist it; absent it, relists fall back to the
                # creationTimestamp ordering in the list path.
                "annotations": {SEQ_ANNOTATION: str(self.creation_seq)},
            },
            "spec": spec,
            "status": (
                {"phase": self.phase, "nominatedNodeName": self.nominated_node_name}
                if self.nominated_node_name
                else {"phase": self.phase}
            ),
        }

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any]) -> "PodSpec":
        md = obj["metadata"]
        spec = obj.get("spec", {})
        kwargs = {}
        restored = md.get("annotations", {}).get(SEQ_ANNOTATION)
        if restored is not None:
            try:
                restored = int(restored)
            except ValueError:
                restored = None
        if restored is not None:
            kwargs["creation_seq"] = restored
            # Keep the global counter ahead of restored sequences so pods
            # created after a restart/relist still sort behind older pods.
            global _pod_seq
            nxt = next(_pod_seq)
            if restored >= nxt:
                _pod_seq = itertools.count(restored + 1)
            else:
                _pod_seq = itertools.count(nxt)
        # Deferred import: affinity builds on this module's selector types.
        from yoda_tpu_torch.api.affinity import (
            parse_pod_affinity,
            parse_topology_spread,
        )

        pa, paa, ppa, ppaa = parse_pod_affinity(spec)
        cpu_req, mem_req = _resource_requests_of(spec)
        return cls(
            name=md["name"],
            namespace=md.get("namespace", "default"),
            pod_affinity=pa,
            pod_anti_affinity=paa,
            preferred_pod_affinity=ppa,
            preferred_pod_anti_affinity=ppaa,
            topology_spread=parse_topology_spread(spec),
            labels=dict(md.get("labels", {})),
            scheduler_name=spec.get("schedulerName", "yoda-tpu"),
            node_name=spec.get("nodeName"),
            phase=obj.get("status", {}).get("phase", "Pending"),
            nominated_node_name=obj.get("status", {}).get("nominatedNodeName"),
            uid=md.get("uid", ""),
            tolerations=[
                Toleration.from_obj(t) for t in spec.get("tolerations", [])
            ],
            node_selector=dict(spec.get("nodeSelector") or {}),
            node_affinity=tuple(
                NodeSelectorTerm.from_obj(t)
                for t in (
                    ((spec.get("affinity") or {}).get("nodeAffinity") or {})
                    .get("requiredDuringSchedulingIgnoredDuringExecution")
                    or {}
                ).get("nodeSelectorTerms")
                or ()
            ),
            preferred_node_affinity=tuple(
                (
                    int(p.get("weight") or 0),
                    NodeSelectorTerm.from_obj(p.get("preference") or {}),
                )
                for p in ((spec.get("affinity") or {}).get("nodeAffinity") or {}).get(
                    "preferredDuringSchedulingIgnoredDuringExecution"
                )
                or ()
            ),
            tpu_resource_limit=_tpu_limit_of(spec),
            cpu_milli_request=cpu_req,
            memory_request=mem_req,
            spec_priority=int(spec.get("priority") or 0),
            preemption_policy=(
                spec.get("preemptionPolicy") or "PreemptLowerPriority"
            ),
            scheduling_gates=tuple(
                g.get("name", "") for g in spec.get("schedulingGates") or ()
            ),
            host_ports=_host_ports_of(spec),
            pvc_names=tuple(
                v["persistentVolumeClaim"]["claimName"]
                for v in spec.get("volumes") or ()
                if v.get("persistentVolumeClaim", {}).get("claimName")
            ),
            container_images=tuple(
                c["image"]
                for c in spec.get("containers") or ()
                if c.get("image")
            ),
            **kwargs,
        )


def make_node(
    name: str,
    *,
    chips: int = 4,
    hbm_per_chip: int = 16 << 30,
    hbm_free_per_chip: int | None = None,
    generation: str = "v5e",
    clock_mhz: int = 940,
    hbm_bandwidth_gbps: int = 819,
    tflops_bf16: int = 197,
    power_w: int = 170,
    slice_id: str = "",
    topology_coords: tuple[int, int, int] = (0, 0, 0),
    accel_type: str = "",
    unhealthy: Iterable[int] = (),
    now: float | None = None,
) -> TpuNodeMetrics:
    """Convenience constructor used by the fake publisher and tests."""
    free = hbm_per_chip if hbm_free_per_chip is None else hbm_free_per_chip
    bad = set(unhealthy)
    return TpuNodeMetrics(
        name=name,
        generation=generation,
        accel_type=accel_type or f"{generation}-{chips}",
        slice_id=slice_id,
        topology_coords=topology_coords,
        last_updated_unix=time.time() if now is None else now,
        chips=[
            TpuChip(
                index=i,
                health=("Unhealthy" if i in bad else HEALTHY),
                hbm_free=free,
                hbm_total=hbm_per_chip,
                clock_mhz=clock_mhz,
                hbm_bandwidth_gbps=hbm_bandwidth_gbps,
                tflops_bf16=tflops_bf16,
                power_w=power_w,
            )
            for i in range(chips)
        ],
    )
