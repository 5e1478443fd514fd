"""Extension-point interfaces and framework datatypes.

Modeled on the modern kube-scheduler framework (the v1alpha1→v1 semantics
trap is documented in yoda_tpu/framework/__init__.py). The reference plugin
implements QueueSort, Filter, "PostFilter" (modern PreScore), Score, and
ScoreExtensions (reference pkg/yoda/scheduler.go:29-33); this framework adds
the extension points the reference lacks and the BASELINE configs require:
PreFilter, modern PostFilter (preemption), Reserve/Unreserve, Permit, Bind.

Counterpart of ``yoda_tpu/framework/interfaces.py``. PostFilter
(``PostFilterPlugin``) serves preemption; the snapshot carries the
Namespace, PersistentVolumeClaim and PersistentVolume data and the node
health monitor's fence set. Permit (``PermitPlugin``) serves the
gang plugin; the runtime reaches its waitlist hooks (``on_pod_waiting``,
``on_pod_resolved``, ``on_pod_bound``, ``on_bind_failed``,
``on_unbind_failed``) by name, as the reference does.
"""

from __future__ import annotations

import enum
from collections import abc
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Mapping, Protocol, Sequence

from yoda_tpu_torch.api.types import K8sNode, PodSpec, TpuNodeMetrics

if TYPE_CHECKING:
    from yoda_tpu_torch.framework.cyclestate import CycleState

MAX_NODE_SCORE = 100  # framework.MaxNodeScore parity (used at reference scheduler.go:137)


class Code(enum.Enum):
    SUCCESS = "Success"
    ERROR = "Error"
    UNSCHEDULABLE = "Unschedulable"
    UNSCHEDULABLE_AND_UNRESOLVABLE = "UnschedulableAndUnresolvable"
    WAIT = "Wait"
    SKIP = "Skip"


@dataclass(frozen=True)
class Status:
    """Result of one plugin at one extension point (upstream framework.Status
    analog; the reference constructs these at e.g. scheduler.go:79-83)."""

    code: Code = Code.SUCCESS
    message: str = ""

    @property
    def success(self) -> bool:
        return self.code == Code.SUCCESS

    @property
    def rejected(self) -> bool:
        return self.code in (Code.UNSCHEDULABLE, Code.UNSCHEDULABLE_AND_UNRESOLVABLE)

    @classmethod
    def ok(cls) -> "Status":
        # Shared frozen instance: ok() is the hottest Status constructor
        # (every node of every cycle) and carries no per-call data.
        return _STATUS_OK

    @classmethod
    def unschedulable(cls, message: str) -> "Status":
        return cls(Code.UNSCHEDULABLE, message)

    @classmethod
    def unresolvable(cls, message: str) -> "Status":
        return cls(Code.UNSCHEDULABLE_AND_UNRESOLVABLE, message)

    @classmethod
    def error(cls, message: str) -> "Status":
        return cls(Code.ERROR, message)

    @classmethod
    def wait(cls, message: str = "") -> "Status":
        return cls(Code.WAIT, message)

    @classmethod
    def skip(cls) -> "Status":
        return cls(Code.SKIP)


_STATUS_OK = Status(Code.SUCCESS)


@dataclass
class NodeInfo:
    """A node plus its scheduler-visible state: the TPU metrics CR and the
    pods already placed there (the reference reads placed pods' labels for
    allocation scoring, reference pkg/yoda/score/algorithm.go:77-80)."""

    name: str
    tpu: TpuNodeMetrics | None = None
    pods: list[PodSpec] = field(default_factory=list)
    # The v1.Node object when the cluster backend watches Nodes; None in
    # minimal test setups (admission checks then pass vacuously).
    node: K8sNode | None = None


class Snapshot:
    """Immutable-per-cycle view of the cluster — the analog of the upstream
    ``SnapshotSharedLister`` the reference reads in Score (reference
    pkg/yoda/scheduler.go:101). Built once per cycle from the informer cache;
    NO API-server reads happen during a cycle (the fix for the reference's
    per-node live Gets, scheduler.go:70,108 — SURVEY.md §3.2 hot-loop)."""

    def __init__(
        self,
        nodes: Mapping[str, NodeInfo],
        *,
        version: int = 0,
        namespaces: "Mapping[str, Mapping[str, str]] | None" = None,
        pvcs: "Mapping[str, object] | None" = None,
        pvs: "Mapping[str, object] | None" = None,
        order: "list[str] | None" = None,
    ) -> None:
        self._nodes = dict(nodes)
        # ``order``: the node names ALREADY in sorted order, supplied by a
        # caller that maintains it incrementally (InformerCache keeps a
        # bisect-maintained name list); bare constructions pay the sort.
        self._order = sorted(self._nodes) if order is None else order
        # Monotonic cache key bumped by the informer on any node/pod/metrics
        # change; lets the batch plugin reuse lowered fleet arrays across
        # cycles (0 = uncacheable).
        self.version = version
        # The informer's metrics epoch at build (TPU CR changes only): the
        # fleet-array cache key, so pod binds do not force a re-stack.
        self.metrics_version = 0
        # The informer's admission-feed epoch at build (Node-object and
        # pod-set changes): the cross-snapshot admission cache carries a
        # vector to a later snapshot by patching only the nodes changed in
        # between. None = no feed stamped this snapshot (bare constructions).
        self.admission_epoch: int | None = None
        # Namespace name -> labels (from the Namespace watch), consumed by
        # pod-affinity namespaceSelector terms (api.affinity). None = no
        # Namespace data available.
        self.namespaces = dict(namespaces) if namespaces else None
        # "namespace/name" -> K8sPvc (from the PVC watch), consumed by the
        # volume filter (filter_plugin.node_fits_volumes). None = no PVC
        # data (volume constraints are not enforced); an EMPTY dict means
        # the watch is live and no claims exist, so only a true None
        # collapses to None.
        self.pvcs = dict(pvcs) if pvcs is not None else None
        # PV name -> K8sPv (from the PersistentVolume watch): a bound
        # claim's REAL PV nodeAffinity instead of the claim's zone-label
        # stand-in. Same None-versus-empty contract as pvcs.
        self.pvs = dict(pvs) if pvs is not None else None
        # Node names fenced from NEW placements by the node health monitor
        # (SUSPECT / DRAINING / DOWN — yoda_tpu_torch/nodehealth), stamped
        # by the informer's fence_fn at build; the admission call sites
        # (the batch plugin's admission row, gang planning, the
        # rebalancer's fit checks, speculation) veto these hosts. Fence
        # flips invalidate the snapshot, so the set is never stale.
        self.fenced: frozenset = frozenset()

    def get(self, name: str) -> NodeInfo:
        return self._nodes[name]

    def names(self) -> list[str]:
        return list(self._order)

    def infos(self) -> list[NodeInfo]:
        return [self._nodes[n] for n in self._order]

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, name: str) -> bool:
        return name in self._nodes


class QueuedPodLike(Protocol):
    pod: PodSpec


class Plugin:
    name: str = "plugin"


class QueueSortPlugin(Plugin):
    def less(self, a: "QueuedPodLike", b: "QueuedPodLike") -> bool:
        """True if pod ``a`` should be scheduled before pod ``b``."""
        raise NotImplementedError


class PreFilterPlugin(Plugin):
    def pre_filter(self, state: "CycleState", pod: PodSpec, snapshot: Snapshot) -> Status:
        raise NotImplementedError


class FilterPlugin(Plugin):
    def filter(self, state: "CycleState", pod: PodSpec, node: NodeInfo) -> Status:
        raise NotImplementedError


class PostFilterPlugin(Plugin):
    """Modern PostFilter: runs when NO node passed Filter — preemption."""

    def post_filter(
        self,
        state: "CycleState",
        pod: PodSpec,
        snapshot: Snapshot,
        filtered_statuses: Mapping[str, Status],
    ) -> tuple[str | None, Status]:
        """Returns (nominated_node_name or None, status)."""
        raise NotImplementedError


class PreScorePlugin(Plugin):
    def pre_score(
        self,
        state: "CycleState",
        pod: PodSpec,
        snapshot: Snapshot,
        feasible: Sequence[str],
    ) -> Status:
        raise NotImplementedError


class ScorePlugin(Plugin):
    def score(self, state: "CycleState", pod: PodSpec, node: NodeInfo) -> tuple[int, Status]:
        raise NotImplementedError

    def normalize(
        self, state: "CycleState", pod: PodSpec, scores: dict[str, int]
    ) -> Status:
        """In-place min-max rescale to [0, MAX_NODE_SCORE] by default —
        parity with the reference's NormalizeScore including its all-equal
        guard (reference pkg/yoda/scheduler.go:122-147, minus the unguarded
        ``scores[0]`` panic on an empty list, SURVEY.md §3.4 quirk 6)."""
        if not scores:
            return Status.ok()
        lowest = min(scores.values())
        highest = max(scores.values())
        if highest == lowest:
            lowest -= 1
        for name, s in scores.items():
            scores[name] = (s - lowest) * MAX_NODE_SCORE // (highest - lowest)
        return Status.ok()


class RowVerdicts(abc.Mapping):
    """Per-node filter verdicts computed on read, for a cycle a batch
    plugin served from a row evaluated before it (a burst's): only
    ``feasible()`` can pass, and any other node's Status comes from the
    row's arrays when it is asked for. A bound cycle reads none of them,
    so it pays no walk over the fleet.

    Read-only to its readers; the framework records a filter plugin's
    rejection with ``reject``, which every later read sees. The first full
    walk (a failure summary, PostFilter, the pending record, debug
    logging) builds the whole map once, and each full walk calls
    ``on_walk``. Subclasses give ``_status_at``, the Status of row i."""

    def __init__(
        self,
        names: Sequence[str],
        index: Mapping[str, int],
        feasible: Sequence[str],
        on_walk: "Callable[[], None] | None" = None,
    ) -> None:
        self._names = names
        self._index = index
        self._feasible = tuple(feasible)
        self._on_walk = on_walk
        self._rejected: dict[str, Status] = {}
        self._map: dict[str, Status] | None = None

    def _status_at(self, i: int) -> Status:
        raise NotImplementedError

    def as_dict(self) -> dict[str, Status]:
        """The whole map (a full walk): built on the first call, kept."""
        if self._on_walk is not None:
            self._on_walk()
        if self._map is None:
            built = dict(
                zip(self._names, map(self._status_at, range(len(self._names))))
            )
            built.update(self._rejected)
            self._map = built
        return self._map

    def __getitem__(self, name: str) -> Status:
        if self._map is not None:
            return self._map[name]
        st = self._rejected.get(name)
        return st if st is not None else self._status_at(self._index[name])

    def __iter__(self):
        return iter(self.as_dict())

    def __len__(self) -> int:
        return len(self._names)

    def __contains__(self, name: object) -> bool:
        return name in self._index

    def keys(self):
        return self.as_dict().keys()

    def items(self):
        return self.as_dict().items()

    def values(self):
        return self.as_dict().values()

    def feasible(self) -> list[str]:
        """The nodes that pass, in the names' order."""
        return [n for n in self._feasible if n not in self._rejected]

    def covers(self, names: Sequence[str]) -> bool:
        """True when every node of ``names`` has a verdict here."""
        return names == self._names or all(map(self._index.__contains__, names))

    def reject(self, name: str, status: Status) -> None:
        """A filter plugin's verdict on a node that passed the row."""
        self._rejected[name] = status
        if self._map is not None:
            self._map[name] = status


class BatchFilterScorePlugin(Plugin):
    """TPU-native fast path with no upstream analog: filter AND score every
    node in one fused, device-compiled computation over the fleet's metric
    arrays, instead of a Python loop of per-node calls. A plugin implementing
    this is used by the framework INSTEAD of its FilterPlugin/ScorePlugin
    methods on the hot path; the per-node methods remain as the semantic
    reference and for fallback."""

    def filter_and_score_batch(
        self, state: "CycleState", pod: PodSpec, snapshot: Snapshot
    ) -> tuple[Mapping[str, Status], dict[str, int]]:
        """Returns (per-node filter status, per-node raw score for feasible
        nodes). The statuses are a fresh dict the caller owns, or a
        :class:`RowVerdicts` for a cycle served from a row."""
        raise NotImplementedError


class ReservePlugin(Plugin):
    def reserve(self, state: "CycleState", pod: PodSpec, node_name: str) -> Status:
        raise NotImplementedError

    def unreserve(self, state: "CycleState", pod: PodSpec, node_name: str) -> None:
        raise NotImplementedError


class PermitPlugin(Plugin):
    def permit(
        self, state: "CycleState", pod: PodSpec, node_name: str
    ) -> tuple[Status, float]:
        """Returns (status, timeout_seconds). Status WAIT parks the pod on the
        framework waitlist until approved/rejected or timeout."""
        raise NotImplementedError


class BindPlugin(Plugin):
    def bind(self, state: "CycleState", pod: PodSpec, node_name: str) -> Status:
        raise NotImplementedError


def summarize_failure(statuses: Mapping[str, Status]) -> str:
    """Aggregate per-node failure messages like the upstream fitError text."""
    counts: dict[str, int] = {}
    for s in statuses.values():
        if not s.success:
            counts[s.message or s.code.value] = counts.get(s.message or s.code.value, 0) + 1
    parts = [f"{n} node(s): {msg}" for msg, n in sorted(counts.items(), key=lambda kv: -kv[1])]
    return "; ".join(parts) if parts else "no nodes available"
