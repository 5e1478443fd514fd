"""Inter-pod affinity/anti-affinity and topology-spread constraints.

The reference scheduler wrapped the whole upstream kube-scheduler
(reference pkg/register/register.go:10), so pods it scheduled got the
default plugin set's InterPodAffinity and PodTopologySpread behavior for
free alongside the yoda plugin (reference deploy/yoda-scheduler.yaml:15-27
enables yoda *in addition to* the defaults). This module restores those
first-party, on the same evaluation model upstream uses:

- **Required pod affinity**: the candidate node must share a topology
  domain (same value of ``topologyKey`` in node labels) with at least one
  existing pod matching the term's label selector. Upstream's first-pod
  rule applies: a term that matches NO existing pod anywhere, but whose
  selector matches the incoming pod itself (in its own namespace), is
  treated as satisfied — otherwise the first replica of a
  self-affinitizing group could never schedule.
- **Required pod anti-affinity**: the candidate node must NOT share a
  topology domain with any existing pod matching the term. A node without
  the topology key belongs to no domain and never conflicts (upstream
  semantics).
- **Anti-affinity symmetry**: an EXISTING pod's required anti-affinity
  terms also repel the incoming pod (upstream checks both directions;
  without this, "spread me" pods are only protected against later
  arrivals, not earlier ones).
- **Preferred terms** contribute a signed weight sum for scoring — in
  BOTH directions, as upstream InterPodAffinity scores: the incoming
  pod's own preferred terms over existing pods, and existing pods'
  preferred (anti-)affinity terms matching the incoming pod, each
  credited/debited in the existing pod's topology domain.
- **Topology spread**: ``maxSkew``/``topologyKey``/``whenUnsatisfiable``
  over the pods matching the constraint's selector in the incoming pod's
  namespace. ``DoNotSchedule`` filters; ``ScheduleAnyway`` scores.

Scope notes (documented divergences from upstream):

- Only pods on nodes the scheduler snapshots (TPU nodes) are visible; pods
  on non-TPU nodes neither satisfy affinity nor trigger anti-affinity.
- In-flight (reserved-but-unbound) pods ARE visible when the caller feeds
  them via the ``pending`` argument (gang members parked at Permit —
  GangPlugin.pending_placements); without that feed, enforcement is
  against bound pods only.
- ``minDomains`` is supported (DoNotSchedule constraints: global min is
  0 while fewer eligible domains exist). ``namespaceSelector`` IS supported
  (union with the explicit namespaces list, upstream semantics), resolved
  against the Namespace watch. A non-empty selector over a namespace with
  no data is treated DIRECTIONALLY: out of scope for affinity/preferred
  terms (the pod just waits — safe), but IN scope for required
  anti-affinity and its symmetry check (unknown namespaces still repel:
  a hard separation constraint must not silently fail open).

Evaluators are built once per (pod, scheduling cycle) — O(pods x terms)
precomputation — and answer per-node queries from dict lookups, keeping
the per-node cost O(terms) on the hot path (SURVEY.md §3.2's hot-loop
discipline).

Counterpart of ``yoda_tpu/api/affinity.py``, whole: the evaluators, the
wire format of every type here (``to_obj`` / ``from_obj``) and the
v1.Pod spec parsers ``parse_pod_affinity`` / ``parse_topology_spread``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Iterable, Mapping

from yoda_tpu_torch.api.types import K8sNode, NodeSelectorRequirement, PodSpec

if TYPE_CHECKING:  # the evaluators take duck-typed snapshot/NodeInfo views
    from yoda_tpu_torch.framework.interfaces import NodeInfo, Snapshot


@dataclass(frozen=True)
class LabelSelector:
    """A v1.LabelSelector. Upstream semantics: an EMPTY selector (present
    but with no requirements) matches everything; an ABSENT selector is
    represented by ``None`` at the use site and matches nothing."""

    match_labels: tuple[tuple[str, str], ...] = ()
    match_expressions: tuple[NodeSelectorRequirement, ...] = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        if any(labels.get(k) != v for k, v in self.match_labels):
            return False
        return all(r.matches(labels) for r in self.match_expressions)

    def to_obj(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.match_labels:
            out["matchLabels"] = dict(self.match_labels)
        if self.match_expressions:
            out["matchExpressions"] = [
                r.to_obj() for r in self.match_expressions
            ]
        return out

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any] | None) -> "LabelSelector | None":
        if obj is None:
            return None
        return cls(
            match_labels=tuple(sorted((obj.get("matchLabels") or {}).items())),
            match_expressions=tuple(
                NodeSelectorRequirement.from_obj(r)
                for r in obj.get("matchExpressions") or ()
            ),
        )


@dataclass(frozen=True)
class PodAffinityTerm:
    """A v1.PodAffinityTerm: selector over pods + the topology key that
    defines co-location. Namespace scoping (upstream semantics): the
    explicit ``namespaces`` list and the namespaces selected by
    ``namespace_selector`` (over Namespace LABELS) are UNIONED; when both
    are unset, the owner pod's namespace applies. An EMPTY (no-requirement)
    namespace_selector selects every namespace."""

    topology_key: str
    selector: LabelSelector | None = None
    namespaces: tuple[str, ...] = ()
    namespace_selector: LabelSelector | None = None

    def allows_namespace(
        self,
        other_ns: str,
        owner_namespace: str,
        ns_labels: Mapping[str, Mapping[str, str]] | None = None,
        *,
        assume_unknown: bool = False,
    ) -> bool:
        """Is ``other_ns`` within this term's namespace scope?
        ``ns_labels`` maps namespace name -> labels (from the Namespace
        watch); an empty selector needs no data. For a non-empty selector
        over a namespace with no data, ``assume_unknown`` decides: False
        (default) treats it as out of scope — the safe direction for
        AFFINITY, where a false negative just holds the pod — while
        anti-affinity callers pass True so unknown namespaces still REPEL
        (a false negative there would co-locate workloads a hard
        constraint separates)."""
        if not self.namespaces and self.namespace_selector is None:
            return other_ns == owner_namespace
        if other_ns in self.namespaces:
            return True
        sel = self.namespace_selector
        if sel is None:
            return False
        if not sel.match_labels and not sel.match_expressions:
            return True  # empty selector: all namespaces (upstream)
        labels = (ns_labels or {}).get(other_ns)
        if labels is None:
            return assume_unknown
        return sel.matches(labels)

    def matches_pod(
        self,
        other: PodSpec,
        owner_namespace: str,
        ns_labels: Mapping[str, Mapping[str, str]] | None = None,
        *,
        assume_unknown: bool = False,
    ) -> bool:
        if self.selector is None:
            return False  # absent selector matches no objects (upstream)
        return self.allows_namespace(
            other.namespace,
            owner_namespace,
            ns_labels,
            assume_unknown=assume_unknown,
        ) and self.selector.matches(other.labels)

    def to_obj(self) -> dict[str, Any]:
        out: dict[str, Any] = {"topologyKey": self.topology_key}
        if self.selector is not None:
            out["labelSelector"] = self.selector.to_obj()
        if self.namespaces:
            out["namespaces"] = list(self.namespaces)
        if self.namespace_selector is not None:
            out["namespaceSelector"] = self.namespace_selector.to_obj()
        return out

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any]) -> "PodAffinityTerm":
        return cls(
            topology_key=obj.get("topologyKey", ""),
            selector=LabelSelector.from_obj(obj.get("labelSelector")),
            namespaces=tuple(obj.get("namespaces") or ()),
            namespace_selector=LabelSelector.from_obj(
                obj.get("namespaceSelector")
            ),
        )


@dataclass(frozen=True)
class TopologySpreadConstraint:
    """A v1.TopologySpreadConstraint (selector-scoped skew over topology
    domains). ``when_unsatisfiable`` is DoNotSchedule (hard) or
    ScheduleAnyway (soft). ``match_label_keys`` narrows the selector to
    pods sharing the incoming pod's values for those keys (upstream: a
    Deployment sets pod-template-hash there so each rollout spreads
    independently); keys absent from the incoming pod's labels are
    ignored, matching upstream."""

    max_skew: int
    topology_key: str
    when_unsatisfiable: str = "DoNotSchedule"
    selector: LabelSelector | None = None
    match_label_keys: tuple[str, ...] = ()
    # minDomains (DoNotSchedule only, upstream): while fewer eligible
    # domains exist than this, the global minimum is treated as 0 so new
    # pods keep spreading into new domains instead of stacking.
    min_domains: int = 0

    def effective_selector(
        self, pod_labels: Mapping[str, str]
    ) -> "LabelSelector | None":
        """The selector with match_label_keys folded in, ANDed as
        additional ``In`` requirements against the incoming pod's own
        values (upstream appends requirements — on a collision with the
        base selector the result matches NOTHING, it never overrides)."""
        if not self.match_label_keys or self.selector is None:
            return self.selector
        extra = tuple(
            NodeSelectorRequirement(key=k, operator="In", values=(pod_labels[k],))
            for k in self.match_label_keys
            if k in pod_labels
        )
        if not extra:
            return self.selector
        return LabelSelector(
            match_labels=self.selector.match_labels,
            match_expressions=self.selector.match_expressions + extra,
        )

    def to_obj(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "maxSkew": self.max_skew,
            "topologyKey": self.topology_key,
            "whenUnsatisfiable": self.when_unsatisfiable,
        }
        if self.selector is not None:
            out["labelSelector"] = self.selector.to_obj()
        if self.match_label_keys:
            out["matchLabelKeys"] = list(self.match_label_keys)
        if self.min_domains:
            out["minDomains"] = self.min_domains
        return out

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any]) -> "TopologySpreadConstraint":
        return cls(
            max_skew=int(obj.get("maxSkew") or 1),
            topology_key=obj.get("topologyKey", ""),
            when_unsatisfiable=obj.get("whenUnsatisfiable", "DoNotSchedule"),
            selector=LabelSelector.from_obj(obj.get("labelSelector")),
            match_label_keys=tuple(obj.get("matchLabelKeys") or ()),
            min_domains=int(obj.get("minDomains") or 0),
        )


# --- v1.Pod spec parsing helpers (used by PodSpec.from_obj) ---


def parse_pod_affinity(
    spec: Mapping[str, Any],
) -> tuple[
    tuple[PodAffinityTerm, ...],
    tuple[PodAffinityTerm, ...],
    tuple[tuple[int, PodAffinityTerm], ...],
    tuple[tuple[int, PodAffinityTerm], ...],
]:
    """(required affinity, required anti-affinity, preferred affinity,
    preferred anti-affinity) from a v1.Pod spec mapping."""
    aff = spec.get("affinity") or {}

    def _required(block: Mapping[str, Any]) -> tuple[PodAffinityTerm, ...]:
        return tuple(
            PodAffinityTerm.from_obj(t)
            for t in block.get("requiredDuringSchedulingIgnoredDuringExecution")
            or ()
        )

    def _preferred(
        block: Mapping[str, Any],
    ) -> tuple[tuple[int, PodAffinityTerm], ...]:
        return tuple(
            (
                int(p.get("weight") or 0),
                PodAffinityTerm.from_obj(p.get("podAffinityTerm") or {}),
            )
            for p in block.get("preferredDuringSchedulingIgnoredDuringExecution")
            or ()
        )

    pa = aff.get("podAffinity") or {}
    paa = aff.get("podAntiAffinity") or {}
    return _required(pa), _required(paa), _preferred(pa), _preferred(paa)


def parse_topology_spread(
    spec: Mapping[str, Any],
) -> tuple[TopologySpreadConstraint, ...]:
    return tuple(
        TopologySpreadConstraint.from_obj(c)
        for c in spec.get("topologySpreadConstraints") or ()
    )


# --- evaluation ---


def _node_labels(ni: "NodeInfo") -> Mapping[str, str]:
    return ni.node.labels if ni.node is not None else {}


def pod_has_inter_pod_terms(pod: PodSpec) -> bool:
    return bool(
        pod.pod_affinity
        or pod.pod_anti_affinity
        or pod.preferred_pod_affinity
        or pod.preferred_pod_anti_affinity
    )


def fleet_has_inter_pod_terms(infos: Iterable["NodeInfo"]) -> bool:
    """Any bound pod anywhere declaring required anti-affinity OR preferred
    (anti-)affinity terms — the trigger for building an evaluator even when
    the incoming pod has no terms of its own (required-anti symmetry filter
    + symmetric preferred scoring). Callers cache this per snapshot
    version so term-free fleets pay nothing per cycle."""
    return any(
        p.pod_anti_affinity
        or p.preferred_pod_affinity
        or p.preferred_pod_anti_affinity
        for ni in infos
        for p in ni.pods
    )


@dataclass
class InterPodEvaluator:
    """Per-(pod, cycle) inter-pod affinity oracle.

    Precomputes, from one pass over the snapshot's bound pods:

    - per required-affinity term: the set of topology values whose domain
      contains a matching pod (``_ok_values``), or the self-match flag;
    - per required-anti-affinity term: the set of forbidden values;
    - symmetry: (key, value) domains forbidden by EXISTING pods'
      anti-affinity terms that match the incoming pod;
    - per preferred term: value sets for the signed score;
    - symmetric preferences: signed weight per (key, value) domain from
      EXISTING pods' preferred (anti-)affinity terms matching the
      incoming pod (upstream scores both directions).

    Per-node queries are then O(terms) dict lookups.
    """

    pod: PodSpec
    _ok_values: list[set[str]] = field(default_factory=list)
    _self_satisfied: list[bool] = field(default_factory=list)
    _bad_values: list[set[str]] = field(default_factory=list)
    _symmetry_bad: set[tuple[str, str]] = field(default_factory=set)
    _pref_values: list[tuple[int, str, set[str]]] = field(default_factory=list)
    _sym_pref: dict[tuple[str, str], int] = field(default_factory=dict)

    @classmethod
    def build(
        cls,
        snapshot: "Snapshot",
        pod: PodSpec,
        *,
        check_symmetry: bool = True,
        pending: Iterable[tuple[str, PodSpec]] = (),
    ) -> "InterPodEvaluator":
        """``pending``: (node name, pod spec) pairs for pods RESERVED on a
        node but not yet bound — gang members parked at Permit
        (GangPlugin.pending_placements). They are folded in exactly like
        bound pods (their domain comes from the assigned node's labels), so
        sibling cycles see each other's in-flight placements; entries whose
        uid already appears in the snapshot (bind raced the read) are
        skipped."""
        ev = cls(pod)
        ns_labels = snapshot.namespaces
        n_aff = len(pod.pod_affinity)
        ev._ok_values = [set() for _ in range(n_aff)]
        ev._bad_values = [set() for _ in range(len(pod.pod_anti_affinity))]
        # signed weight, topology key, matching values
        ev._pref_values = [
            (w, t.topology_key, set()) for w, t in pod.preferred_pod_affinity
        ] + [
            (-w, t.topology_key, set())
            for w, t in pod.preferred_pod_anti_affinity
        ]
        pref_terms = [t for _, t in pod.preferred_pod_affinity] + [
            t for _, t in pod.preferred_pod_anti_affinity
        ]
        any_term_matched = [False] * n_aff

        def _fold(labels: Mapping[str, str], other: PodSpec) -> None:
            for i, term in enumerate(pod.pod_affinity):
                if term.matches_pod(other, pod.namespace, ns_labels):
                    any_term_matched[i] = True
                    v = labels.get(term.topology_key)
                    if v is not None:
                        ev._ok_values[i].add(v)
            for j, term in enumerate(pod.pod_anti_affinity):
                if term.matches_pod(
                    other, pod.namespace, ns_labels, assume_unknown=True
                ):
                    v = labels.get(term.topology_key)
                    if v is not None:
                        ev._bad_values[j].add(v)
            for k, term in enumerate(pref_terms):
                if term.matches_pod(other, pod.namespace, ns_labels):
                    v = labels.get(term.topology_key)
                    if v is not None:
                        ev._pref_values[k][2].add(v)
            if check_symmetry and other.pod_anti_affinity:
                for term in other.pod_anti_affinity:
                    if term.matches_pod(
                        pod, other.namespace, ns_labels, assume_unknown=True
                    ):
                        v = labels.get(term.topology_key)
                        if v is not None:
                            ev._symmetry_bad.add((term.topology_key, v))
            # Symmetric preferred scoring (upstream InterPodAffinity): an
            # existing pod's preferred terms matching THIS pod add or
            # subtract weight in the existing pod's domain.
            for sign, terms in (
                (1, other.preferred_pod_affinity),
                (-1, other.preferred_pod_anti_affinity),
            ):
                for w, term in terms:
                    if term.matches_pod(pod, other.namespace, ns_labels):
                        v = labels.get(term.topology_key)
                        if v is not None:
                            dom = (term.topology_key, v)
                            ev._sym_pref[dom] = (
                                ev._sym_pref.get(dom, 0) + sign * w
                            )

        pending = tuple(pending)
        seen_uids: set[str] = set()
        for ni in snapshot.infos():
            labels = _node_labels(ni)
            for other in ni.pods:
                if pending:
                    seen_uids.add(other.uid)
                if other.uid == pod.uid:
                    continue  # a relisted copy of the pod itself never
                    # satisfies its own affinity (upstream parity)
                _fold(labels, other)
        for host, other in pending:
            if other.uid == pod.uid or other.uid in seen_uids:
                continue
            if host in snapshot:
                _fold(_node_labels(snapshot.get(host)), other)
        # Upstream first-pod rule: a required-affinity term matching no
        # existing pod anywhere is satisfied iff the incoming pod matches
        # its own term — the group's first member bootstraps the domain.
        ev._self_satisfied = [
            (not any_term_matched[i])
            and term.matches_pod(pod, pod.namespace, ns_labels)
            for i, term in enumerate(pod.pod_affinity)
        ]
        return ev

    @property
    def trivial(self) -> bool:
        """True when no per-node check or score could ever fire."""
        return (
            not self.pod.pod_affinity
            and not self.pod.pod_anti_affinity
            and not self._symmetry_bad
            and not self._pref_values
            and not self._sym_pref
        )

    @property
    def has_preferences(self) -> bool:
        """True when some node could receive a nonzero preference() —
        scoring fast-paths gate on this, not on evaluator existence (an
        evaluator built only for the symmetry check has no preferences)."""
        return bool(self._pref_values) or bool(self._sym_pref)

    def required_affinity_feasible(self, ni: "NodeInfo") -> bool:
        """Just the required-AFFINITY half of :meth:`feasible`. Within a
        cycle, eviction can only REMOVE matching pods — an ok-domain set
        never grows — so preemption uses this to skip nodes the preemptor
        could never land on no matter what is evicted (anti-affinity /
        symmetry / spread conflicts are deliberately NOT checked here:
        eviction can cure those)."""
        labels = _node_labels(ni)
        for i, term in enumerate(self.pod.pod_affinity):
            v = labels.get(term.topology_key)
            if self._self_satisfied[i]:
                if v is None:  # keyless node: the group could never join
                    return False
                continue
            if v is None or v not in self._ok_values[i]:
                return False
        return True

    def feasible(self, ni: "NodeInfo") -> tuple[bool, str]:
        labels = _node_labels(ni)
        for i, term in enumerate(self.pod.pod_affinity):
            v = labels.get(term.topology_key)
            if self._self_satisfied[i]:
                # Deliberate divergence from upstream (which drops the term
                # entirely): the bootstrapping pod must still land on a node
                # that HAS the topology key — a keyless node belongs to no
                # domain, so the group's later members could never join it
                # (a gang bootstrapping onto a keyless host would wedge).
                if v is None:
                    return False, (
                        f"node lacks topology key {term.topology_key!r} "
                        "required by the pod's own affinity group"
                    )
                continue
            if v is None or v not in self._ok_values[i]:
                return False, (
                    "no pod matching required pod affinity in the node's "
                    f"{term.topology_key!r} domain"
                )
        for j, term in enumerate(self.pod.pod_anti_affinity):
            v = labels.get(term.topology_key)
            if v is not None and v in self._bad_values[j]:
                return False, (
                    "required pod anti-affinity conflicts with a pod in the "
                    f"node's {term.topology_key!r} domain"
                )
        for key, bad in self._symmetry_bad:
            if labels.get(key) == bad:
                return False, (
                    "an existing pod's required anti-affinity repels this "
                    f"pod from the node's {key!r} domain"
                )
        return True, ""

    def preference(self, ni: "NodeInfo") -> int:
        """Signed sum of preferred term weights this node satisfies: the
        pod's own terms plus the symmetric contribution from existing
        pods' preferred terms (both directions, upstream parity)."""
        if not self._pref_values and not self._sym_pref:
            return 0
        labels = _node_labels(ni)
        total = 0
        for w, key, values in self._pref_values:
            v = labels.get(key)
            if v is not None and v in values:
                total += w
        for (key, value), w in self._sym_pref.items():
            if labels.get(key) == value:
                total += w
        return total


@dataclass
class SpreadEvaluator:
    """Per-(pod, cycle) topology-spread oracle.

    For each constraint, counts pods matching its selector (in the
    incoming pod's namespace) per topology domain, over nodes eligible for
    the pod (nodeSelector + required node affinity, upstream's
    domain-eligibility rule) that carry the topology key. Skew for placing
    on domain ``v`` is ``count[v] + 1 - min(counts)``.
    """

    pod: PodSpec
    # per constraint: (constraint, counts by value, min count over domains)
    _per: list[tuple[TopologySpreadConstraint, dict[str, int], int]] = field(
        default_factory=list
    )

    @staticmethod
    def _domain_eligible(ni: "NodeInfo", pod: PodSpec) -> bool:
        """Upstream's domain-eligibility rule: only the pod's own node
        steering (nodeSelector + required node affinity) decides which
        domains "exist" for balancing — taints and cordon deliberately
        excluded (upstream default)."""
        if not pod.node_selector and not pod.node_affinity:
            return True
        if ni.node is None:
            return False
        labels = ni.node.labels
        if any(labels.get(k) != v for k, v in pod.node_selector.items()):
            return False
        if pod.node_affinity and not any(
            t.matches(labels, ni.node.name) for t in pod.node_affinity
        ):
            return False
        return True

    @classmethod
    def build(
        cls,
        snapshot: "Snapshot",
        pod: PodSpec,
        *,
        pending: Iterable[tuple[str, PodSpec]] = (),
    ) -> "SpreadEvaluator":
        """``pending`` as in :meth:`InterPodEvaluator.build`: reserved-but-
        unbound pods counted in their assigned node's domains."""
        ev = cls(pod)
        if not pod.topology_spread:
            return ev
        pending = tuple(pending)
        counted: list[dict[str, int]] = [{} for _ in pod.topology_spread]
        seen_uids: set[str] = set()
        # match_label_keys folded into each constraint's selector once
        # (pins the count to pods sharing the incoming pod's values).
        selectors = [
            c.effective_selector(pod.labels) for c in pod.topology_spread
        ]

        def _count(ni: "NodeInfo", others: Iterable[PodSpec]) -> None:
            labels = _node_labels(ni)
            for c_i, c in enumerate(pod.topology_spread):
                v = labels.get(c.topology_key)
                if v is None:
                    continue
                counts = counted[c_i]
                counts.setdefault(v, 0)
                sel = selectors[c_i]
                for other in others:
                    if other.uid == pod.uid:
                        continue
                    if other.namespace != pod.namespace:
                        continue
                    if sel is not None and sel.matches(other.labels):
                        counts[v] += 1

        for ni in snapshot.infos():
            if pending:
                seen_uids.update(p.uid for p in ni.pods)
            if not cls._domain_eligible(ni, pod):
                continue
            _count(ni, ni.pods)
        for host, other in pending:
            if other.uid in seen_uids or host not in snapshot:
                continue
            ni = snapshot.get(host)
            if cls._domain_eligible(ni, pod):
                _count(ni, (other,))
        ev._per = [
            (c, counts, min(counts.values()) if counts else 0)
            for c, counts in zip(pod.topology_spread, counted)
        ]
        return ev

    @property
    def trivial(self) -> bool:
        return not self._per

    @property
    def has_soft(self) -> bool:
        """Any ScheduleAnyway constraint — the only kind :meth:`score`
        considers, so scoring fast-paths gate on this."""
        return any(
            c.when_unsatisfiable == "ScheduleAnyway" for c, _, _ in self._per
        )

    @property
    def has_hard(self) -> bool:
        return any(
            c.when_unsatisfiable == "DoNotSchedule" for c, _, _ in self._per
        )

    def feasible(self, ni: "NodeInfo") -> tuple[bool, str]:
        labels = _node_labels(ni)
        for c, counts, lo in self._per:
            if c.when_unsatisfiable != "DoNotSchedule":
                continue
            v = labels.get(c.topology_key)
            if v is None:
                return False, (
                    f"node lacks topology key {c.topology_key!r} required "
                    "by a DoNotSchedule spread constraint"
                )
            if c.min_domains and len(counts) < c.min_domains:
                lo = 0  # upstream minDomains: under-populated domain set
            if counts.get(v, 0) + 1 - lo > c.max_skew:
                return False, (
                    f"placing here would exceed maxSkew={c.max_skew} over "
                    f"{c.topology_key!r}"
                )
        return True, ""

    def score(self, ni: "NodeInfo") -> int:
        """[0, 100] balance score, averaged over the soft (ScheduleAnyway)
        constraints only — upstream PodTopologySpread's scorer ignores
        DoNotSchedule constraints (those already filtered): 100 = the
        emptiest domain, 0 = the fullest."""
        total = 0
        n = 0
        for c, counts, lo in self._per:
            if c.when_unsatisfiable != "ScheduleAnyway":
                continue
            v = _node_labels(ni).get(c.topology_key)
            n += 1
            if v is None or not counts:
                continue
            hi = max(counts.values())
            if hi <= lo:
                total += 100
            else:
                total += 100 * (hi - counts.get(v, 0)) // (hi - lo)
        return total // n if n else 0
