"""Inter-pod affinity/anti-affinity: the part the singleton path reaches.

Counterpart of ``yoda_tpu/api/affinity.py``. The reference evaluates
required and preferred pod (anti-)affinity and topology spread per
(pod, cycle). This slice of the port carries only what the singleton path
needs to recognise such pods and fleets: :class:`LabelSelector` and the two
trigger predicates. The port's PreFilter refuses a pod whose admission
would need an evaluator (``plugins/yoda/filter_plugin.py``), so no such pod
is ever placed as if its terms were absent.

Left out until a later slice: ``PodAffinityTerm``,
``TopologySpreadConstraint``, their spec parsers, ``InterPodEvaluator`` and
``SpreadEvaluator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterable, Mapping

from yoda_tpu_torch.api.types import NodeSelectorRequirement, PodSpec

if TYPE_CHECKING:
    from yoda_tpu_torch.framework.interfaces import NodeInfo


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


def pod_has_inter_pod_terms(pod: PodSpec) -> bool:
    return bool(
        pod.pod_affinity
        or pod.pod_anti_affinity
        or pod.preferred_pod_affinity
        or pod.preferred_pod_anti_affinity
    )


def fleet_has_inter_pod_terms(infos: Iterable["NodeInfo"]) -> bool:
    """Any bound pod anywhere declaring required anti-affinity OR preferred
    (anti-)affinity terms — the trigger for an evaluator even when the
    incoming pod has no terms of its own (required-anti symmetry filter +
    symmetric preferred scoring)."""
    return any(
        p.pod_anti_affinity
        or p.preferred_pod_affinity
        or p.preferred_pod_anti_affinity
        for ni in infos
        for p in ni.pods
    )
