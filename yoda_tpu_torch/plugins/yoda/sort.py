"""Queue ordering: strict priority from the ``tpu/priority`` label.

Parity with reference pkg/yoda/sort/sort.go:8-18 (``scv/priority``, default 0,
higher first), with two deliberate differences: malformed priorities were
silently 0 there (``strconv.Atoi`` error ignored, sort.go:14) — here the
strict parse happened at admission, so by queue time the label is valid — and
equal priorities fall back to FIFO arrival order (the queue's tiebreak)
instead of Go-heap-arbitrary order.
"""

from __future__ import annotations

from yoda_tpu_torch.api import requests
from yoda_tpu_torch.framework.interfaces import QueuedPodLike, QueueSortPlugin


def pod_priority(pod) -> int:
    """Queue priority: the ``tpu/priority`` label, falling back to
    ``spec.priority`` (the PriorityClass-resolved field, how unmodified GKE
    workloads express it — requests.pod_request parity)."""
    raw = pod.labels.get(requests.PRIORITY)
    if raw is None:
        return getattr(pod, "spec_priority", 0)
    try:
        return int(raw.strip())
    except ValueError:
        # Defensive only (strict parse rejects these at admission), but fall
        # back the same way as the absent-label path: a GKE pod with a
        # PriorityClass plus a typo'd label must not sort/victim-rank at 0
        # below its spec priority.
        return getattr(pod, "spec_priority", 0)


class YodaSort(QueueSortPlugin):
    name = "yoda-sort"

    def less(self, a: QueuedPodLike, b: QueuedPodLike) -> bool:
        return pod_priority(a.pod) > pod_priority(b.pod)
