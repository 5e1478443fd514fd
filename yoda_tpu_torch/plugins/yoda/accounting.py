"""Chip accounting: Reserve/Unreserve plus lifecycle tracking.

Net-new vs the reference, which had NO schedule-time accounting (reference
pkg/yoda/scheduler.go has no Reserve hook; SURVEY.md §3.3). Model:

- TPU chips are exclusive: a pod occupies ``effective_chips`` whole chips
  from Reserve until the pod is DELETED (not merely bound — a running pod
  keeps its chips).
- ``chips_in_use(node)`` feeds the evaluation's reservation predicate, so
  in-flight reservations and long-running pods both subtract from
  schedulable capacity immediately, independent of metrics-agent refresh lag.
- State is reconstructible from the API server: the accountant is a watcher;
  on replay it re-counts bound pods.

Counterpart of ``yoda_tpu/plugins/yoda/accounting.py``, ported as far as the
singleton and gang paths reach it: a gang's Permit rejection, cascade and
bind rollback all release through ``unreserve`` (``release``), and an
unbound pod's watch event leaves the claim for that release to drop, as
in the reference; the reservation delta feed
(:meth:`ChipAccountant.reserved_changes_since`) keeps the resident
dynamics row current in O(changed). Left out until a later slice: the
durable claim journal, shard staging and the optimistic commit
(``stage`` / ``commit_staged``), warm-start restore and the worker-side
``RemoteAccountant``.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

from yoda_tpu_torch.api.requests import LabelParseError, pod_request
from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.cluster.fake import Event
from yoda_tpu_torch.cluster.informer import ring_since
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import ReservePlugin, Status
from yoda_tpu_torch.plugins.yoda.filter_plugin import get_request


@dataclass
class _Claim:
    node: str
    chips: int


class ChipAccountant(ReservePlugin):
    name = "yoda-accountant"

    def __init__(
        self,
        *,
        scheduler_name: str = "yoda-tpu",
        scheduler_names: "tuple[str, ...] | None" = None,
    ) -> None:
        # All schedulerNames this process serves.
        self.scheduler_names = frozenset(scheduler_names or (scheduler_name,))
        self.scheduler_name = scheduler_name
        self._lock = threading.Lock()
        self._claims: dict[str, _Claim] = {}  # pod uid -> claim
        self._in_use: dict[str, int] = {}     # node -> chips
        # Reservation delta feed (dynamics row 1 of the device-resident
        # fleet state, ops/resident.py): epoch bumped per node-total
        # change, bounded ring of (epoch, node), so a consumer applies only
        # the nodes whose reservations moved since its last sync.
        self._epoch = 0
        self._changes: deque[tuple[int, str]] = deque(maxlen=65536)

    # --- ReservePlugin ---

    def reserve(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        self._claim(pod.uid, node_name, get_request(state).effective_chips)
        return Status.ok()

    def unreserve(self, state: CycleState, pod: PodSpec, node_name: str) -> None:
        self.release(pod.uid)

    # --- lifecycle (watch events) ---

    def handle(self, event: Event) -> None:
        if event.kind != "Pod":
            return
        pod: PodSpec = event.obj  # type: ignore[assignment]
        if event.type == "deleted":
            self.release(pod.uid)
        elif pod.node_name:
            # Bound pod (new bind, or replay after restart): ensure counted —
            # but only pods that occupy chips: ours (we reserve a chip even
            # for label-less pods) or any pod that expresses a TPU request.
            try:
                req = pod_request(pod)
            except LabelParseError:
                # Malformed tpu/* labels: a google.com/tpu resource limit
                # attaches real chips no matter what the labels say.
                if pod.tpu_resource_limit > 0:
                    self._claim(pod.uid, pod.node_name, pod.tpu_resource_limit)
                    return
                if pod.scheduler_name not in self.scheduler_names:
                    return
                req = None
            if req is not None and not req.wants_tpu and (
                pod.scheduler_name not in self.scheduler_names
            ):
                return
            chips = req.effective_chips if req is not None else 1
            self._claim(pod.uid, pod.node_name, chips)

    # --- internals / readers ---

    def _note(self, node: str) -> None:
        """Record a node-total change on the delta feed (lock held)."""
        self._epoch += 1
        self._changes.append((self._epoch, node))

    def _claim(self, uid: str, node: str, chips: int) -> None:
        with self._lock:
            existing = self._claims.get(uid)
            if existing is not None and existing.node == node:
                return  # reserve->bind transition: single claim
            if existing is not None:
                self._in_use[existing.node] -= existing.chips
                self._note(existing.node)
            self._claims[uid] = _Claim(node, chips)
            self._in_use[node] = self._in_use.get(node, 0) + chips
            self._note(node)

    def release(self, uid: str) -> None:
        with self._lock:
            claim = self._claims.pop(uid, None)
            if claim is not None:
                self._in_use[claim.node] = max(
                    self._in_use.get(claim.node, 0) - claim.chips, 0
                )
                self._note(claim.node)

    def chips_in_use(self, node_name: str) -> int:
        with self._lock:
            return self._in_use.get(node_name, 0)

    def chips_by_node(self) -> dict[str, int]:
        """One consistent copy of the whole reservation map under a single
        lock acquisition — the evaluation's dynamics build reads every node
        per dispatch."""
        with self._lock:
            return dict(self._in_use)

    @property
    def reservation_epoch(self) -> int:
        with self._lock:
            return self._epoch

    def reserved_changes_since(
        self, epoch: int
    ) -> "tuple[int, dict[str, int] | None]":
        """Delta feed over the per-node reservation totals: ``(current
        epoch, {node: chips})`` for nodes whose total changed in epochs
        ``(epoch, current]``, or ``(current epoch, None)`` when the ring no
        longer reaches back (or the consumer is ahead): the consumer then
        rebuilds from :meth:`chips_by_node`."""
        with self._lock:
            cur = self._epoch
            nodes = ring_since(self._changes, epoch, cur)
            if nodes is None:
                return cur, None
            return cur, {n: self._in_use.get(n, 0) for n in nodes}
