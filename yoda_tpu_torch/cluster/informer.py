"""Informer cache: watch-driven local store + per-cycle snapshots.

The scheduler reads ONLY this cache during a cycle. The cache maintains:

- the TpuNodeMetrics CR per node (watch on the CRD, replacing per-cycle Gets),
- the pods bound to each node (for allocation scoring, reference
  pkg/yoda/score/algorithm.go:77-80),
- incrementally-maintained claimed-HBM per node,
- two monotonic versions: ``version`` (any change — snapshot cache key) and
  ``metrics_version`` (TPU CR changes only — fleet-array cache key, so pod
  binds do not force an O(nodes x chips) array rebuild),
- an epoch/delta feed over ``metrics_version`` (:meth:`changes_since`):
  the device-resident fleet state (ops/resident.py FleetStateCache) asks
  "which nodes changed since epoch E" and refills only those rows, plus
  the claimed-HBM feed (:meth:`claimed_changes_since`) and the admission
  feed (:meth:`admission_changes_since`) that the batch plugin's
  dynamics row and cross-snapshot admission cache read.

It also keeps the Namespace labels, PersistentVolumeClaims,
PersistentVolumes and PodDisruptionBudgets: the first three are stamped on
each snapshot (``None`` unless the matching watch is live), the budgets
are read by preemption (:meth:`list_pdbs`).

Counterpart of ``yoda_tpu/cluster/informer.py``, with the node-health
fence hook (``fence_fn``, stamped on every snapshot as ``Snapshot.fenced``,
and :meth:`InformerCache.invalidate_snapshot`) and the "synced" liveness
sentinels ``KubeCluster`` emits once a PersistentVolumeClaim,
PersistentVolume or PodDisruptionBudget LIST succeeded (each turns its
``watches_*`` flag on), and the scheduler lanes' hooks: ``node_filter_fn``
restricts a lane's snapshots (and so its resident arrays) to its
partition, and a change to another lane's node does not re-stack it;
``pod_route_fn`` queues only the lane's routed pods, failing closed when
the hook raises; and the watch-staleness clock the federation health
monitor reads (:meth:`InformerCache.last_event_age_s`, on ``mono_fn``).
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

from yoda_tpu_torch.api.requests import LabelParseError, pod_request
from yoda_tpu_torch.api.types import (
    K8sNode,
    K8sPdb,
    K8sPv,
    K8sPvc,
    PodSpec,
    TpuNodeMetrics,
)
from yoda_tpu_torch.cluster.fake import Event
from yoda_tpu_torch.framework.interfaces import NodeInfo, Snapshot

MIB = 1 << 20


@dataclass(frozen=True)
class FleetDelta:
    """What changed in the metrics-relevant fleet between two epochs
    (:meth:`InformerCache.changes_since`). ``epoch`` is the current metrics
    epoch the delta brings the consumer up to; ``changed`` names nodes
    whose CR VALUES changed in place (row refill suffices); ``structural``
    means the candidate-node SET itself changed (CR or Node object added or
    deleted): row indices may have shifted and the consumer re-stacks."""

    epoch: int
    changed: frozenset
    structural: bool


class InformerCache:
    def __init__(
        self,
        *,
        scheduler_name: str = "yoda-tpu",
        on_pod_pending: Callable[[PodSpec], None] | None = None,
        on_change: Callable[[Event], None] | None = None,
        on_change_batch: "Callable[[list[Event]], None] | None" = None,
        watches_pvcs: bool = False,
        watches_pvs: bool = False,
        watches_pdbs: bool = False,
        staleness_s: float = 0.0,
        now_fn: Callable[[], float] = time.time,
        mono_fn: Callable[[], float] = time.monotonic,
        node_filter_fn: "Callable[[str, TpuNodeMetrics], bool] | None" = None,
        pod_route_fn: "Callable[[PodSpec], bool] | None" = None,
    ) -> None:
        self.scheduler_name = scheduler_name
        self.on_pod_pending = on_pod_pending
        self.on_change = on_change
        # One call per applied batch with the schedulability-relevant
        # events (build_stack wires the delete fast path and ONE
        # move_all_to_active decision here). Falls back to one
        # ``on_change`` call per relevant event when unset.
        self.on_change_batch = on_change_batch
        # True when the backend streams PersistentVolumeClaim events: then
        # an empty PVC store means "no claims exist" (pods referencing one
        # wait), while False means "no PVC data" (volume constraints are
        # not enforced: snapshot.pvcs stays None).
        self.watches_pvcs = watches_pvcs
        # Same contract for PodDisruptionBudgets: True = preemption's
        # victim preference may trust the (possibly empty) store; False =
        # no budget data, the preference is skipped and budgets act only
        # through refused evictions.
        self.watches_pdbs = watches_pdbs
        # And for PersistentVolumes: True = bound claims resolve to their
        # PV's real nodeAffinity; False = the claim's zone-label stand-in
        # applies (snapshot.pvs stays None).
        self.watches_pvs = watches_pvs
        # The scheduler's max_metrics_age_s, used ONLY to classify
        # timestamp-only republishes: a node whose publish gap exceeded
        # this had gone stale, so its refresh must reactivate parked pods.
        self.staleness_s = staleness_s
        self.now_fn = now_fn
        # Scheduler shard-out (framework/shards.py): a sharded stack's
        # informer restricts its SNAPSHOT (and therefore its resident
        # fleet arrays) to the shard's node partition, and routes only
        # this shard's pods into the scheduling queue. Both hooks must be
        # PURE functions of (name, CR) / pod labels — they run under the
        # informer lock per snapshot build / delta read. None (default) =
        # full fleet, every matching pod (the unsharded behavior).
        self.node_filter_fn = node_filter_fn
        self.pod_route_fn = pod_route_fn
        # Watch-stream staleness clock (federation health signal, also a
        # stuck-watch debugging probe): the monotonic instant the last watch
        # event of ANY kind reached this cache. Separate clock domain from
        # now_fn — event age is a local liveness measure, never compared
        # against agent-stamped wall timestamps.
        self.mono_fn = mono_fn
        self._last_event_mono: float | None = None
        # Node-health fence hook (yoda_tpu_torch/nodehealth): returns the
        # node names currently fenced from NEW placements; stamped onto
        # every snapshot (Snapshot.fenced) so the admission call sites veto
        # them. The monitor calls invalidate_snapshot() on fence flips.
        self.fence_fn: "Callable[[], frozenset] | None" = None
        self._lock = threading.RLock()
        self._tpus: dict[str, TpuNodeMetrics] = {}
        # _tpus keys kept sorted incrementally (bisect on CR add/delete):
        # snapshot() hands the pre-sorted list to Snapshot(order=...).
        self._tpu_order: list[str] = []
        self._nodes: dict[str, K8sNode] = {}
        self._namespaces: dict[str, dict[str, str]] = {}  # name -> labels
        self._pvcs: dict[str, K8sPvc] = {}  # "namespace/name" -> claim
        self._pvs: dict[str, K8sPv] = {}
        self._pdbs: dict[str, K8sPdb] = {}
        # True once any Node event arrived: from then on a TPU CR without a
        # live Node object is excluded from snapshots (node deleted).
        self._node_informed = False
        self._pods_by_node: dict[str, dict[str, PodSpec]] = {}
        self._claimed_mib: dict[str, int] = {}
        # Every pod uid currently alive in the cluster.
        self._live_uids: set[str] = set()
        # Unbound pods held by spec.schedulingGates: kept OUT of the queue
        # until a modified event shows the gates cleared.
        self._gated_uids: set[str] = set()
        # pod uid -> (node counted on, claim MiB added).
        self._pod_nodes: dict[str, tuple[str, int]] = {}
        self._version = 1
        self._metrics_version = 1
        self._snapshot_cache: Snapshot | None = None
        # Epoch/delta feed over metrics_version: one ring entry per node
        # per bump, (epoch-after-bump, kind, node name), kind "modified"
        # (row refill suffices) or "structural" (node set changed). The
        # ring covers epochs (ring[0].epoch - 1, current]; a consumer
        # further behind gets None and re-stacks.
        self._delta_ring: deque[tuple[int, str, str]] = deque(maxlen=4096)
        # Claimed-HBM delta feed (dynamics row 2 of the resident state):
        # epoch bumped per claimed-total change, ring of (epoch, node).
        self._claim_epoch = 0
        self._claim_ring: deque[tuple[int, str]] = deque(maxlen=65536)
        # Admission delta feed: epoch bumped per change that can flip a
        # node's admission verdict without touching the metrics feed —
        # every Node-object event and every per-node pod-set change. The
        # batch plugin's cross-snapshot admission cache patches only these
        # nodes' rows.
        self._admission_epoch = 0
        self._admission_ring: deque[tuple[int, str]] = deque(maxlen=65536)
        # NodeInfo reuse across snapshots for nodes whose CR / Node object /
        # pod set did not change.
        self._ni_cache: dict[str, NodeInfo] = {}
        # Per-batch accumulators written by the _handle_* internals (lock
        # held); handle_batch bumps each version at most once per batch.
        self._batch_dirty = False
        self._batch_metrics: list[tuple[str, str]] = []  # (kind, node)
        self._batch_pending: list[PodSpec] = []

    # --- watch sink ---

    def handle(self, event: Event) -> None:
        self.handle_batch((event,))

    def handle_batch(self, events) -> None:
        """Apply a run of watch events under ONE lock acquisition, with one
        ``version`` bump, one ``metrics_version`` bump (the delta ring gets
        one entry per metrics-relevant node, all at the new epoch) and one
        snapshot invalidation. Pending-pod and change callbacks fire after the batch
        is fully applied, outside the lock."""
        relevant_events: list[Event] = []
        with self._lock:
            self._last_event_mono = self.mono_fn()
            self._batch_dirty = False
            self._batch_metrics = []
            self._batch_pending = []
            for event in events:
                relevant = True
                if event.kind == "TpuNodeMetrics":
                    relevant = self._handle_tpu(event)
                elif event.kind == "Pod":
                    self._handle_pod(event)
                elif event.kind == "Node":
                    self._handle_node(event)
                elif event.kind == "Namespace":
                    self._handle_namespace(event)
                elif event.kind == "PersistentVolumeClaim":
                    self._handle_pvc(event)
                elif event.kind == "PersistentVolume":
                    self._handle_pv(event)
                elif event.kind == "PodDisruptionBudget":
                    self._handle_pdb(event)
                # Timestamp-only heartbeats are NOT propagated as cluster
                # changes (upstream's queueing-hint discipline).
                if relevant:
                    relevant_events.append(event)
            if self._batch_dirty:
                self._version += 1
                self._snapshot_cache = None
            if self._batch_metrics:
                self._metrics_version += 1
                for kind, name in self._batch_metrics:
                    self._delta_ring.append((self._metrics_version, kind, name))
            pending = self._batch_pending
            self._batch_pending = []
        if self.on_pod_pending is not None:
            for pod in pending:
                self.on_pod_pending(pod)
        if relevant_events:
            if self.on_change_batch is not None:
                self.on_change_batch(relevant_events)
            elif self.on_change is not None:
                for event in relevant_events:
                    self.on_change(event)

    def _handle_pvc(self, event: Event) -> None:
        if event.type == "synced":
            # KubeCluster emits this after a successful PVC LIST: the
            # watch is genuinely live (RBAC granted), so an empty store now
            # means "no claims exist" and enforcement is on. Without it
            # (403: missing ClusterRole rule) volume constraints degrade to
            # not-enforced instead of parking every PVC-referencing pod on
            # "claim not found".
            self.watches_pvcs = True
            self._batch_dirty = True
            return
        pvc: K8sPvc = event.obj  # type: ignore[assignment]
        if event.type == "deleted":
            self._pvcs.pop(pvc.key, None)
        else:
            self._pvcs[pvc.key] = pvc
        self._batch_dirty = True

    def _handle_pv(self, event: Event) -> None:
        if event.type == "synced":
            self.watches_pvs = True
            self._batch_dirty = True
            return
        pv: K8sPv = event.obj  # type: ignore[assignment]
        if event.type == "deleted":
            self._pvs.pop(pv.name, None)
        else:
            self._pvs[pv.name] = pv
        self._batch_dirty = True

    def _handle_pdb(self, event: Event) -> None:
        if event.type == "synced":
            # PDB LIST succeeded (RBAC granted): enforcement on, as for
            # _handle_pvc's sentinel.
            self.watches_pdbs = True
            return
        pdb: K8sPdb = event.obj  # type: ignore[assignment]
        if event.type == "deleted":
            self._pdbs.pop(pdb.key, None)
        else:
            self._pdbs[pdb.key] = pdb
        # No version bump: budgets steer victim PREFERENCE inside
        # preemption, not filtering or scoring.

    def _handle_namespace(self, event: Event) -> None:
        ns = event.obj
        if event.type == "deleted":
            self._namespaces.pop(ns.name, None)
        else:
            self._namespaces[ns.name] = dict(ns.labels)
        self._batch_dirty = True

    def _handle_node(self, event: Event) -> None:
        node: K8sNode = event.obj  # type: ignore[assignment]
        self._node_informed = True
        if event.type == "deleted":
            self._nodes.pop(node.name, None)
        else:
            self._nodes[node.name] = node
        self._ni_cache.pop(node.name, None)
        self._batch_dirty = True
        # EVERY Node event (modified included) feeds the admission ring:
        # cordon/taint/label flips change admission verdicts even though
        # the metrics arrays don't care.
        self._note_admission(node.name)
        if event.type in ("added", "deleted"):
            # The candidate-node SET changed, which invalidates the fleet
            # arrays keyed on metrics_version. A cordon/taint flip does
            # not: admission is evaluated per cycle, not baked into arrays.
            self._batch_metrics.append(("structural", node.name))

    def _handle_tpu(self, event: Event) -> bool:
        """Returns whether the event carries schedulability-relevant change.
        A value-identical republish refreshes the stored timestamp and the
        snapshot, but does NOT bump ``metrics_version`` — unless the node
        had gone STALE, whose refresh changes feasibility."""
        tpu: TpuNodeMetrics = event.obj  # type: ignore[assignment]
        if event.type == "deleted":
            if self._tpus.pop(tpu.name, None) is not None:
                i = bisect.bisect_left(self._tpu_order, tpu.name)
                if i < len(self._tpu_order) and self._tpu_order[i] == tpu.name:
                    del self._tpu_order[i]
            relevant = structural = True
        else:
            prev = self._tpus.get(tpu.name)
            self._tpus[tpu.name] = tpu
            if prev is None:
                bisect.insort(self._tpu_order, tpu.name)
            structural = prev is None  # CR added: node set changed
            relevant = prev is None or not prev.values_equal(tpu)
            if not relevant and self.staleness_s > 0:
                age = self.now_fn() - prev.last_updated_unix
                relevant = age > self.staleness_s  # was stale: now fresh
        self._ni_cache.pop(tpu.name, None)
        self._batch_dirty = True
        if relevant:
            self._batch_metrics.append(
                ("structural" if structural else "modified", tpu.name)
            )
        return relevant

    def _handle_pod(self, event: Event) -> None:
        pod: PodSpec = event.obj  # type: ignore[assignment]
        if event.type == "deleted":
            self._live_uids.discard(pod.uid)
        else:
            self._live_uids.add(pod.uid)
        counted = self._pod_nodes.get(pod.uid)
        if counted and (event.type == "deleted" or counted[0] != pod.node_name):
            self._uncount_pod(pod.uid)
            counted = None
        if event.type != "deleted" and pod.node_name and counted is None:
            self._count_pod(pod, pod.node_name)
        ours_unbound = (
            event.type != "deleted"
            and pod.node_name is None
            and pod.scheduler_name == self.scheduler_name
        )
        if event.type == "deleted":
            self._gated_uids.discard(pod.uid)
        elif ours_unbound and pod.scheduling_gates:
            self._gated_uids.add(pod.uid)  # held, not schedulable
        elif event.type == "added" and ours_unbound:
            if self._routes_here(pod):
                self._batch_pending.append(pod)
        elif (
            event.type == "modified"
            and ours_unbound
            and pod.uid in self._gated_uids
        ):
            # Gates cleared: NOW the pod becomes schedulable.
            self._gated_uids.discard(pod.uid)
            if self._routes_here(pod):
                self._batch_pending.append(pod)
        self._batch_dirty = True

    def _routes_here(self, pod: PodSpec) -> bool:
        """Does this pending pod belong to THIS informer's scheduling
        queue? True without a route hook (unsharded). Fail closed on a
        raising hook — two shards queueing one pod is the double-bind the
        router exists to prevent; the router's own fallback (global lane)
        catches unroutable pods before this can drop them."""
        fn = self.pod_route_fn
        if fn is None:
            return True
        try:
            return bool(fn(pod))
        except Exception:  # noqa: BLE001 — fail closed (see docstring)
            return False

    def _count_pod(self, pod: PodSpec, node: str) -> None:
        claim = _pod_claim_mib(pod)
        self._pods_by_node.setdefault(node, {})[pod.uid] = pod
        self._pod_nodes[pod.uid] = (node, claim)
        self._claimed_mib[node] = self._claimed_mib.get(node, 0) + claim
        self._ni_cache.pop(node, None)
        self._note_pod_set(node, claim)

    def _uncount_pod(self, uid: str) -> None:
        node, claim = self._pod_nodes.pop(uid)
        self._pods_by_node.get(node, {}).pop(uid, None)
        self._claimed_mib[node] = max(self._claimed_mib.get(node, 0) - claim, 0)
        self._ni_cache.pop(node, None)
        self._note_pod_set(node, claim)

    def _note_admission(self, node: str) -> None:
        self._admission_epoch += 1
        self._admission_ring.append((self._admission_epoch, node))

    def _note_pod_set(self, node: str, claim: int) -> None:
        """A pod joined or left ``node``: its admission inputs (pod count,
        cpu, memory, host ports) moved, and its claimed-HBM total too when
        the pod claims any."""
        self._note_admission(node)
        if claim:
            self._claim_epoch += 1
            self._claim_ring.append((self._claim_epoch, node))

    # --- readers ---

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def metrics_version(self) -> int:
        with self._lock:
            return self._metrics_version

    def changes_since(self, epoch: int) -> "FleetDelta | None":
        """The epoch/delta feed over ``metrics_version``: which nodes
        changed in epochs ``(epoch, current]``. None when the consumer is
        too far behind (the bounded ring no longer covers its epoch) or
        ahead (epoch skew, e.g. state inherited from another informer):
        either way it must re-stack from a snapshot."""
        with self._lock:
            cur = self._metrics_version
            if epoch == cur:
                return FleetDelta(cur, frozenset(), False)
            if epoch > cur or not self._delta_ring:
                return None
            if self._delta_ring[0][0] > epoch + 1:
                return None  # ring evicted past the consumer's epoch
            changed: set[str] = set()
            structural = False
            node_filter = self.node_filter_fn
            for e, kind, name in reversed(self._delta_ring):
                if e <= epoch:
                    break
                if node_filter is not None:
                    # Shard partition: another shard's node changing must
                    # not force THIS shard's resident arrays to re-stack
                    # (a foreign name is absent from this snapshot, which
                    # the consumer treats as epoch skew). A node the
                    # filter cannot resolve anymore (CR deleted) stays
                    # relevant — the restack it forces is the safe path.
                    tpu = self._tpus.get(name)
                    if tpu is not None and not node_filter(name, tpu):
                        continue
                if kind == "structural":
                    structural = True
                else:
                    changed.add(name)
            return FleetDelta(cur, frozenset(changed), structural)

    @property
    def claimed_epoch(self) -> int:
        with self._lock:
            return self._claim_epoch

    def claimed_changes_since(
        self, epoch: int
    ) -> "tuple[int, dict[str, int] | None]":
        """Delta feed over the per-node claimed-HBM totals: ``(current
        epoch, {node: claimed_mib})`` for nodes whose total changed in
        epochs ``(epoch, current]``, or ``(current epoch, None)`` when the
        ring no longer reaches back (or the consumer is ahead): the
        consumer then rebuilds from :meth:`claimed_hbm_mib_map`."""
        with self._lock:
            cur = self._claim_epoch
            nodes = ring_since(self._claim_ring, epoch, cur)
            if nodes is None:
                return cur, None
            return cur, {n: self._claimed_mib.get(n, 0) for n in nodes}

    @property
    def admission_epoch(self) -> int:
        with self._lock:
            return self._admission_epoch

    def admission_changes_since(
        self, epoch: int
    ) -> "tuple[int, frozenset[str] | None]":
        """Delta feed over admission-relevant node state (Node-object events
        and per-node pod-set changes — what the metrics ring elides that
        can still flip an admission verdict): ``(current epoch,
        changed_nodes)`` for epochs ``(epoch, current]``, or ``(current
        epoch, None)`` when the ring no longer reaches back (or the
        consumer is ahead). Consumers read the snapshot-stamped epoch
        (``snapshot.admission_epoch``), not this live one, so a patched
        vector is exactly as fresh as the snapshot it was patched from."""
        with self._lock:
            cur = self._admission_epoch
            nodes = ring_since(self._admission_ring, epoch, cur)
            return cur, None if nodes is None else frozenset(nodes)

    def claimed_hbm_mib(self, node_name: str) -> int:
        with self._lock:
            return self._claimed_mib.get(node_name, 0)

    def claimed_hbm_mib_map(self) -> dict[str, int]:
        """One consistent copy under a single lock acquisition."""
        with self._lock:
            return dict(self._claimed_mib)

    def last_event_age_s(self) -> "float | None":
        """Seconds since the last watch event of any kind reached this
        cache, or None before the first event (a stack built list-then-
        watch replays existing objects, so None means the watch source
        never delivered anything at all). The federation health monitor's
        primary staleness signal — a partitioned API server goes silent
        here long before a probe times out — and a probe for stuck watch
        streams (climbing while the cluster churns = the watch is dead,
        not the cluster quiet)."""
        with self._lock:
            if self._last_event_mono is None:
                return None
            return max(self.mono_fn() - self._last_event_mono, 0.0)

    def last_updated_map(self) -> dict[str, float]:
        """Live per-node metric timestamps — the freshness source for the
        evaluation's dynamics row (heartbeats do not bump the metrics
        version, so cached arrays carry stale timestamps)."""
        with self._lock:
            return {
                name: t.last_updated_unix for name, t in self._tpus.items()
            }

    def list_pdbs(self) -> "list[K8sPdb] | None":
        """The cached PodDisruptionBudgets, or None when no budget watch is
        live (preemption then skips the violation preference entirely —
        distinct from an empty list, which means no budgets exist)."""
        with self._lock:
            if not (self.watches_pdbs or self._pdbs):
                return None
            return list(self._pdbs.values())

    def pod_alive(self, pod: PodSpec) -> bool:
        """False once the watch saw the pod's deletion (by uid)."""
        with self._lock:
            return pod.uid in self._live_uids

    def counts_bound(self, uid: str) -> bool:
        """True when this cache charges the pod to a node — the failover
        reconciler compares this against cluster truth to find GHOST
        bindings (bind events the watch stream dropped)."""
        with self._lock:
            return uid in self._pod_nodes

    def live_uid_set(self) -> set[str]:
        """Every pod uid the cache believes alive (any phase, any node).
        A uid here that cluster truth lacks is a dropped deletion."""
        with self._lock:
            return set(self._live_uids)

    def pod_schedulable(self, pod: PodSpec) -> bool:
        """Should a popped queue entry actually be scheduled? False for
        deleted pods, pods already counted as BOUND, and pods held by
        scheduling gates."""
        with self._lock:
            return (
                pod.uid in self._live_uids
                and pod.uid not in self._pod_nodes
                and pod.uid not in self._gated_uids
            )

    def snapshot(self) -> Snapshot:
        """Consistent view for one scheduling cycle. Cached until the next
        watch event; NodeInfo pod lists are copies, safe across threads."""
        with self._lock:
            if self._snapshot_cache is not None:
                return self._snapshot_cache
            cache = self._ni_cache
            nodes = {}
            order: list[str] = []
            node_filter = self.node_filter_fn
            for name in self._tpu_order:
                tpu = self._tpus[name]
                # Once Node-informed, a CR whose Node is gone is a deleted
                # node: never a candidate.
                if self._node_informed and name not in self._nodes:
                    continue
                # Shard partition: a sharded stack's snapshot carries only
                # its own nodes (the filter is a pure function of the
                # slice/pool assignment, so the partition is identical
                # across rebuilds until shard_count itself changes).
                if node_filter is not None and not node_filter(name, tpu):
                    continue
                ni = cache.get(name)
                if ni is None or ni.tpu is not tpu:
                    ni = NodeInfo(
                        name=name,
                        tpu=tpu,
                        pods=list(self._pods_by_node.get(name, {}).values()),
                        node=self._nodes.get(name),
                    )
                    cache[name] = ni
                nodes[name] = ni
                order.append(name)
            snap = Snapshot(
                nodes,
                order=order,
                version=self._version,
                namespaces=self._namespaces or None,
                pvcs=self._pvcs if (self.watches_pvcs or self._pvcs) else None,
                pvs=self._pvs if (self.watches_pvs or self._pvs) else None,
            )
            snap.metrics_version = self._metrics_version
            # The admission-feed epoch AT BUILD, under the same lock: a
            # consumer that patches a cached vector from this snapshot
            # stamps this epoch, so events landing after the build are
            # re-applied on the next patch instead of skipped.
            snap.admission_epoch = self._admission_epoch
            if self.fence_fn is not None:
                try:
                    snap.fenced = frozenset(self.fence_fn())
                except Exception:  # noqa: BLE001 — a bad hook must not
                    pass           # wedge snapshot builds; fail open
            self._snapshot_cache = snap
            return snap

    def invalidate_snapshot(self) -> None:
        """An EXTERNAL schedulability input changed (the node health
        monitor's fence set): bump the snapshot version and drop the cached
        snapshot so the next cycle rebuilds it, and with it the
        per-snapshot admission rows. ``metrics_version`` is NOT bumped: the
        fleet arrays are fence-independent (the veto rides the host_ok
        row, not the static arrays), so a fence flip never re-stacks."""
        with self._lock:
            self._version += 1
            self._snapshot_cache = None


def ring_since(ring: deque, epoch: int, cur: int) -> "set[str] | None":
    """The nodes of an ``(epoch, node)`` ring entered in epochs ``(epoch,
    cur]``; None when the ring cannot answer (consumer ahead, or the ring
    evicted past its epoch)."""
    if epoch == cur:
        return set()
    if epoch > cur or not ring or ring[0][0] > epoch + 1:
        return None
    nodes: set[str] = set()
    for e, name in reversed(ring):
        if e <= epoch:
            break
        nodes.add(name)
    return nodes


def _pod_claim_mib(pod: PodSpec) -> int:
    try:
        r = pod_request(pod)
    except LabelParseError:
        return 0
    return (r.hbm_per_chip // MIB) * r.effective_chips
