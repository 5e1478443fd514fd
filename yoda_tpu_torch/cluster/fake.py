"""In-memory fake API server with watch semantics.

Stores pods, TpuNodeMetrics CRs, Node, Namespace, PersistentVolumeClaim,
PersistentVolume and PodDisruptionBudget objects, delivers create/update/
delete events to watchers synchronously (the informer), and implements pod
binding — the subset of the Kubernetes API the scheduler touches.
Thread-safe.

Counterpart of ``yoda_tpu/cluster/fake.py``, ported as far as the
singleton, gang, preemption, affinity and volume paths reach it: eviction
(``evict_pod``, refused where a stored budget would be violated or for the
keys in ``eviction_blocked``) and the nomination status patch
(``set_nominated_node``), and the watch-drop injection the reconciler's
tests use (``suppress_kinds``), and the node-death helpers the health
monitor's tests drive (``set_node_ready``, ``kill_node``, ``delete_node``),
and the Events the recorder writes (``write_event`` / ``list_events``),
and the federation health monitor's signals (``last_event_age_s``, the
age of the last delivered event, and ``probe``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Literal

from yoda_tpu_torch.api.types import (
    K8sNamespace,
    K8sNode,
    K8sPdb,
    K8sPv,
    K8sPvc,
    PodSpec,
    TpuNodeMetrics,
)

# "synced" is a per-kind liveness sentinel a real API server's client emits
# once a kind's LIST succeeded; this store never emits one, but batched
# ingest passes such sentinels through as barriers.
EventType = Literal["added", "modified", "deleted", "synced"]


@dataclass(frozen=True)
class Event:
    type: EventType
    kind: str  # "Pod" | "TpuNodeMetrics" | "Node" | "Namespace" | ...
    obj: object


class FakeCluster:
    def __init__(self, *, bind_latency_s: float = 0.0) -> None:
        # Injectable per-bind latency: emulates the API round-trip a real
        # pods/binding POST costs. Slept OUTSIDE the store lock.
        self.bind_latency_s = bind_latency_s
        self._lock = threading.RLock()
        self._pods: dict[str, PodSpec] = {}
        self._tpus: dict[str, TpuNodeMetrics] = {}
        self._nodes: dict[str, K8sNode] = {}
        self._namespaces: dict[str, K8sNamespace] = {}
        self._pvcs: dict[str, K8sPvc] = {}  # "namespace/name" -> claim
        self._pvs: dict[str, K8sPv] = {}    # name -> persistent volume
        self._events: dict[str, dict] = {}  # namespace/name -> Event object
        self._pdbs: dict[str, K8sPdb] = {}  # "namespace/name" -> budget
        # Evictions consumed against a PUBLISHED status.disruptionsAllowed
        # since the budget object last changed: the real API decrements the
        # status as it admits evictions. Reset by put_pdb (the disruption
        # controller republishing).
        self._pdb_used: dict[str, int] = {}
        self._watchers: list[Callable[[Event], None]] = []
        self._rv = 0
        # Pod keys whose eviction a PodDisruptionBudget would block (tests).
        self.eviction_blocked: set[str] = set()
        # Monotonic instant of the last event DELIVERED to watchers (not
        # suppressed ones): the cluster-side half of the watch staleness
        # clock the federation health monitor reads.
        self._last_emit_mono: float | None = None
        # Watch-drop injection (reconciler tests): events of these kinds
        # mutate the store but are NOT delivered to watchers — the store
        # (cluster truth) and the informer caches diverge exactly the way a
        # dropped watch stream makes them diverge, and the drift
        # reconciler's repair is what re-converges them.
        self.suppress_kinds: set[str] = set()

    # --- watch ---

    def add_watcher(
        self,
        fn: Callable[[Event], None],
        *,
        replay: bool = True,
        batch_fn: "Callable[[list[Event]], None] | None" = None,
    ) -> None:
        """Register a watcher; with ``replay`` it first receives synthetic
        'added' events for existing objects (list-then-watch semantics),
        as ONE list call to ``batch_fn`` when given. Live mutations
        deliver per-event via ``fn``."""
        with self._lock:
            self._watchers.append(fn)
            if replay:
                events = self._replay_events()
                if batch_fn is not None:
                    batch_fn(events)
                else:
                    for event in events:
                        fn(event)

    def remove_watcher(self, fn: Callable[[Event], None]) -> None:
        """Unregister a watcher (live shard resize retiring a dissolved
        lane's informer chain). Unknown fns are ignored — removal must
        be idempotent across partially-wired stacks."""
        with self._lock:
            try:
                self._watchers.remove(fn)
            except ValueError:
                pass

    def _replay_events(self) -> "list[Event]":
        return (
            [Event("added", "Namespace", ns) for ns in self._namespaces.values()]
            + [Event("added", "PersistentVolumeClaim", c) for c in self._pvcs.values()]
            + [Event("added", "PersistentVolume", pv) for pv in self._pvs.values()]
            + [Event("added", "PodDisruptionBudget", b) for b in self._pdbs.values()]
            + [Event("added", "Node", node) for node in self._nodes.values()]
            + [Event("added", "TpuNodeMetrics", t) for t in self._tpus.values()]
            + [Event("added", "Pod", pod) for pod in self._pods.values()]
        )

    def _emit(self, event: Event) -> None:
        if event.kind in self.suppress_kinds:
            return  # injected watch drop: store updated, stream silent
        self._last_emit_mono = time.monotonic()
        for fn in list(self._watchers):
            fn(event)

    def last_event_age_s(self) -> "float | None":
        """Seconds since an event was last delivered to watchers (None
        before the first): the health monitor's watch-staleness signal."""
        with self._lock:
            if self._last_emit_mono is None:
                return None
            return max(time.monotonic() - self._last_emit_mono, 0.0)

    def probe(self) -> None:
        """Cheap liveness probe (federation health monitor): an in-memory
        store is reachable by construction. Fault-injecting fronts
        (testing.chaos.ChaosCluster) override this to raise while the
        cluster is partitioned or lost."""
        with self._lock:
            pass

    # --- pods ---

    def create_pod(self, pod: PodSpec) -> PodSpec:
        with self._lock:
            if pod.key in self._pods:
                raise ValueError(f"pod {pod.key} already exists")
            self._pods[pod.key] = pod
            self._emit(Event("added", "Pod", pod))
            return pod

    def bind_pod(self, pod_key: str, node_name: str) -> None:
        """The pods/binding subresource."""
        if self.bind_latency_s > 0:
            time.sleep(self.bind_latency_s)
        with self._lock:
            pod = self._pods[pod_key]
            if pod.node_name is not None and pod.node_name != node_name:
                raise ValueError(
                    f"pod {pod_key} already bound to {pod.node_name}"
                )
            pod.node_name = node_name
            pod.phase = "Running"
            self._emit(Event("modified", "Pod", pod))

    def unbind_pod(self, pod_key: str, node_name: str) -> None:
        """Reverse a binding (gang transactional rollback). Only the named
        node's binding is cleared — a pod re-bound elsewhere concurrently
        is left alone. Missing pods are a no-op (deleted mid-rollback)."""
        with self._lock:
            pod = self._pods.get(pod_key)
            if pod is None or pod.node_name != node_name:
                return
            pod.node_name = None
            pod.phase = "Pending"
            self._emit(Event("modified", "Pod", pod))

    def update_pod(self, pod: PodSpec) -> None:
        """Replace an existing pod's spec (e.g. a controller clearing
        spec.schedulingGates) and emit the modified event. Object identity
        (uid, arrival order) is preserved from the stored pod."""
        with self._lock:
            old = self._pods.get(pod.key)
            if old is None:
                raise KeyError(pod.key)
            pod.uid = old.uid
            pod.creation_seq = old.creation_seq
            self._pods[pod.key] = pod
            self._emit(Event("modified", "Pod", pod))

    def delete_pod(self, pod_key: str) -> None:
        with self._lock:
            pod = self._pods.pop(pod_key, None)
            if pod is not None:
                self._emit(Event("deleted", "Pod", pod))

    def set_nominated_node(self, pod_key: str, node_name: str | None) -> None:
        """The pods/status nominatedNodeName patch, fake-side (no-op for
        missing pods)."""
        with self._lock:
            pod = self._pods.get(pod_key)
            if pod is None:
                return
            pod.nominated_node_name = node_name
            self._emit(Event("modified", "Pod", pod))

    def evict_pod(self, pod_key: str) -> bool:
        """The pods/eviction subresource, fake-side: deletes unless the
        eviction would violate a stored PodDisruptionBudget (the real API
        server's enforcement) or the test marked the pod protected via
        ``eviction_blocked`` (False: the eviction was refused)."""
        with self._lock:
            if pod_key in self.eviction_blocked:
                return False
            pod = self._pods.get(pod_key)
            consumed: list[str] = []
            if pod is not None:
                for pdb in self._pdbs.values():
                    if not pdb.matches(pod):
                        continue
                    # Only BOUND pods count toward the budget (the real API
                    # derives disruptionsAllowed from running pods: a
                    # pending replica protects nothing).
                    matching = sum(
                        1 for p in self._pods.values() if p.node_name and pdb.matches(p)
                    )
                    allowed = pdb.allowed_disruptions(matching) - self._pdb_used.get(
                        pdb.key, 0
                    )
                    if allowed < 1:
                        return False
                    consumed.append(pdb.key)
                for key in consumed:
                    # Decrement only budgets with a PUBLISHED status (the
                    # derived path self-corrects via the matching count).
                    if self._pdbs[key].disruptions_allowed is not None:
                        self._pdb_used[key] = self._pdb_used.get(key, 0) + 1
        self.delete_pod(pod_key)
        return True

    def get_pod(self, pod_key: str) -> PodSpec | None:
        with self._lock:
            return self._pods.get(pod_key)

    def list_pods(self) -> list[PodSpec]:
        with self._lock:
            return list(self._pods.values())

    # --- TpuNodeMetrics CRs (written by the node agent) ---

    def put_tpu_metrics(self, tpu: TpuNodeMetrics) -> None:
        with self._lock:
            self._rv += 1
            tpu.resource_version = self._rv
            is_new = tpu.name not in self._tpus
            self._tpus[tpu.name] = tpu
            self._emit(Event("added" if is_new else "modified", "TpuNodeMetrics", tpu))

    def delete_tpu_metrics(self, name: str) -> None:
        with self._lock:
            tpu = self._tpus.pop(name, None)
            if tpu is not None:
                self._emit(Event("deleted", "TpuNodeMetrics", tpu))

    def list_tpu_metrics(self) -> list[TpuNodeMetrics]:
        with self._lock:
            return list(self._tpus.values())

    # --- Events (written by cluster.events.EventRecorder) ---

    def write_event(self, obj: dict, update: bool = False) -> None:
        md = obj.get("metadata", {})
        key = f"{md.get('namespace', 'default')}/{md['name']}"
        with self._lock:
            self._events[key] = obj

    def list_events(self) -> list[dict]:
        with self._lock:
            return list(self._events.values())

    # --- Namespaces, volumes and disruption budgets ---

    def put_namespace(self, ns: K8sNamespace) -> None:
        with self._lock:
            is_new = ns.name not in self._namespaces
            self._namespaces[ns.name] = ns
            self._emit(Event("added" if is_new else "modified", "Namespace", ns))

    def delete_namespace(self, name: str) -> None:
        with self._lock:
            ns = self._namespaces.pop(name, None)
            if ns is not None:
                self._emit(Event("deleted", "Namespace", ns))

    def put_pvc(self, pvc: K8sPvc) -> None:
        with self._lock:
            is_new = pvc.key not in self._pvcs
            self._pvcs[pvc.key] = pvc
            self._emit(
                Event("added" if is_new else "modified", "PersistentVolumeClaim", pvc)
            )

    def delete_pvc(self, key: str) -> None:
        with self._lock:
            pvc = self._pvcs.pop(key, None)
            if pvc is not None:
                self._emit(Event("deleted", "PersistentVolumeClaim", pvc))

    def put_pv(self, pv: K8sPv) -> None:
        with self._lock:
            is_new = pv.name not in self._pvs
            self._pvs[pv.name] = pv
            self._emit(Event("added" if is_new else "modified", "PersistentVolume", pv))

    def delete_pv(self, name: str) -> None:
        with self._lock:
            pv = self._pvs.pop(name, None)
            if pv is not None:
                self._emit(Event("deleted", "PersistentVolume", pv))

    def put_pdb(self, pdb: K8sPdb) -> None:
        with self._lock:
            is_new = pdb.key not in self._pdbs
            self._pdbs[pdb.key] = pdb
            self._pdb_used.pop(pdb.key, None)  # controller republished
            self._emit(
                Event("added" if is_new else "modified", "PodDisruptionBudget", pdb)
            )

    def delete_pdb(self, key: str) -> None:
        with self._lock:
            pdb = self._pdbs.pop(key, None)
            if pdb is not None:
                self._emit(Event("deleted", "PodDisruptionBudget", pdb))

    def list_pdbs(self) -> list[K8sPdb]:
        with self._lock:
            return list(self._pdbs.values())

    # --- Node objects (cordon / taints / lifecycle) ---

    def put_node(self, node: K8sNode) -> None:
        with self._lock:
            is_new = node.name not in self._nodes
            self._nodes[node.name] = node
            self._emit(Event("added" if is_new else "modified", "Node", node))

    def set_node_ready(self, name: str, ready: bool) -> None:
        """Node-condition helper: flip the stored Node's Ready condition
        (what the node controller does when a kubelet stops responding),
        creating a bare Node object if none exists. The node health monitor
        treats NotReady as DOWN."""
        with self._lock:
            node = self._nodes.get(name) or K8sNode(name=name)
            node.ready = ready
        self.put_node(node)

    def kill_node(self, name: str) -> None:
        """Full host death in one call: the Node object AND the TPU CR
        deleted (a cloud provider's node deletion on the watch stream).
        Bound pods stay in place — node GC owns them; the health monitor's
        ghost release and repair handle the fallout."""
        self.delete_node(name)
        self.delete_tpu_metrics(name)

    def delete_node(self, name: str) -> None:
        with self._lock:
            node = self._nodes.pop(name, None)
            if node is not None:
                self._emit(Event("deleted", "Node", node))

    def list_nodes(self) -> list[K8sNode]:
        with self._lock:
            return list(self._nodes.values())
