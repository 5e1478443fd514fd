"""In-memory fake API server with watch semantics.

Stores pods, TpuNodeMetrics CRs and Node objects, delivers create/update/
delete events to watchers synchronously (the informer), and implements pod
binding — the subset of the Kubernetes API the scheduler touches.
Thread-safe.

Counterpart of ``yoda_tpu/cluster/fake.py``, ported as far as the
singleton path reaches it. Left out until a later slice: the Namespace /
PersistentVolumeClaim / PersistentVolume / PodDisruptionBudget stores,
eviction and nomination (preemption), Events, node-death helpers and the
watch-drop / staleness probes.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Literal

from yoda_tpu_torch.api.types import K8sNode, PodSpec, TpuNodeMetrics

EventType = Literal["added", "modified", "deleted"]


@dataclass(frozen=True)
class Event:
    type: EventType
    kind: str  # "Pod" | "TpuNodeMetrics" | "Node"
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
        self._watchers: list[Callable[[Event], None]] = []
        self._rv = 0

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

    def _replay_events(self) -> "list[Event]":
        return (
            [Event("added", "Node", node) for node in self._nodes.values()]
            + [Event("added", "TpuNodeMetrics", t) for t in self._tpus.values()]
            + [Event("added", "Pod", pod) for pod in self._pods.values()]
        )

    def _emit(self, event: Event) -> None:
        for fn in list(self._watchers):
            fn(event)

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

    # --- Node objects (cordon / taints / lifecycle) ---

    def put_node(self, node: K8sNode) -> None:
        with self._lock:
            is_new = node.name not in self._nodes
            self._nodes[node.name] = node
            self._emit(Event("added" if is_new else "modified", "Node", node))
