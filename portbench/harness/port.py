"""The benchmark's side of the system under test: the cluster objects it
publishes, the stack it builds and the log it keeps of the cluster's watch.

This is the only module of the harness that imports the program
(``yoda_tpu_torch``), and it takes from it only the stack, its cluster
API, its metrics exposition and its counters.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from portbench.harness.fleet import GIB, Fleet, Prefill, PodReq
from portbench.harness.reference import LogEvent

HOST_KEY = "kubernetes.io/hostname"
ZONE_KEY = "topology.kubernetes.io/zone"


def labels_of(req: PodReq, topology: str = "2x2x1") -> dict:
    """The pod labels that carry ``req`` to the scheduler."""
    lab: dict[str, str] = {"tpu/chips": str(req.chips)}
    if req.hbm_gib:
        lab["tpu/hbm"] = f"{req.hbm_gib}Gi"
    if req.clock_mhz:
        lab["tpu/clock"] = str(req.clock_mhz)
    if req.generation:
        lab["tpu/generation"] = req.generation
    if req.gang_kind == "cosched":
        lab["pod-group.scheduling.sigs.k8s.io/name"] = req.gang
        lab["pod-group.scheduling.sigs.k8s.io/min-available"] = str(req.gang_size)
    elif req.gang_kind == "plain":
        lab["tpu/gang"] = req.gang
        lab["tpu/gang-size"] = str(req.gang_size)
    elif req.gang_kind in ("topology", "multislice"):
        lab["tpu/gang"] = req.gang
        lab["tpu/topology"] = topology
        if req.gang_kind == "multislice":
            lab["tpu/multislice"] = str(req.gang_size // 4)
    return lab


def pod_spec(req: PodReq, node: "str | None" = None):
    """A PodSpec for ``req``; bound to ``node`` when given (pre-fill)."""
    from yoda_tpu_torch.api.types import PodSpec

    ns, name = req.key.split("/", 1)
    pod = PodSpec(name, namespace=ns, labels=labels_of(req))
    if node is not None:
        pod.node_name = node
        pod.phase = "Running"
    return pod


def publish(cluster, fleet: Fleet, prefill: Prefill, now_unix: float, *,
            nodes: bool = True) -> None:
    """Every host's Node object (unless ``nodes`` is False) and TPU metrics
    CR stamped ``now_unix``, the pre-fill's held chips showing their used
    HBM. Publishing the same values again is the agents' heartbeat."""
    from yoda_tpu_torch.api.types import HEALTHY, K8sNode, TpuChip, TpuNodeMetrics

    for h in fleet.hosts if nodes else ():
        cluster.put_node(K8sNode(h.name, labels={
            HOST_KEY: h.name, ZONE_KEY: fleet.zones[h.zone],
            "cloud.google.com/gke-tpu-accelerator": h.accel_type,
        }))
    for h in fleet.hosts:
        s = fleet.spec[h.generation]
        total = s["hbm_gib"] * GIB
        held = prefill.used.get(h.name, [])
        chips = [
            TpuChip(
                index=j, health=HEALTHY,
                hbm_free=max(total - held[j], 0) if j < len(held) else total,
                hbm_total=total, clock_mhz=s["clock_mhz"],
                hbm_bandwidth_gbps=s["hbm_bandwidth_gbps"],
                tflops_bf16=s["tflops_bf16"], power_w=s["power_w"],
            )
            for j in range(h.chips)
        ]
        cluster.put_tpu_metrics(TpuNodeMetrics(
            name=h.name, chips=chips, generation=h.generation,
            accel_type=h.accel_type, slice_id=h.slice_id,
            topology_coords=tuple(h.coords), last_updated_unix=now_unix,
        ))


class Recorder:
    """The cluster watcher that logs every pod's creation, bind and
    deletion in the order the cluster applied them, and keeps the live
    view the traffic reads (bound pods, pending pods, chips held per host).
    It runs inside the cluster's emit, under its lock: it only appends."""

    def __init__(self, reqs: dict, chips_of_host: dict) -> None:
        self.reqs = reqs
        self.events: list[LogEvent] = []
        self.cond = threading.Condition()
        self.node_of: dict[str, str] = {}
        self.pending: set[str] = set()
        self.held = dict.fromkeys(chips_of_host, 0)
        self.held_total = 0

    def __call__(self, event) -> None:
        if event.kind != "Pod":
            return
        pod = event.obj
        key = pod.key
        req = self.reqs.get(key)
        if req is None:
            return
        t, unix = time.monotonic(), time.time()
        chips = max(req.chips, 1)
        with self.cond:
            if event.type == "deleted":
                node = self.node_of.pop(key, None)
                self.pending.discard(key)
                if node is not None:
                    self.held[node] -= chips
                    self.held_total -= chips
                self.events.append(LogEvent(t, unix, "delete", key))
            elif pod.node_name and key not in self.node_of:
                node = pod.node_name
                self.node_of[key] = node
                self.pending.discard(key)
                self.held[node] += chips
                self.held_total += chips
                if event.type == "added":
                    self.events.append(LogEvent(t, unix, "add", key, node))
                else:
                    self.events.append(LogEvent(t, unix, "bind", key, node))
            elif not pod.node_name and key in self.node_of:
                node = self.node_of.pop(key)
                self.held[node] -= chips
                self.held_total -= chips
                self.pending.add(key)
                self.events.append(LogEvent(t, unix, "delete", key))
            elif event.type == "added":
                self.pending.add(key)
                self.events.append(LogEvent(t, unix, "add", key))
            else:
                return
            self.cond.notify_all()


def build(settings: dict, fleet: Fleet, prefill: Prefill, reqs: dict, *,
          platform: "str | None" = None):
    """The cluster and the stack: the cluster holds every Node, CR and
    pre-fill pod before the stack is built on it (list, then watch).
    Returns (cluster, stack, recorder)."""
    from yoda_tpu_torch.cluster.fake import FakeCluster
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.standalone import build_stack

    config = SchedulerConfig.from_dict(settings)
    if platform is not None:
        config = dataclasses.replace(config, kernel_platform=platform)
    cluster = FakeCluster()
    recorder = Recorder(reqs, {h.name: h.chips for h in fleet.hosts})
    cluster.add_watcher(recorder)
    publish(cluster, fleet, prefill, time.time())
    for req, node in prefill.pods:
        cluster.create_pod(pod_spec(req, node))
    stack = build_stack(cluster, config)
    return cluster, stack, recorder


def latency_series(stack) -> dict:
    """(sum seconds, count) of each phase of the program's own
    ``yoda_scheduling_latency_seconds`` histogram, read from its metrics
    exposition."""
    out: dict[str, list] = {}
    prefix = "yoda_scheduling_latency_seconds_"
    for line in stack.metrics.latency.render():
        if not line.startswith(prefix):
            continue
        head, value = line.rsplit(" ", 1)
        kind = head[len(prefix):].split("{", 1)[0]
        if kind not in ("sum", "count") or 'phase="' not in head:
            continue
        phase = head.split('phase="', 1)[1].split('"', 1)[0]
        slot = out.setdefault(phase, [0.0, 0])
        if kind == "sum":
            slot[0] = float(value)
        else:
            slot[1] = int(float(value))
    return out
