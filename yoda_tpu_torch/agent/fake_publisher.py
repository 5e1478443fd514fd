"""Fake TPU node agent: publishes synthetic TpuNodeMetrics CRs.

Plays the role of the per-node metrics DaemonSet for kind-style clusters
(BASELINE configs: "1-node kind cluster with fake SCV/TPU CR"). Simulates
HBM consumption: on ``refresh``, free HBM per chip reflects the pods bound to
the host (greedy whole-chip assignment, mirroring the exclusive-chip model of
the accountant).

Counterpart of ``yoda_tpu/agent/fake_publisher.py``, whole: with the
node-death and chip-degrade injections the node health monitor's tests
drive (``stop_heartbeat`` / ``resume_heartbeat``, ``fail_chips`` /
``heal_chips``).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass

from yoda_tpu_torch.api.requests import LabelParseError, pod_request
from yoda_tpu_torch.api.types import HEALTHY, TpuChip, TpuNodeMetrics

GIB = 1 << 30


def charge_bound_pods(free: list[int], pods, node_name: str) -> None:
    """Attribute the HBM of pods bound to ``node_name`` onto per-chip free
    values (greedy whole-chip packing, most-free chip first) — the one
    occupancy model shared by the fake and native agents; the accountant and
    preemption simulate against exactly this behavior."""
    for pod in pods:
        if pod.node_name != node_name or pod.phase not in ("Running", "Pending"):
            continue
        try:
            req = pod_request(pod)
        except LabelParseError:
            continue
        for _ in range(req.effective_chips):
            j = max(range(len(free)), key=lambda k: free[k])
            free[j] = max(free[j] - max(req.hbm_per_chip, 1), 0)  # occupied chip


@dataclass(frozen=True)
class ChipSpec:
    hbm_gib: int
    clock_mhz: int
    hbm_bandwidth_gbps: int
    tflops_bf16: int
    power_w: int
    default_chips_per_host: int


# Representative per-generation chip characteristics (synthetic but shaped
# like the public spec sheets); the scheduler only compares them relatively.
CHIP_SPECS: dict[str, ChipSpec] = {
    "v4": ChipSpec(32, 940, 1200, 275, 170, 4),
    "v5e": ChipSpec(16, 940, 819, 197, 130, 8),
    "v5p": ChipSpec(95, 1050, 2765, 459, 250, 4),
    "v6e": ChipSpec(32, 1050, 1640, 918, 200, 8),
}


@dataclass
class _Host:
    name: str
    generation: str
    chips: int
    slice_id: str
    coords: tuple[int, int, int]
    accel_type: str
    unhealthy: set[int]


class FakeTpuAgent:
    """One agent instance simulates the whole fleet's DaemonSet pods."""

    def __init__(self, cluster, *, now_fn=time.time) -> None:
        self.cluster = cluster  # needs put_tpu_metrics / list_pods
        self.now_fn = now_fn
        self._hosts: dict[str, _Host] = {}
        # Hosts whose heartbeat is stopped (node death without deleting
        # anything: the CR simply ages until the health monitor's silence
        # ladder fires). publish_all() skips them; an explicit
        # refresh(name) still publishes (a single late packet).
        self._stopped: set[str] = set()

    # --- fleet construction ---

    def add_host(
        self,
        name: str,
        *,
        generation: str = "v5e",
        chips: int | None = None,
        slice_id: str = "",
        coords: tuple[int, int, int] = (0, 0, 0),
        accel_type: str = "",
    ) -> None:
        spec = CHIP_SPECS[generation]
        n = spec.default_chips_per_host if chips is None else chips
        self._hosts[name] = _Host(
            name=name,
            generation=generation,
            chips=n,
            slice_id=slice_id,
            coords=coords,
            accel_type=accel_type or f"{generation}-{n}",
            unhealthy=set(),
        )

    def add_slice(
        self,
        prefix: str,
        *,
        generation: str = "v5p",
        host_topology: tuple[int, int, int] = (2, 2, 1),
        chips_per_host: int | None = None,
    ) -> list[str]:
        """A multi-host ICI slice: hosts at every coordinate of the topology
        grid, sharing a slice id — what a GKE multi-host TPU node pool looks
        like to the scheduler."""
        spec = CHIP_SPECS[generation]
        chips = chips_per_host or spec.default_chips_per_host
        x, y, z = host_topology
        total_chips = x * y * z * chips
        names = []
        for i, (cx, cy, cz) in enumerate(
            itertools.product(range(x), range(y), range(z))
        ):
            name = f"{prefix}-{i}"
            self.add_host(
                name,
                generation=generation,
                chips=chips,
                slice_id=prefix,
                coords=(cx, cy, cz),
                accel_type=f"{generation}-{total_chips}",
            )
            names.append(name)
        return names

    def set_chip_health(self, host: str, chip_index: int, healthy: bool) -> None:
        h = self._hosts[host]
        (h.unhealthy.discard if healthy else h.unhealthy.add)(chip_index)

    def fail_chips(self, host: str, idxs, *, publish: bool = True) -> None:
        """Mark chips Unhealthy and (by default) publish the CR — the
        chip-degrade injection: the agent is alive and says so, but some of
        its silicon is not (health ladder: DEGRADED)."""
        for i in idxs:
            self.set_chip_health(host, i, False)
        if publish and host not in self._stopped:
            self.refresh(host)

    def heal_chips(self, host: str, idxs, *, publish: bool = True) -> None:
        for i in idxs:
            self.set_chip_health(host, i, True)
        if publish and host not in self._stopped:
            self.refresh(host)

    def stop_heartbeat(self, name: str) -> None:
        """Stop publishing for ``name`` — host death without deletion (a
        wedged kubelet, a dead DaemonSet pod): the stored CR ages until the
        node health monitor's silence ladder fences and eventually repairs
        the node. Nothing is deleted."""
        self._stopped.add(name)

    def resume_heartbeat(self, name: str, *, publish: bool = True) -> None:
        """Resume publishing (the flap or recovery half): by default a
        fresh CR goes out at once, which returns a SUSPECT node to HEALTHY
        inside the debounce window."""
        self._stopped.discard(name)
        if publish and name in self._hosts:
            self.refresh(name)

    def remove_host(self, name: str) -> None:
        self._hosts.pop(name, None)
        self._stopped.discard(name)
        self.cluster.delete_tpu_metrics(name)

    # --- publishing ---

    def publish_all(self) -> None:
        for name in self._hosts:
            if name not in self._stopped:
                self.refresh(name)

    def refresh(self, name: str) -> None:
        """Recompute and publish one host's CR, accounting for bound pods'
        HBM via the shared attribution model (``charge_bound_pods``)."""
        h = self._hosts[name]
        spec = CHIP_SPECS[h.generation]
        free = [spec.hbm_gib * GIB] * h.chips
        charge_bound_pods(free, self.cluster.list_pods(), name)
        self.cluster.put_tpu_metrics(
            TpuNodeMetrics(
                name=name,
                generation=h.generation,
                accel_type=h.accel_type,
                slice_id=h.slice_id,
                topology_coords=h.coords,
                last_updated_unix=self.now_fn(),
                chips=[
                    TpuChip(
                        index=i,
                        health="Unhealthy" if i in h.unhealthy else HEALTHY,
                        hbm_free=free[i],
                        hbm_total=spec.hbm_gib * GIB,
                        clock_mhz=spec.clock_mhz,
                        hbm_bandwidth_gbps=spec.hbm_bandwidth_gbps,
                        tflops_bf16=spec.tflops_bf16,
                        power_w=spec.power_w,
                    )
                    for i in range(h.chips)
                ],
            )
        )
