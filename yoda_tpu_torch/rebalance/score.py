"""Fleet fragmentation scoring — the rebalancer's objective function.

Placement is place-once today: churn punches holes into ICI slices and
strands free chips on partially-occupied hosts, so over a long-running
fleet the probability that a whole contiguous block exists for the next
topology gang decays monotonically (Gandiva's fragmentation observation,
PAPERS.md). This module quantifies that decay as one number in [0, 1] so
the background rebalancer (rebalance/rebalancer.py) can report it before
and after each pass (``RebalanceReport``) and evaluate candidate repacks
by score delta on a simulated occupancy.

The score blends two terms, each 0 when free capacity is perfectly
consolidated:

- **block fragmentation** (ICI slices): within each multi-host slice, the
  wholly-free hosts form islands under ICI adjacency (coords differing by
  1 on one axis). Free hosts outside the largest island are fragmented —
  a topology gang cannot use them as one block.
  ``block_frag = Σ_s (free_s - largest_island_s) / Σ_s free_s``.
- **chip stranding** (every host): free chips on partially-occupied hosts
  cannot serve whole-host pods.
  ``chip_frag = stranded_free_chips / total_free_chips``.

``fragmentation = (block_frag + chip_frag) / 2``; an empty term (no free
slice hosts / no free chips) contributes 0.

:class:`FleetOccupancy` is the simulation substrate: a host -> (free,
total) chip model built from a snapshot net of accountant reservations,
cheap to clone, with release/occupy edits — candidate moves are scored on
a clone before any pod is touched.

Counterpart of ``yoda_tpu/rebalance/score.py``, whole, over the port's
``available_chips``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from yoda_tpu_torch.api.requests import TpuRequest
from yoda_tpu_torch.framework.interfaces import Snapshot
from yoda_tpu_torch.plugins.yoda.filter_plugin import available_chips

# No constraints: every healthy chip qualifies — occupancy is a capacity
# model, not an admission check (admission stays with the callers).
_PLAIN = TpuRequest()

Coord = tuple[int, int, int]


@dataclass
class HostOccupancy:
    """One host's capacity state: healthy chips total and claimable now
    (net of metrics-visible use AND accountant reservations — the same
    handoff model the filter uses via :func:`available_chips`)."""

    name: str
    slice_id: str
    coords: Coord
    total: int
    free: int


class FleetOccupancy:
    """Mutable host-level capacity model for what-if rebalance planning."""

    def __init__(self, hosts: "dict[str, HostOccupancy]") -> None:
        self.hosts = hosts

    @classmethod
    def from_snapshot(
        cls, snapshot: Snapshot, reserved_map: "dict[str, int] | None" = None
    ) -> "FleetOccupancy":
        reserved_map = reserved_map or {}
        hosts: dict[str, HostOccupancy] = {}
        for ni in snapshot.infos():
            tpu = ni.tpu
            if tpu is None:
                continue
            total = len(tpu.healthy_chips())
            free = max(
                available_chips(tpu, _PLAIN, reserved_map.get(ni.name, 0)), 0
            )
            hosts[ni.name] = HostOccupancy(
                name=ni.name,
                slice_id=tpu.slice_id or "",
                coords=tpu.topology_coords,
                total=total,
                free=min(free, total),
            )
        return cls(hosts)

    def clone(self) -> "FleetOccupancy":
        return FleetOccupancy(
            {
                n: HostOccupancy(h.name, h.slice_id, h.coords, h.total, h.free)
                for n, h in self.hosts.items()
            }
        )

    def free_chips(self, name: str) -> int:
        h = self.hosts.get(name)
        return h.free if h is not None else 0

    def release(self, name: str, chips: int) -> None:
        """Simulate (or record) an eviction/unbind freeing ``chips``."""
        h = self.hosts.get(name)
        if h is not None:
            h.free = min(h.free + chips, h.total)

    def occupy(self, name: str, chips: int) -> None:
        """Simulate (or record) a placement taking ``chips``."""
        h = self.hosts.get(name)
        if h is not None:
            h.free = max(h.free - chips, 0)

    def score(self) -> float:
        """The fleet fragmentation score in [0, 1]; 0 = free capacity is
        perfectly consolidated, higher = more broken up. See the module
        docstring for the two blended terms."""
        return (self._block_frag() + self._chip_frag()) / 2.0

    # --- terms ---

    def _block_frag(self) -> float:
        by_slice: dict[str, set[Coord]] = {}
        for h in self.hosts.values():
            if h.slice_id and h.free >= h.total and h.total > 0:
                by_slice.setdefault(h.slice_id, set()).add(h.coords)
        total_free = sum(len(c) for c in by_slice.values())
        if total_free == 0:
            return 0.0
        outside = 0
        for coords in by_slice.values():
            outside += len(coords) - _largest_island(coords)
        return outside / total_free

    def _chip_frag(self) -> float:
        free = stranded = 0
        for h in self.hosts.values():
            free += h.free
            if 0 < h.free < h.total:
                stranded += h.free
        return stranded / free if free else 0.0


def _largest_island(coords: "set[Coord]") -> int:
    """Largest connected component of ``coords`` under 6-neighbor ICI
    adjacency (axis-aligned unit steps). Host grids are tens of hosts, so
    plain BFS is plenty."""
    remaining = set(coords)
    best = 0
    while remaining:
        start = remaining.pop()
        q = deque([start])
        size = 1
        while q:
            x, y, z = q.popleft()
            for nxt in (
                (x + 1, y, z), (x - 1, y, z),
                (x, y + 1, z), (x, y - 1, z),
                (x, y, z + 1), (x, y, z - 1),
            ):
                if nxt in remaining:
                    remaining.remove(nxt)
                    q.append(nxt)
                    size += 1
        best = max(best, size)
    return best


def fragmentation_score(
    snapshot: Snapshot, reserved_map: "dict[str, int] | None" = None
) -> float:
    """One-shot convenience: the fleet fragmentation score for a snapshot
    net of ``reserved_map`` (accountant reservations)."""
    return FleetOccupancy.from_snapshot(snapshot, reserved_map).score()
