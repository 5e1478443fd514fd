"""The deployment's fleet and its pre-fill, made from a configuration file
and a seed. Plain Python and NumPy: nothing here imports the program.

A configuration's ``fleet`` section names its pools. A pool of multi-host
slices (``slices`` of ``hosts_per_slice`` hosts laid out on ``topology``)
or of single hosts (``hosts``), each host with ``chips`` chips of one
generation whose per-chip figures come from the ``chip_specs`` table.
Every host carries a zone: slice ``s`` of ``S`` lies in zone ``s * Z // S``
and single host ``h`` of ``H`` in zone ``min(h // (H // Z), Z - 1)``.

The pre-fill is the work a running fleet already holds: a share of each
single-host pool's chips packed first-fit by singletons of the traffic's
mix onto a seeded order of its hosts, and a share of each slice pool's
slices held whole by one job a slice. The pods' sizes are drawn from the
mix's own ``sizes_seed``, the same for every run; the run's seed orders
the hosts and picks the slices. Every held chip reports used HBM in
its metrics: the pod's request, or ``default_used_gib`` when it names none.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

GIB = 1 << 30
MIB = 1 << 20


@dataclass(frozen=True)
class Host:
    name: str
    generation: str
    chips: int
    slice_id: str       # "" for a single host
    coords: tuple       # (x, y, z) within the slice
    zone: int
    accel_type: str


@dataclass(frozen=True)
class PodReq:
    """One pod's scheduling request as the benchmark made it: the traffic
    and the reference both read it, the program gets it as pod labels."""

    key: str                 # namespace/name
    chips: int
    hbm_gib: int = 0         # free HBM per chip, GiB (0: none asked)
    clock_mhz: int = 0
    generation: str = ""     # minimum generation ("" = any)
    gang: str = ""
    gang_size: int = 0
    gang_kind: str = ""      # plain | cosched | topology | multislice


@dataclass
class Fleet:
    hosts: list
    spec: dict                # generation -> chip figures
    zones: list
    generation_rank: dict
    slices: dict = field(default_factory=dict)  # slice id -> host names

    @property
    def chips_total(self) -> int:
        return sum(h.chips for h in self.hosts)


def build_fleet(cfg: dict) -> Fleet:
    """The fleet of one configuration file (its ``fleet`` section)."""
    f = cfg["fleet"]
    zones = list(f["zones"])
    nz = len(zones)
    hosts: list[Host] = []
    slices: dict[str, list[str]] = {}
    for pool in f["pools"]:
        gen = pool["generation"]
        chips = int(pool["chips"])
        prefix = pool["prefix"]
        if "slices" in pool:
            topo = tuple(pool["topology"])
            n = int(pool["slices"])
            per = int(np.prod(topo))
            accel = f"{gen}-{per * chips}"
            for s in range(n):
                sid = f"{prefix}-{s:03d}"
                names = []
                for i, xyz in enumerate(itertools.product(*(range(d) for d in topo))):
                    name = f"{sid}-{i}"
                    hosts.append(Host(name, gen, chips, sid, xyz, s * nz // n, accel))
                    names.append(name)
                slices[sid] = names
        else:
            n = int(pool["hosts"])
            block = max(n // nz, 1)
            for h in range(n):
                hosts.append(Host(
                    f"{prefix}-{h:04d}", gen, chips, "", (0, 0, 0),
                    min(h // block, nz - 1), f"{gen}-{chips}",
                ))
    return Fleet(hosts, f["chip_specs"], zones, f["generation_rank"], slices)


def draw_singleton(rng: np.random.Generator, mix: dict, gens_allowed=None) -> dict:
    """One singleton's request from the mix: generation ("any" draws no
    minimum), chips, HBM and clock, each table keyed by generation with an
    "any" row for the rest."""
    gens = list(mix["generation"])
    p = np.array([mix["generation"][g] for g in gens], dtype=float)
    if gens_allowed is not None:
        p = p * np.array([g in gens_allowed for g in gens], dtype=float)
    p = p / p.sum()
    g = gens[int(rng.choice(len(gens), p=p))]
    sizes = mix["chips"].get(g, mix["chips"]["any"])
    chips = int(sizes[int(rng.integers(len(sizes)))])
    hbm = 0
    if rng.random() < mix["hbm_share"]:
        top = mix["hbm_max_gib"].get(g, mix["hbm_max_gib"]["any"])
        hbm = int(rng.integers(1, top))
    clock = 0
    if rng.random() < mix["clock_share"]:
        clock = int(mix["clock_mhz"].get(g, mix["clock_mhz"]["any"]))
    return dict(generation="" if g == "any" else g, chips=chips, hbm_gib=hbm,
                clock_mhz=clock)


@dataclass
class Prefill:
    pods: list                # (PodReq, node)
    used: dict                # host -> list of per-chip used HBM bytes (held chips)


def build_prefill(fleet: Fleet, cfg: dict, mix: dict, seed: int) -> Prefill:
    """The pods the fleet already runs, bound through the cluster API before
    the stack starts, and each host's held chips for its metrics."""
    pf = cfg["prefill"]
    # The pods' sizes are the same for every seed; the seed orders the
    # hosts they land on and picks the held slices.
    sizes = np.random.default_rng(mix["sizes_seed"])
    rng = np.random.default_rng([seed, 7])
    pods: list = []
    used: dict[str, list[int]] = {}
    free = {h.name: h.chips for h in fleet.hosts}
    singles = [h for h in fleet.hosts if not h.slice_id]
    by_gen: dict[str, list[Host]] = {}
    for h in singles:
        by_gen.setdefault(h.generation, []).append(h)
    n = 0
    for gen, pool in sorted(by_gen.items()):
        order = [pool[i] for i in rng.permutation(len(pool))]
        target = int(pf["single_host_share"] * sum(h.chips for h in pool))
        held = 0
        cursor = 0
        allowed = {g for g in mix["generation"]
                   if g == "any" or fleet.generation_rank[g] <= fleet.generation_rank[gen]}
        while held < target:
            r = draw_singleton(sizes, mix, allowed)
            r["chips"] = min(r["chips"], target - held)
            # First fit from the cursor: hosts before it are full enough.
            while cursor < len(order) and free[order[cursor].name] == 0:
                cursor += 1
            host = next(
                (h for h in order[cursor:] if free[h.name] >= r["chips"]), None
            )
            if host is None:
                break
            req = PodReq(f"bench/fill-{n:05d}", r["chips"], r["hbm_gib"],
                         r["clock_mhz"], r["generation"])
            n += 1
            pods.append((req, host.name))
            free[host.name] -= r["chips"]
            held += r["chips"]
            charge = (r["hbm_gib"] or pf["default_used_gib"]) * GIB
            used.setdefault(host.name, []).extend([charge] * r["chips"])
    sids = sorted(fleet.slices)
    take = int(pf["slice_share"] * len(sids))
    for s in sorted(rng.choice(len(sids), size=take, replace=False)):
        sid = sids[int(s)]
        names = fleet.slices[sid]
        for i, name in enumerate(names):
            chips = free[name]
            req = PodReq(f"bench/job-{sid}-{i}", chips, 0, 0, "",
                         gang=f"job-{sid}", gang_size=len(names), gang_kind="topology")
            pods.append((req, name))
            free[name] = 0
            used.setdefault(name, []).extend([pf["default_used_gib"] * GIB] * chips)
    return Prefill(pods, used)
