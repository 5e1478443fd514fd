"""ICI topology matching: placing a host-grid request onto a slice.

Net-new vs the reference (no topology awareness of any kind; SURVEY.md §2
"Parallelism strategies" row): the structural TPU analog of sequence/model
parallelism support is placing a gang so its hosts form a contiguous
sub-block of one slice's ICI host grid — the job's collectives then ride ICI
links, never DCN.

Tractability (SURVEY.md §7 hard part 2): rather than general subgraph
isomorphism, matching is restricted to axis-aligned sub-blocks of the fixed
GKE-style slice grids (host grids are small — a v5p-128 pool is 4x4x2 = 32
hosts — so exhaustive origin x axis-permutation search is cheap). Wraparound
(torus) placements are not considered: GKE exposes plain grids at the host
level, and non-wrapped blocks are always ICI-contiguous.

Counterpart of ``yoda_tpu/plugins/yoda/topology.py``, ported whole: it is
host Python over the snapshot and leaves nothing out.
"""

from __future__ import annotations

import itertools
from collections import defaultdict

from yoda_tpu_torch.framework.interfaces import Snapshot

Coord = tuple[int, int, int]


def normalize_dims(dims: tuple[int, ...]) -> tuple[int, int, int]:
    """Pad a 1-3 dim request to 3D (trailing 1s)."""
    d = tuple(dims) + (1,) * (3 - len(dims))
    return d[0], d[1], d[2]


def iter_subblocks(
    free: set[Coord],
    want: tuple[int, int, int],
    *,
    must_include: frozenset[Coord] | set[Coord] = frozenset(),
):
    """Yield every axis-aligned ``want``-shaped block (any axis
    permutation) whose coordinates are all in ``free | must_include`` and
    which contains every ``must_include`` coordinate. Deterministic order:
    axis permutations in itertools order, origins ascending — the
    backtracking multislice packer explores candidates in this order."""
    usable = set(free) | set(must_include)
    if not usable:
        return
    xs, ys, zs = zip(*usable)
    bounds = (max(xs) + 1, max(ys) + 1, max(zs) + 1)
    seen_shapes: set[tuple[int, int, int]] = set()
    for perm in itertools.permutations(want):
        if perm in seen_shapes:
            continue
        seen_shapes.add(perm)
        px, py, pz = perm
        for ox, oy, oz in itertools.product(
            range(bounds[0] - px + 1), range(bounds[1] - py + 1), range(bounds[2] - pz + 1)
        ):
            block = [
                (ox + dx, oy + dy, oz + dz)
                for dx in range(px)
                for dy in range(py)
                for dz in range(pz)
            ]
            block_set = set(block)
            if block_set <= usable and must_include <= block_set:
                yield sorted(block)


def find_subblock(
    free: set[Coord],
    want: tuple[int, int, int],
    *,
    must_include: frozenset[Coord] | set[Coord] = frozenset(),
) -> list[Coord] | None:
    """First block from :func:`iter_subblocks` (smallest origin, first
    matching permutation), or None — hosts already holding gang members
    are in ``must_include`` and the block must complete around them."""
    return next(
        iter_subblocks(free, want, must_include=must_include), None
    )


def pack_blocks(
    free: set[Coord], want: tuple[int, int, int], k: int
) -> list[list[Coord]] | None:
    """``k`` mutually disjoint ``want``-blocks within ``free``, or None.
    Exhaustive backtracking over block choices (greedy lowest-origin
    packing can strand feasible placements — an L-shaped free region fits
    two 2x1 blocks only if the first pick is NOT the lowest-origin one);
    host grids are small, so the search stays cheap."""
    volume = want[0] * want[1] * want[2]
    if k == 0:
        return []
    if len(free) < k * volume:
        return None
    for block in iter_subblocks(free, want):
        rest = pack_blocks(free - set(block), want, k - 1)
        if rest is not None:
            return [block] + rest
    return None


def plan_multislice_placement(
    snapshot: Snapshot,
    *,
    want_dims: tuple[int, ...],
    slices: int,
    host_ok: "callable",
    pinned: dict[str, Coord] | None = None,
) -> dict[str, Coord] | None:
    """``slices`` disjoint contiguous ``want_dims`` host blocks — the TPU
    Multislice pattern (data parallelism over DCN between slices, ICI
    within each; one gang of ``slices x prod(want_dims)`` members). Blocks
    may land in different ICI slices or pack into one big slice, but never
    share a host. ``slices=1`` is exactly :func:`plan_slice_placement`.

    ``pinned`` (bound members after a restart) is honored per ICI slice:
    each slice's pinned hosts are covered greedily — first trying one
    block around all of them, then anchor-first blocks — and the remaining
    block budget is placed on free hosts. Returns {node_name: coord} over
    all blocks, or None.
    """
    if slices <= 1:
        return plan_slice_placement(
            snapshot, want_dims=want_dims, host_ok=host_ok, pinned=pinned
        )
    pinned = pinned or {}
    want = normalize_dims(want_dims)
    by_slice: dict[str, dict[Coord, str]] = defaultdict(dict)
    pin_by_slice: dict[str, dict[str, Coord]] = defaultdict(dict)
    for ni in snapshot.infos():
        if ni.tpu is None or not ni.tpu.slice_id:
            continue
        if ni.name in pinned:
            pin_by_slice[ni.tpu.slice_id][ni.name] = ni.tpu.topology_coords
        elif host_ok(ni):
            by_slice[ni.tpu.slice_id][ni.tpu.topology_coords] = ni.name
    if len(pinned) != sum(len(g) for g in pin_by_slice.values()):
        return None  # a pinned host is gone from the snapshot
    plan: dict[str, Coord] = {}
    blocks_left = slices

    def take_block(slice_id: str, block: list[Coord]) -> None:
        nonlocal blocks_left
        coord_to_host = by_slice.get(slice_id, {})
        for c in block:
            if c in coord_to_host:
                plan[coord_to_host[c]] = c
                del coord_to_host[c]
        blocks_left -= 1

    # Pinned slices first: every bound member must sit inside some block.
    # Best-effort greedy per slice — one block around all pins when it
    # fits, else anchor-first blocks that may cover any subset of the
    # remaining pins (a restart-replayed multislice gang can legitimately
    # have several blocks in one big slice).
    for slice_id in sorted(pin_by_slice):
        pins = dict(pin_by_slice[slice_id])
        while pins:
            if blocks_left == 0:
                return None
            free = set(by_slice.get(slice_id, {}))
            block = find_subblock(free, want, must_include=set(pins.values()))
            if block is None:
                # Anchor-first: other pins stay usable (the block may
                # sweep them up; whatever it covers is claimed below).
                anchor = min(pins.values())
                block = find_subblock(
                    free | set(pins.values()), want, must_include={anchor}
                )
            if block is None:
                return None
            for h, c in list(pins.items()):
                if c in set(block):
                    plan[h] = c
                    del pins[h]
            take_block(slice_id, block)
    if blocks_left == 0:
        return plan
    # Remaining blocks on free hosts: exhaustive over how many blocks each
    # slice takes (preferring to pack the lexicographically-first slices),
    # with backtracking block placement within a slice (pack_blocks) — a
    # feasible multislice placement is never missed to greedy ordering.
    volume = want[0] * want[1] * want[2]
    slice_ids = sorted(by_slice)

    def fit(idx: int, need: int) -> dict[str, Coord] | None:
        if need == 0:
            return {}
        if idx >= len(slice_ids):
            return None
        sid = slice_ids[idx]
        coords_map = by_slice[sid]
        for take in range(min(need, len(coords_map) // volume), -1, -1):
            blocks = pack_blocks(set(coords_map), want, take)
            if blocks is None:
                continue
            rest = fit(idx + 1, need - take)
            if rest is not None:
                out = dict(rest)
                for block in blocks:
                    for c in block:
                        out[coords_map[c]] = c
                return out
        return None

    placed = fit(0, blocks_left)
    if placed is None:
        return None
    plan.update(placed)
    return plan


def plan_slice_placement(
    snapshot: Snapshot,
    *,
    want_dims: tuple[int, ...],
    host_ok: "callable",
    pinned: dict[str, Coord] | None = None,
) -> dict[str, Coord] | None:
    """Choose a slice and a contiguous sub-block of it for a gang.

    ``host_ok(node_info) -> bool`` is the per-host feasibility predicate
    (chips/HBM/health/reservations — the caller supplies the same predicate
    the Filter uses). ``pinned`` maps hosts that already hold bound gang
    members (e.g. after a scheduler restart) to their coords; the chosen
    block must contain all of them, and they are exempt from ``host_ok``.
    Returns {node_name: coord} for the chosen hosts (pinned included), or
    None when no slice can currently host the gang.

    Slices are tried in sorted order (deterministic); within a slice the
    lowest-origin block wins — packing gangs toward slice origins keeps the
    remaining free region as one large block (anti-fragmentation).
    """
    pinned = pinned or {}
    want = normalize_dims(want_dims)
    by_slice: dict[str, dict[Coord, str]] = defaultdict(dict)
    pinned_slice: str | None = None
    for ni in snapshot.infos():
        if ni.tpu is None or not ni.tpu.slice_id:
            continue
        if ni.name in pinned:
            if pinned_slice is not None and ni.tpu.slice_id != pinned_slice:
                return None  # bound members span slices: unplannable
            pinned_slice = ni.tpu.slice_id
        elif host_ok(ni):
            by_slice[ni.tpu.slice_id][ni.tpu.topology_coords] = ni.name
    if pinned and pinned_slice is None:
        return None  # pinned hosts no longer in the snapshot
    must = frozenset(pinned.values())
    slice_ids = [pinned_slice] if pinned else sorted(by_slice)
    for slice_id in slice_ids:
        free_coords = set(by_slice.get(slice_id, {}))
        block = find_subblock(free_coords, want, must_include=must)
        if block is None:
            continue
        coord_to_pinned = {c: h for h, c in pinned.items()}
        return {
            (coord_to_pinned[c] if c in coord_to_pinned else by_slice[slice_id][c]): c
            for c in block
        }
    return None
