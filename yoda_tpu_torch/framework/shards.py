"""Scheduler shard-out: fleet partitioning + pod routing for N parallel
serve loops.

One serve loop per cluster was the throughput ceiling the ROADMAP named:
ingest is batched (~40x), dispatch is device-resident, binds are
pipelined — yet every placement decision still serialized through one
process-wide loop. This module supplies the two pure-logic pieces that
let ``standalone.build_sharded_stacks`` run N loops against one cluster:

- :class:`ShardMap` — deterministic ICI slice/pool -> shard assignment by
  rendezvous (highest-random-weight) hashing over a keyed blake2 digest.
  The assignment is a pure function of (pool id, shard count): fleet
  change moves NOTHING (a new slice lands on its hash-chosen shard, a
  deleted slice takes only itself away), and changing ``shard_count``
  moves ~1/N of the pools — the rendezvous property. Hosts outside any
  multi-host slice form single-host pools (``host:<name>``).
- :class:`ShardRouter` — watch-fed routing of pending pods to exactly ONE
  shard's scheduling queue. Every member of a gang routes to the same
  shard (rendezvous over the gang name across the shards whose partition
  could host the gang whole); a gang NO single shard can host — a mesh
  larger than any shard's partition — routes to the serialized GLOBAL
  lane, whose stack sees the whole fleet, so no workload regresses.
  Routing is advisory capacity-shape feasibility only: admission (and
  ultimately the optimistic shard commit at the shared ChipAccountant)
  gates reality.

Correctness note: partitions are disjoint by construction, so two shards
never contend for a node in the steady state — the optimistic
claim->validate->commit protocol exists for the windows where they DO
see the same nodes: the serialized global lane placing a cross-shard
gang over every partition, and the stale-shard-map window a rendezvous
rebalance opens (modeled by ``ShardMap(overlap=...)`` in the
cross_shard_contention chaos mode).

Counterpart of ``yoda_tpu/framework/shards.py``: ``ShardMap``,
``ShardRouter``, ``shard_name`` and ``GLOBAL_LANE``, the reference's code,
so both packages partition a fleet and route a pod alike. On the card
every lane evaluates its own partition through the hand kernels, on a
CUDA stream of its own (``standalone.build_stack(shard=...)``). And
``WorkerSupervisor``, the worker-process lifecycle of ``shard_mode:
process`` (spawn, poll, respawn with backoff, stop); each worker
process evaluates its partition on the card in a CUDA context of its
own (``framework/procserve.py``).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Callable, Iterable, Mapping

from yoda_tpu_torch.api.requests import LabelParseError, gang_name_of, pod_request
from yoda_tpu_torch.api.types import PodSpec, TpuNodeMetrics
from yoda_tpu_torch.plugins.yoda.topology import normalize_dims

#: The serialized fallback lane for gangs no single shard can host. Its
#: stack sees the WHOLE fleet and stages/commits like any shard, so its
#: placements contend with every shard through the accountant's
#: optimistic commit — never through shared locks.
GLOBAL_LANE = "global"


def _digest(*parts: str) -> int:
    """Stable 64-bit hash — deliberately NOT Python's randomized str
    hash: the slice->shard assignment must survive process restarts and
    replay identically under any PYTHONHASHSEED."""
    h = hashlib.blake2b("|".join(parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def shard_name(i: int) -> str:
    return f"s{i}"


class ShardMap:
    """Deterministic pool -> shard assignment (rendezvous hashing).

    ``overlap`` maps a pool id to EXTRA shard indices that also see it in
    their partition — the stale-assignment window a live rendezvous
    rebalance opens (two shards briefly believing they own one slice).
    Production leaves it empty; the cross_shard_contention chaos mode
    pins it open to prove the commit protocol holds under overlap.
    """

    def __init__(
        self,
        shard_count: int,
        *,
        overlap: "Mapping[str, Iterable[int]] | None" = None,
    ) -> None:
        if shard_count < 1:
            raise ValueError(f"shard_count must be >= 1, got {shard_count}")
        self.shard_count = shard_count
        self.overlap = {
            pool: tuple(extra) for pool, extra in (overlap or {}).items()
        }
        # pool -> primary shard memo (pure function; the dict is only a
        # cache, so the benign last-write-wins race under concurrent
        # fills is harmless).
        self._memo: dict[str, int] = {}

    @staticmethod
    def pool_of(name: str, tpu: "TpuNodeMetrics | None") -> str:
        """The partition unit a node belongs to: its ICI slice when it is
        part of one, else a single-host pool — a slice is never split
        across shards, so every topology block plans within one shard."""
        slice_id = tpu.slice_id if tpu is not None else ""
        return slice_id or f"host:{name}"

    def shard_of_pool(self, pool: str) -> int:
        s = self._memo.get(pool)
        if s is None:
            s = max(
                range(self.shard_count),
                key=lambda i: _digest("pool", pool, str(i)),
            )
            self._memo[pool] = s
        return s

    def shards_of_pool(self, pool: str) -> tuple[int, ...]:
        primary = self.shard_of_pool(pool)
        extra = tuple(
            i for i in self.overlap.get(pool, ()) if i != primary
        )
        return (primary, *extra)

    def node_filter(
        self, shard: int
    ) -> "Callable[[str, TpuNodeMetrics], bool]":
        """The informer snapshot predicate for one shard's partition —
        a pure function of the CR's slice id, safe under the informer
        lock."""

        def _filter(name: str, tpu: TpuNodeMetrics) -> bool:
            return shard in self.shards_of_pool(self.pool_of(name, tpu))

        return _filter


class _PoolAgg:
    """Per-pool capacity aggregate (one slice or one single-host pool)."""

    __slots__ = ("hosts", "chips", "max_node_chips", "dims", "node_chips")

    def __init__(self) -> None:
        self.hosts = 0
        self.chips = 0
        self.max_node_chips = 0
        self.dims = (0, 0, 0)  # slice host-grid extents (max coord + 1)
        self.node_chips: dict[int, int] = {}  # node capacity -> host count


def _blocks_in_grid(
    grid: tuple[int, int, int], want: tuple[int, int, int]
) -> int:
    """How many disjoint axis-aligned ``want`` blocks a fully-free
    ``grid`` holds — maximized over axis permutations (exact for the
    axis-aligned packing the topology planner performs on a free grid;
    occupancy is admission's job, not routing's)."""
    import itertools

    best = 0
    for perm in set(itertools.permutations(want)):
        n = 1
        for g, w in zip(grid, perm):
            n *= g // w if w else 0
        best = max(best, n)
    return best


class ShardRouter:
    """Watch-fed router: every pending pod to exactly one shard queue.

    Registered as a cluster watcher BEFORE any stack's informer, so the
    fleet registry is current when an informer routes a pod from the
    same event batch. ``route`` is called under informer locks — it
    takes only its own lock and touches no other component (the lock-
    ordering DAG allows same-level sibling acquisition, never a reach
    back into a component lock).
    """

    #: Occupancy tie-break quantum: queue depths bucket at log2 of
    #: (depth // QUANTUM), so routing ignores depth noise below a real
    #: backlog and behaves exactly like pure rendezvous on balanced or
    #: drained fleets — only genuine skew (a starved shard hundreds of
    #: entries deep) re-steers new arrivals.
    OCCUPANCY_QUANTUM = 64

    #: Bound on remembered gang routing decisions (whole-gang
    #: consistency under the occupancy tie-break: the first member's
    #: answer pins the gang until a structural generation bump).
    MAX_GANG_MEMO = 4096

    def __init__(self, shard_map: ShardMap) -> None:
        self.map = shard_map
        self._lock = threading.Lock()
        # node -> (pool, coords, healthy chips); the pool aggregates are
        # rebuilt lazily when dirty (structural change), never per route.
        self._nodes: dict[str, tuple[str, tuple[int, int, int], int]] = {}
        self._dirty = True
        self._pools: dict[str, _PoolAgg] = {}
        self._by_shard: dict[int, list[str]] = {}
        self.generation = 0  # bumped per aggregate rebuild (reroute gate)
        # Occupancy-aware routing: per-shard live
        # queue depth, wired by build_sharded_stacks (ShardSet.queue_
        # depth). None = pure rendezvous. Rendezvous "ties" are broken
        # by depth BUCKET: among capacity-feasible shards, only those in
        # the lowest occupancy bucket stay candidates, then rendezvous
        # picks deterministically — deterministic given the depth
        # snapshot, and starved work stops defaulting to the global lane.
        self.depth_fn: "Callable[[int], int] | None" = None
        # gang routing key -> (generation, lane): every member of a gang
        # must compute the SAME lane even as depths move between member
        # arrivals; the memo pins the first member's answer until a
        # structural fleet change (generation bump) or a map swap.
        self._gang_memo: "OrderedDict[str, tuple[int, str]]" = OrderedDict()

    def swap_map(self, new_map: ShardMap) -> None:
        """Install a new rendezvous map (live shard resize): aggregates
        rebuild lazily, gang memos drop (fresh decisions under the new
        topology), and the generation bumps so reroute passes treat
        every queued entry as re-routable."""
        with self._lock:
            self.map = new_map
            self._dirty = True
            self._gang_memo.clear()
            self.generation += 1

    def pools_snapshot(self) -> "list[str]":
        """The live pool ids (resize movement accounting)."""
        with self._lock:
            if self._dirty:
                self._rebuild_locked()
            return list(self._pools)

    # --- watch feed ---

    def observe(self, event) -> None:
        if event.kind != "TpuNodeMetrics":
            return
        tpu = event.obj
        with self._lock:
            if event.type == "deleted":
                if self._nodes.pop(tpu.name, None) is not None:
                    self._dirty = True
                return
            pool = self.map.pool_of(tpu.name, tpu)
            rec = (pool, tpu.topology_coords, len(tpu.healthy_chips()))
            if self._nodes.get(tpu.name) != rec:
                self._nodes[tpu.name] = rec
                self._dirty = True

    def observe_batch(self, events) -> None:
        for event in events:
            self.observe(event)

    # --- aggregates ---

    def _rebuild_locked(self) -> None:
        pools: dict[str, _PoolAgg] = {}
        for _name, (pool, coords, chips) in self._nodes.items():
            agg = pools.get(pool)
            if agg is None:
                agg = pools[pool] = _PoolAgg()
            agg.hosts += 1
            agg.chips += chips
            agg.max_node_chips = max(agg.max_node_chips, chips)
            agg.node_chips[chips] = agg.node_chips.get(chips, 0) + 1
            agg.dims = tuple(
                max(d, c + 1) for d, c in zip(agg.dims, coords)
            )
        by_shard: dict[int, list[str]] = {}
        for pool in pools:
            for s in self.map.shards_of_pool(pool):
                by_shard.setdefault(s, []).append(pool)
        self._pools = pools
        self._by_shard = by_shard
        self._dirty = False
        self.generation += 1

    def _shard_pools_locked(self, shard: int) -> "list[_PoolAgg]":
        return [self._pools[p] for p in self._by_shard.get(shard, ())]

    # --- routing ---

    def route(self, pod: PodSpec) -> str:
        """The shard lane this pod belongs to: ``s<i>`` or GLOBAL_LANE.
        Deterministic (keyed rendezvous over the gang name / pod uid
        across feasible shards) and whole-gang-consistent — every member
        computes the same answer. Never raises: anything unroutable
        (malformed labels, empty fleet) belongs to the global lane,
        whose full-fleet stack runs the normal admission machinery."""
        try:
            return self._route_inner(pod)
        except Exception:  # noqa: BLE001 — unroutable -> global lane
            return GLOBAL_LANE

    def _route_inner(self, pod: PodSpec) -> str:
        try:
            req = pod_request(pod)
        except LabelParseError:
            return GLOBAL_LANE
        with self._lock:
            if self._dirty:
                self._rebuild_locked()
            gang = req.gang
            if gang is None:
                feasible = [
                    s
                    for s in range(self.map.shard_count)
                    if any(
                        a.max_node_chips >= req.effective_chips
                        for a in self._shard_pools_locked(s)
                    )
                ]
                key = pod.uid or pod.key
            elif gang.topology is not None:
                want = normalize_dims(gang.topology)
                feasible = [
                    s
                    for s in range(self.map.shard_count)
                    if sum(
                        _blocks_in_grid(a.dims, want)
                        for a in self._shard_pools_locked(s)
                        if a.dims != (0, 0, 0)
                    )
                    >= gang.slices
                ]
                key = gang_name_of(pod.labels) or pod.uid
            else:
                # Plain gang: enough member slots across the partition
                # for the whole gang (floor(cap/chips) per host class).
                need = gang.size
                per = max(req.effective_chips, 1)
                feasible = []
                for s in range(self.map.shard_count):
                    slots = sum(
                        n * (cap // per)
                        for a in self._shard_pools_locked(s)
                        for cap, n in a.node_chips.items()
                    )
                    if slots >= need:
                        feasible.append(s)
                key = gang_name_of(pod.labels) or pod.uid
            is_gang = gang is not None
            gen = self.generation
            if is_gang:
                memo = self._gang_memo.get(key)
                if memo is not None and memo[0] == gen:
                    # Whole-gang consistency: later members (and reroute
                    # passes) repeat the first member's answer until a
                    # structural change invalidates it.
                    self._gang_memo.move_to_end(key)
                    return memo[1]
            lane = self._pick_locked(feasible, key)
            if is_gang:
                self._gang_memo[key] = (gen, lane)
                while len(self._gang_memo) > self.MAX_GANG_MEMO:
                    self._gang_memo.popitem(last=False)
            return lane

    def _pick_locked(self, feasible: "list[int]", key: str) -> str:
        """Choose among capacity-feasible shards: lowest occupancy
        BUCKET first (quantized live queue depth — the tie-break that
        steers work off starved shards), then keyed rendezvous.
        Deterministic given the depth snapshot; pure rendezvous when no
        depth source is wired or depths are balanced."""
        if not feasible:
            return GLOBAL_LANE
        candidates = feasible
        depth_fn = self.depth_fn
        if depth_fn is not None and len(feasible) > 1:
            buckets: dict[int, int] = {}
            for s in feasible:
                try:
                    depth = max(int(depth_fn(s)), 0)
                except Exception:  # noqa: BLE001 — a sick depth source reads as empty
                    depth = 0
                buckets[s] = (depth // self.OCCUPANCY_QUANTUM).bit_length()
            best = min(buckets.values())
            candidates = [s for s in feasible if buckets[s] == best]
        chosen = max(
            candidates, key=lambda s: _digest("route", key, str(s))
        )
        return shard_name(chosen)


class WorkerSupervisor:
    """Shard worker process lifecycle for ``shard_mode=process``: spawn
    one OS process per shard lane, poll liveness, respawn dead workers
    with exponential backoff (a replacement warm-starts like a promoted
    standby — its informer resyncs and its staged residue was already
    the parent journal's to recover), and kill/stop on teardown.

    ``spawn_fn(shard_index) -> subprocess.Popen`` is injected so the
    supervisor never knows whether it is launching a production kube
    worker, a bench spec worker, or a chaos driver.
    """

    RESPAWN_BACKOFF_S = 0.5
    RESPAWN_BACKOFF_MAX_S = 15.0

    def __init__(
        self,
        spawn_fn: "Callable[[int], object]",
        shard_count: int,
        *,
        max_respawns: "int | None" = None,
        clock=None,
    ) -> None:
        import time as _time

        self.spawn_fn = spawn_fn
        self.shard_count = int(shard_count)
        self.max_respawns = max_respawns
        self.clock = clock if clock is not None else _time.monotonic
        self._lock = threading.Lock()
        self._procs: "dict[int, object]" = {}
        self._restarts: "dict[int, int]" = {}
        self._next_spawn_at: "dict[int, float]" = {}
        self._stopping = False

    def start(self) -> None:
        for i in range(self.shard_count):
            self._spawn(i)

    def _spawn(self, i: int) -> None:
        proc = self.spawn_fn(i)
        with self._lock:
            self._procs[i] = proc
            self._next_spawn_at.pop(i, None)

    def poll(self) -> "list[int]":
        """One supervision pass: respawn every dead worker whose
        backoff has elapsed (and whose respawn budget remains).
        Returns the shard indices respawned this pass."""
        if self._stopping:
            return []
        respawned: "list[int]" = []
        now = self.clock()
        with self._lock:
            rows = list(self._procs.items())
        for i, proc in rows:
            if proc is not None and proc.poll() is None:
                continue  # alive
            with self._lock:
                restarts = self._restarts.get(i, 0)
                if (
                    self.max_respawns is not None
                    and restarts >= self.max_respawns
                ):
                    continue
                due = self._next_spawn_at.get(i)
                if due is None:
                    backoff = min(
                        self.RESPAWN_BACKOFF_S * (2 ** restarts),
                        self.RESPAWN_BACKOFF_MAX_S,
                    )
                    self._next_spawn_at[i] = now + backoff
                    continue
                if now < due:
                    continue
                self._restarts[i] = restarts + 1
            self._spawn(i)
            respawned.append(i)
        return respawned

    def alive(self) -> int:
        with self._lock:
            return sum(
                1
                for p in self._procs.values()
                if p is not None and p.poll() is None
            )

    def kill(self, i: int, sig: "int | None" = None) -> None:
        """Hard-kill one worker (chaos surface: SIGKILL by default)."""
        import signal as _signal

        with self._lock:
            proc = self._procs.get(i)
        if proc is None or proc.poll() is not None:
            return
        proc.send_signal(sig if sig is not None else _signal.SIGKILL)

    def stop(self, *, timeout_s: float = 10.0) -> None:
        """Graceful teardown: SIGTERM everyone, wait, then SIGKILL the
        stragglers. No respawns after this."""
        import signal as _signal

        self._stopping = True
        with self._lock:
            procs = [
                p
                for p in self._procs.values()
                if p is not None and p.poll() is None
            ]
        for p in procs:
            try:
                p.send_signal(_signal.SIGTERM)
            except (OSError, ValueError):
                pass
        deadline = self.clock() + timeout_s
        for p in procs:
            remaining = max(deadline - self.clock(), 0.1)
            try:
                p.wait(timeout=remaining)
            except Exception:  # noqa: BLE001 — straggler: escalate below
                try:
                    p.kill()
                    p.wait(timeout=5.0)
                except Exception:  # noqa: BLE001 — already gone
                    pass

    def debug(self) -> "list[dict]":
        with self._lock:
            rows = []
            for i in sorted(self._procs):
                p = self._procs[i]
                rows.append(
                    {
                        "shard": shard_name(i),
                        "pid": getattr(p, "pid", None),
                        "alive": bool(p is not None and p.poll() is None),
                        "restarts": self._restarts.get(i, 0),
                    }
                )
        return rows
