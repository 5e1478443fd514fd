"""Seeded trace generation + million-pod replay (ISSUE 12).

bench.py's scenarios are hand-shaped; production confidence needs replayed
reality. This module generates a seeded, deterministic stream of pod
lifecycles — diurnal arrival waves, tenant mixes, gang-size distributions,
priority tiers, flash crowds, failure bursts, rolling-upgrade drains — and
drives a full scheduler stack with it through the BATCHED ingest path
(cluster/ingest.EventBatcher) on a **virtual clock**, at 1M+
pod-lifecycle scale. The fleet SLO engine (yoda_tpu/slo) measures the
replay: per-tenant admission-wait quantiles, starvation windows,
preemption/repair rates — the numbers the bench scenario matrix asserts.

Determinism contract: one seed -> one exact event stream -> one exact
SLI summary (the ``fingerprint``), because

- every random draw comes from ``random.Random(seed)`` (arrivals,
  lifetimes, tenant/gang/priority picks) or ``Random(seed + 1)``
  (replay-side victim/drain choices);
- the stack runs on a replay-owned virtual clock (``ReplayClock``), so
  admission waits, backoff timers, permit deadlines, starvation windows,
  and burn-rate windows are all measured in VIRTUAL seconds — wall-clock
  jitter cannot leak into any SLI;
- scheduling is drained synchronously (``_settle``) on the replay
  thread: no bind executor fan-out, no background loops — the
  rebalancer/node-health passes run at explicit virtual times.

Foreign churn: most of a million-pod fleet's watch stream is OTHER
people's pods. ``foreign_rate_per_s`` generates non-TPU pods under a
foreign schedulerName — they flow through the whole batched-ingest
pipeline and the informer caches (the scale the replay proves) without
entering this scheduler's queue, exactly like a real shared cluster.

Counterpart of ``yoda_tpu/testing/tracegen.py``, line for line, over the
port's modules. :func:`replay` builds its stacks with the configuration's
``kernel_platform`` ("auto" in :func:`_default_config`): every settle's
fleet evaluations run on the CUDA card, and the build raises without one;
a caller asks for the host with ``kernel_platform: cpu``.
"""

from __future__ import annotations

import heapq
import math
import random
import time
from dataclasses import dataclass, field
from typing import Iterator

from yoda_tpu_torch.api.types import PodSpec

FOREIGN_SCHEDULER = "ext-scheduler"


@dataclass(frozen=True)
class TenantMix:
    """One tenant's slice of the arrival stream."""

    name: str
    weight: float = 1.0           # share of the scheduled arrival rate
    priority: int = 0             # tpu/priority label (spot=0, prod=high)
    chips: "tuple[int, ...]" = (1, 2)
    gang_fraction: float = 0.0    # fraction of arrivals that are gangs
    gang_sizes: "tuple[int, ...]" = (2,)
    topology: str = ""            # tpu/topology for gangs ("" = plain)
    # Lifetime range override; None = the spec-level range.
    lifetime_s: "tuple[float, float] | None" = None


@dataclass(frozen=True)
class FlashCrowd:
    """A burst window: ``extra_rate_per_s`` singleton arrivals for
    ``tenant`` between t0 and t0+duration (the flash-crowd scenario)."""

    t0: float
    duration_s: float
    extra_rate_per_s: float
    tenant: str
    chips: int = 1
    priority: int = 0
    lifetime_s: "tuple[float, float]" = (20.0, 60.0)


@dataclass(frozen=True)
class TraceSpec:
    """Everything the generator needs; hashable + frozen so a scenario IS
    its spec (and its seed IS its stream)."""

    seed: int = 0
    duration_s: float = 600.0
    # Mean SCHEDULED arrivals/s across tenants, modulated diurnally:
    # rate(t) = base * (1 + amplitude * sin(2*pi*t / period)).
    base_rate_per_s: float = 4.0
    diurnal_amplitude: float = 0.0
    diurnal_period_s: float = 600.0
    tenants: "tuple[TenantMix, ...]" = (TenantMix("team-a"),)
    lifetime_s: "tuple[float, float]" = (40.0, 160.0)
    # Foreign (non-TPU, foreign-schedulerName) churn riding the same
    # watch stream + batched ingest — the million-lifecycle scale knob.
    foreign_rate_per_s: float = 0.0
    foreign_lifetime_s: "tuple[float, float]" = (20.0, 60.0)
    flash_crowds: "tuple[FlashCrowd, ...]" = ()
    # (virtual time, node kill count): failure bursts (kill_node — Node +
    # TPU CR deleted, bound pods left for gang-whole repair).
    failure_bursts: "tuple[tuple[float, int], ...]" = ()
    # (virtual time, node drain count): rolling-upgrade drains; drained
    # nodes return healthy after drain_recover_s (the upgrade finishing).
    drains: "tuple[tuple[float, int], ...]" = ()
    drain_recover_s: float = 120.0


@dataclass
class TraceOp:
    """One generated arrival: a singleton, a whole gang (members arrive
    together — a gang is submitted atomically), or a foreign pod."""

    t: float
    tenant: str
    chips: int
    priority: int
    lifetime_s: float
    gang_size: int = 0           # 0 = singleton
    topology: str = ""
    foreign: bool = False


def _poisson(rng: random.Random, lam: float) -> int:
    """Seeded Poisson sample (Knuth below lambda 30, normal approx
    above — both fully deterministic under the rng)."""
    if lam <= 0:
        return 0
    if lam < 30.0:
        limit = math.exp(-lam)
        k, p = 0, 1.0
        while True:
            p *= rng.random()
            if p <= limit:
                return k
            k += 1
    return max(int(rng.gauss(lam, math.sqrt(lam)) + 0.5), 0)


def generate(spec: TraceSpec) -> "Iterator[TraceOp]":
    """The seeded lifecycle stream, time-ordered. Lazy: a million-pod
    trace is produced op by op, never materialized."""
    rng = random.Random(spec.seed)
    tenants = list(spec.tenants)
    weights = [max(t.weight, 0.0) for t in tenants]
    step = 1.0
    t = 0.0
    while t < spec.duration_s:
        ops: "list[TraceOp]" = []
        rate = spec.base_rate_per_s * (
            1.0
            + spec.diurnal_amplitude
            * math.sin(2.0 * math.pi * t / spec.diurnal_period_s)
        )
        for _ in range(_poisson(rng, max(rate, 0.0) * step)):
            mix = rng.choices(tenants, weights=weights)[0]
            lo, hi = mix.lifetime_s or spec.lifetime_s
            life = rng.uniform(lo, hi)
            if mix.gang_fraction > 0 and rng.random() < mix.gang_fraction:
                ops.append(
                    TraceOp(
                        t,
                        mix.name,
                        rng.choice(mix.chips),
                        mix.priority,
                        life,
                        gang_size=rng.choice(mix.gang_sizes),
                        topology=mix.topology,
                    )
                )
            else:
                ops.append(
                    TraceOp(
                        t, mix.name, rng.choice(mix.chips), mix.priority,
                        life,
                    )
                )
        for crowd in spec.flash_crowds:
            if crowd.t0 <= t < crowd.t0 + crowd.duration_s:
                for _ in range(
                    _poisson(rng, crowd.extra_rate_per_s * step)
                ):
                    ops.append(
                        TraceOp(
                            t,
                            crowd.tenant,
                            crowd.chips,
                            crowd.priority,
                            rng.uniform(*crowd.lifetime_s),
                        )
                    )
        for _ in range(_poisson(rng, spec.foreign_rate_per_s * step)):
            ops.append(
                TraceOp(
                    t, "ext", 0, 0,
                    rng.uniform(*spec.foreign_lifetime_s),
                    foreign=True,
                )
            )
        yield from ops
        t += step


class ReplayClock:
    """The replay-owned virtual clock every stack component runs on."""

    __slots__ = ("now",)

    def __init__(self, start: float = 0.0) -> None:
        self.now = start

    def __call__(self) -> float:
        return self.now


@dataclass
class ReplayReport:
    """What one replay did + the SLO engine's verdict on it."""

    lifecycles: int = 0          # pods created (scheduled + foreign)
    scheduled_created: int = 0
    foreign_created: int = 0
    deleted: int = 0
    binds: int = 0
    preemptions: int = 0
    repairs: int = 0
    ingest_events: int = 0       # raw watch events through batched ingest
    ingest_batches: int = 0
    # Overload ladder (drive_overload): draws shed + the peak level the
    # ladder reached during the replay (0 = never left NOMINAL).
    shed: int = 0
    overload_peak_level: int = 0
    killed_nodes: "list[str]" = field(default_factory=list)
    drained_nodes: "list[str]" = field(default_factory=list)
    # Pods still bound on a drained node when its upgrade finished (0 =
    # every drain fully evacuated before the node returned).
    drain_leftover: int = 0
    slo: dict = field(default_factory=dict)   # final engine evaluation
    wall_s: float = 0.0
    # The still-open stack when ``replay(..., keep_stack=True)`` — the
    # caller owns its shutdown (gang.close / ingestor.stop /
    # tracer.close). None on normal runs; never in fingerprint().
    stack: "object | None" = None

    def fingerprint(self) -> dict:
        """The determinism contract: identical seeds must produce THIS
        dict identically (virtual-time SLIs + replay counters only —
        nothing wall-clock-derived)."""
        tenants = {
            name: {
                "admission_wait_p99_s": row["admission_wait_p99_s"],
                "admissions_total": row["admissions_total"],
                "starved_windows": row["starved_windows"],
            }
            for name, row in sorted(self.slo.get("tenants", {}).items())
        }
        fleet = self.slo.get("fleet", {})
        return {
            "lifecycles": self.lifecycles,
            "deleted": self.deleted,
            "binds": self.binds,
            "preemptions": self.preemptions,
            "repairs": self.repairs,
            "ingest_events": self.ingest_events,
            "killed": list(self.killed_nodes),
            "drained": list(self.drained_nodes),
            "drain_leftover": self.drain_leftover,
            "fleet_p99_s": fleet.get("admission_wait_p99_s"),
            "fleet_starved": fleet.get("starved_windows"),
            "tenants": tenants,
        }


def _settle(stack, clock, *, max_cycles: int = 500_000) -> None:
    """Drain the queue deterministically on the replay thread: pop ->
    gang/burst gather -> full cycles, then one permit-expiry sweep at the
    frozen virtual now. Unlike ``run_until_idle`` this never sleeps on
    wall time — a gang parked at Permit (or a pod in virtual backoff)
    simply waits for the next virtual step."""
    scheduler, queue, fw = stack.scheduler, stack.queue, stack.framework
    for _ in range(max_cycles):
        qpi = queue.pop(timeout=0.0)
        if qpi is None:
            fw.expire_waiting(now=clock())
            qpi = queue.pop(timeout=0.0)
            if qpi is None:
                return
        for q in scheduler._pop_batch(qpi):
            scheduler.schedule_one(q)
    raise RuntimeError("replay settle did not converge (scheduling loop?)")


def check_invariants(stack) -> None:
    """No host oversubscribed, ever: the replay-wide safety net."""
    for ni in stack.informer.snapshot().infos():
        if ni.tpu is None:
            continue
        used = stack.accountant.chips_in_use(ni.name)
        cap = len(ni.tpu.healthy_chips())
        assert used <= cap, (
            f"node {ni.name} oversubscribed: {used} chips in use > {cap}"
        )


def _default_config():
    from yoda_tpu_torch.config import SchedulerConfig

    return SchedulerConfig(
        mode="batch",
        batch_requests=16,
        tenant_fairness=True,
        # The whole point: every lifecycle flows through batched ingest.
        # The window is parked at its validation ceiling so the real-time
        # drain thread never fires between the replay's explicit
        # flushes (determinism); batch_max still flushes synchronously.
        ingest_batch_window_ms=10_000.0,
        ingest_batch_max=2048,
        # Tracing off: the replay measures SLO machinery, not spans.
        trace_sample_rate=0.0,
        # The silence ladder reads wall-domain agent stamps the virtual
        # replay never refreshes; park it out of reach — failure bursts
        # and drains act at event time / by operator call instead.
        node_suspect_after_s=1e9,
        node_down_after_s=1e9,
    )


def replay(
    spec: TraceSpec,
    *,
    config=None,
    hosts: int = 8,
    chips_per_host: int = 8,
    slices: int = 0,
    slice_topology: "tuple[int, int, int]" = (2, 2, 1),
    settle_every_s: float = 5.0,
    eval_every_s: float = 30.0,
    drive_rebalancer: bool = False,
    drive_overload: bool = False,
    max_wall_s: float = 900.0,
    shard_count: int = 1,
    keep_stack: bool = False,
) -> ReplayReport:
    """Drive one full scheduler stack with the spec's generated stream.

    Fleet: ``hosts`` v5e hosts of ``chips_per_host`` chips plus
    ``slices`` v5p slices of ``slice_topology`` (for topology gangs).
    Every ``settle_every_s`` of virtual time: departures -> arrivals ->
    faults/drains -> ingest flush -> deterministic settle -> node-health
    pass (and rebalancer pass when ``drive_rebalancer``); the SLO engine
    evaluates every ``eval_every_s`` so starvation windows accrue on the
    virtual timeline.

    ``shard_count > 1`` replays the SAME stream through a sharded
    assembly (standalone.build_sharded_stacks): every lane's queue
    settles round-robin on the replay thread — deterministic like the
    single-stack drive — with the starved-work rescue pass between
    rounds, the node-health/rebalancer passes on the global lane only,
    and the one shared SLO engine aggregating across the
    shard-partitioned DRF queues (exactly what the sharded flash-crowd
    scenario asserts fairness over)."""
    from yoda_tpu_torch.agent import FakeTpuAgent
    from yoda_tpu_torch.standalone import build_sharded_stacks, build_stack

    t_start = time.monotonic()
    clock = ReplayClock()
    config = config if config is not None else _default_config()
    assert config.ingest_batch_window_ms > 0, (
        "the replay exists to drive the BATCHED ingest path; set "
        "ingest_batch_window_ms > 0"
    )
    shard_set = None
    if shard_count > 1:
        from dataclasses import replace as _replace

        config = _replace(config, shard_count=shard_count)
        shard_set = build_sharded_stacks(config=config, clock=clock)
        stack = shard_set.global_stack
        all_stacks = shard_set.stacks
    else:
        stack = build_stack(config=config, clock=clock)
        all_stacks = [stack]

    def flush_all() -> None:
        for st in all_stacks:
            st.ingestor.flush()

    def settle_all() -> None:
        if shard_set is None:
            _settle(stack, clock)
            return
        # Round-robin over lanes until a full quiet round: a losing
        # lane's conflict rollback (or a rescue move) requeues work
        # another lane must then drain — same fixed point as the
        # threaded production drain, single-threaded for determinism.
        for _ in range(64):
            for st in all_stacks:
                _settle(st, clock)
            flush_all()
            moved = shard_set.rescue_starved(min_attempts=1)
            if moved == 0 and all(
                st.queue.depths()[0] == 0 for st in all_stacks
            ):
                return
        raise RuntimeError("sharded replay settle did not converge")
    agent = FakeTpuAgent(stack.cluster)
    for i in range(hosts):
        agent.add_host(f"h{i:03d}", generation="v5e", chips=chips_per_host)
    for s in range(slices):
        agent.add_slice(
            f"v5p-{s}", generation="v5p", host_topology=slice_topology
        )
    agent.publish_all()
    flush_all()
    settle_all()

    report = ReplayReport()
    rng2 = random.Random(spec.seed + 1)  # replay-side picks (kills/drains)
    ops = generate(spec)
    pending_op = next(ops, None)
    departures: "list[tuple[float, int, str]]" = []  # (t, seq, pod key)
    faults = sorted(spec.failure_bursts)
    drains = sorted(spec.drains)
    recoveries: "list[tuple[float, str]]" = []
    fi = di = 0
    seq = 0
    live_hosts = sorted(f"h{i:03d}" for i in range(hosts))
    draining: "set[str]" = set()
    now = 0.0
    next_eval = eval_every_s
    engine = stack.metrics.slo

    def create(op: TraceOp) -> None:
        nonlocal seq
        if op.foreign:
            key_name = f"x{seq}"
            seq += 1
            pod = PodSpec(
                key_name, namespace="ext", scheduler_name=FOREIGN_SCHEDULER
            )
            stack.cluster.create_pod(pod)
            heapq.heappush(
                departures, (op.t + op.lifetime_s, seq, pod.key)
            )
            report.foreign_created += 1
            report.lifecycles += 1
            return
        labels = {"tpu/chips": str(op.chips)}
        if op.priority:
            labels["tpu/priority"] = str(op.priority)
        if op.gang_size > 0:
            tag = f"{op.tenant}-g{seq}"
            seq += 1
            labels["tpu/gang"] = tag
            if op.topology:
                # Topology implies the member count; the explicit size
                # label is the plain-gang spelling.
                labels["tpu/topology"] = op.topology
            else:
                labels["tpu/gang-size"] = str(op.gang_size)
            for m in range(op.gang_size):
                pod = PodSpec(
                    f"{tag}-{m}", namespace=op.tenant, labels=dict(labels)
                )
                stack.cluster.create_pod(pod)
                heapq.heappush(
                    departures, (op.t + op.lifetime_s, seq * 64 + m, pod.key)
                )
                report.scheduled_created += 1
                report.lifecycles += 1
        else:
            name = f"p{seq}"
            seq += 1
            pod = PodSpec(name, namespace=op.tenant, labels=labels)
            stack.cluster.create_pod(pod)
            heapq.heappush(departures, (op.t + op.lifetime_s, seq, pod.key))
            report.scheduled_created += 1
            report.lifecycles += 1

    while now < spec.duration_s:
        now = min(now + settle_every_s, spec.duration_s)
        clock.now = now
        if time.monotonic() - t_start > max_wall_s:
            raise RuntimeError(
                f"replay exceeded max_wall_s={max_wall_s} at virtual "
                f"t={now:.0f}/{spec.duration_s:.0f}"
            )
        # Departures first: capacity freed this step is placeable this
        # step (the delete events ride the same flushed batch).
        while departures and departures[0][0] <= now:
            _, _, key = heapq.heappop(departures)
            stack.cluster.delete_pod(key)
            report.deleted += 1
        while pending_op is not None and pending_op.t <= now:
            create(pending_op)
            pending_op = next(ops, None)
        while fi < len(faults) and faults[fi][0] <= now:
            _, kill = faults[fi]
            fi += 1
            pool = sorted(set(live_hosts) - draining)
            victims = rng2.sample(pool, min(kill, max(len(pool) - 1, 0)))
            for name in sorted(victims):
                stack.cluster.kill_node(name)
                live_hosts.remove(name)
                report.killed_nodes.append(name)
        while di < len(drains) and drains[di][0] <= now:
            _, n_drain = drains[di]
            di += 1
            targets = [h for h in live_hosts if h not in draining][
                : max(n_drain, 0)
            ]
            for name in targets:
                stack.nodehealth.drain(name)
                draining.add(name)
                recoveries.append((now + spec.drain_recover_s, name))
                report.drained_nodes.append(name)
        for t_rec, name in list(recoveries):
            if t_rec <= now and name in draining:
                # The upgrade finished: the node rejoins the fleet.
                report.drain_leftover += sum(
                    1
                    for p in stack.cluster.list_pods()
                    if p.node_name == name
                )
                stack.nodehealth.cancel_drain(name)
                draining.discard(name)
                recoveries.remove((t_rec, name))
        flush_all()
        if drive_overload:
            # The brownout ladder ticks BEFORE the settle: shed/brownout
            # verdicts apply to this step's pops, exactly as the
            # background monitor thread would beat a production cycle.
            # The monitor runs on the replay clock (deterministic).
            ov = stack.metrics.overload
            ov.evaluate(now)
            report.overload_peak_level = max(
                report.overload_peak_level, ov.level_idx
            )
        settle_all()
        stack.nodehealth.run_once()
        if drive_rebalancer:
            stack.rebalancer.run_once()
        # Repairs/moves requeue pods; settle them in the same step.
        flush_all()
        settle_all()
        if now >= next_eval or now >= spec.duration_s:
            engine.evaluate(now)
            next_eval += eval_every_s

    check_invariants(stack)
    if shard_set is not None:
        assert not shard_set.accountant.staged_uids(), (
            "staged shard claims leaked past the replay's settle"
        )
    report.binds = sum(st.scheduler.stats.binds for st in all_stacks)
    m = stack.metrics
    report.preemptions = int(
        m.preemptions.total() + m.rebalance_preemptions.total()
    )
    report.repairs = int(m.gang_repairs.total())
    report.ingest_events = sum(st.ingestor.events_in for st in all_stacks)
    report.ingest_batches = sum(st.ingestor.batches for st in all_stacks)
    report.shed = int(stack.metrics.overload.shed_total)
    report.slo = engine.evaluate(spec.duration_s)
    report.wall_s = time.monotonic() - t_start
    if keep_stack:
        # Hand the live stack (and its cluster/journal) to the caller —
        # the journal soak promotes a standby over them after this run.
        assert shard_count == 1, "keep_stack is single-stack only"
        report.stack = stack
        return report
    for st in all_stacks:
        st.gang.close()
        st.ingestor.stop()
    stack.metrics.tracer.close()
    return report
