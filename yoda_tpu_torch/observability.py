"""Observability: metrics registry, per-phase latency histograms, and the
scheduling trace.

The reference has NO first-party observability — only klog verbosity lines
(reference pkg/yoda/scheduler.go:58,67,86,143) and whatever the wrapped
upstream command exposes (SURVEY.md §5 tracing/metrics rows). Here the
metrics the BASELINE targets are measured in (p99 scheduling latency,
bin-packing efficiency) are first-class:

- ``yoda_scheduling_attempts_total{result}``, ``yoda_binds_total``,
  ``yoda_preemptions_total`` — counters.
- ``yoda_scheduling_latency_seconds{phase}`` — histogram over the whole
  cycle and each extension-point phase (the per-hook breakdown the <200 ms
  p99 budget is debugged with).
- ``yoda_gang_wait_seconds`` — histogram of Permit-parking time per gang
  member.
- ``yoda_tpu_chips_free`` / ``yoda_tpu_chips_total`` — fleet gauges
  (bin-packing efficiency = 1 - free/total under load), collected lazily at
  scrape time.
- A bounded scheduling-trace ring (pod → feasible count → chosen node →
  outcome, with per-phase timings) — the "scheduling-trace log" of
  SURVEY.md §5, queryable in-process and dumped on demand.

Everything is dependency-free (no prometheus_client in the image) and
renders the Prometheus text exposition format for the /metrics endpoint
(yoda_tpu_torch/metrics_server.py).

Counterpart of ``yoda_tpu/observability.py``, whole: every family of
``SchedulingMetrics`` registers with the reference's name, help string
and type, so one scrape schema holds across both packages.
``build_stack`` feeds ``yoda_ingest_events_total`` and
``yoda_ingest_batch_size`` from its ``EventBatcher`` (batched ingest on),
``yoda_events_dropped_total`` from the ``EventRecorder``'s backlog sheds,
and ``yoda_tenant_quota_parks_total`` from the overload ladder's BROWNOUT
parks and the per-tenant quotas alike. The ``yoda_commit_rpc_*``
families are fed by the commit RPC server of process-mode lanes
(``framework/procserve.py``: calls and latency per op and transport,
refused commits per lane) and ``yoda_standby_lag_frames`` by the tailing
standby (``journal/tail.py``). ``yoda_cluster_state``,
``yoda_cluster_transitions_total`` and ``yoda_spillover_gangs_total``
are fed by the federation (``federation/``, over the members' shared
registry: each member's health state and transitions, each gang migrated
whole). ``yoda_shard_commit_rollbacks_total`` is fed by a
scheduler lane's lost gang commits and ``yoda_commit_term`` by a replayed
journal's term (``standalone.build_stack``); the per-lane gauges and the
``yoda_shard_commit_*`` and ``yoda_journal_*`` counters are registered
by ``standalone.build_stack`` over the live lanes and journals.
``yoda_overlap_cycles_total`` is fed by the scheduler's
serve and drain loops (a turn popped while pipelined binds are in flight).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping

# Latency buckets tuned around the 200 ms p99 target: resolution where the
# budget lives, coarse tails for pathologies.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.2, 0.5, 1.0, 2.5, 10.0,
)


def _fmt_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """A counter; ``collect_fn`` makes it lazy (the monotonic value lives
    elsewhere — e.g. a plugin's attribute — and is read at scrape time),
    mirroring Gauge's lazy mode but keeping the Prometheus ``counter``
    type for ``_total``-named series."""

    def __init__(
        self,
        name: str,
        help_: str,
        collect_fn: Callable[[], float] | None = None,
    ) -> None:
        self.name = name
        self.help = help_
        self.collect_fn = collect_fn
        self._lock = threading.Lock()
        self._values: dict[tuple[tuple[str, str], ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        assert self.collect_fn is None, "lazy counters are scrape-only"
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        if self.collect_fn is not None:
            return float(self.collect_fn())
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        if self.collect_fn is not None:
            return float(self.collect_fn())
        with self._lock:
            return sum(self._values.values())

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        if self.collect_fn is not None:
            out.append(f"{self.name} {float(self.collect_fn())}")
            return out
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items or [((), 0.0)]:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return out


class Gauge:
    """A gauge; ``collect_fn`` makes it lazy (evaluated at scrape time),
    which is how fleet-state gauges avoid a watch pipeline of their own."""

    def __init__(
        self,
        name: str,
        help_: str,
        collect_fn: Callable[[], float | dict[tuple[tuple[str, str], ...], float]]
        | None = None,
    ) -> None:
        self.name = name
        self.help = help_
        self.collect_fn = collect_fn
        self._lock = threading.Lock()
        self._values: dict[tuple[tuple[str, str], ...], float] = {}

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value

    def remove(self, **labels: str) -> None:
        """Retire one label series (bounded gauge cardinality): a
        long-lived process must drop per-object series — a deleted
        node's ``yoda_node_state{node=...}`` row, a departed tenant's
        share — or every object that EVER existed scrapes forever."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values.pop(key, None)

    def value(self, **labels: str) -> float:
        if self.collect_fn is not None:
            got = self.collect_fn()
            if isinstance(got, dict):
                return got.get(tuple(sorted(labels.items())), 0.0)
            return float(got)
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        if self.collect_fn is not None:
            got = self.collect_fn()
            values = got if isinstance(got, dict) else {(): float(got)}
        else:
            with self._lock:
                values = dict(self._values)
        for key, v in sorted(values.items()) or [((), 0.0)]:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return out


class Histogram:
    # Recent-observation ring size per label series (exact quantiles up
    # to this many samples; the BASELINE p99 is computed from it).
    RING = 4096

    def __init__(
        self,
        name: str,
        help_: str,
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ) -> None:
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        # label-key -> [per-bucket counts, count, sum, quantile ring].
        # The ring is a PREALLOCATED list written by index (count % RING)
        # — after a series' first observation the hot path allocates
        # nothing (the old deque paid a node box per append), which the
        # sub-millisecond serve budget cares about: observe() runs on
        # every cycle for every phase.
        self._series: dict[tuple[tuple[str, str], ...], list] = {}

    def _series_for(self, key):
        s = self._series.get(key)
        if s is None:
            s = [[0] * len(self.buckets), 0, 0.0, [0.0] * self.RING]
            self._series[key] = s
        return s

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            s = self._series_for(key)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    s[0][i] += 1
            # Ring slot BEFORE the count bump: slot = total observations
            # so far, mod ring size — allocation-free in-place write.
            s[3][s[1] % self.RING] = value
            s[1] += 1
            s[2] += value

    def count(self, **labels: str) -> int:
        key = tuple(sorted(labels.items()))
        with self._lock:
            s = self._series.get(key)
            return s[1] if s else 0

    def quantile(self, q: float, **labels: str) -> float:
        """Quantile over the recent-observation ring (exact for <=RING
        samples — the BASELINE p99 is computed from this, not from bucket
        interpolation). The live slots are COPIED under the metric lock
        and sorted outside it: the O(n log n) sort used to run inside the
        lock, so a scrape/quantile burst could stall every ``observe()``
        on the serve path behind 4096-sample sorts. Wrap order does not
        matter — a quantile is order-blind over the window."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            s = self._series.get(key)
            if not s or not s[1]:
                return 0.0
            data = s[3][: min(s[1], self.RING)]  # the slice is the copy
        data.sort()
        return data[min(int(len(data) * q), len(data) - 1)]

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            series = {k: (list(s[0]), s[1], s[2]) for k, s in self._series.items()}
        for key, (counts, n, total) in sorted(series.items()):
            labels = dict(key)
            for b, c in zip(self.buckets, counts):
                out.append(
                    f"{self.name}_bucket{_fmt_labels({**labels, 'le': repr(b)})} {c}"
                )
            out.append(f"{self.name}_bucket{_fmt_labels({**labels, 'le': '+Inf'})} {n}")
            out.append(f"{self.name}_sum{_fmt_labels(labels)} {total}")
            out.append(f"{self.name}_count{_fmt_labels(labels)} {n}")
        return out


class Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: list = []

    def register(self, metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def counter(self, name: str, help_: str, collect_fn=None) -> Counter:
        return self.register(Counter(name, help_, collect_fn))

    def gauge(self, name: str, help_: str, collect_fn=None) -> Gauge:
        return self.register(Gauge(name, help_, collect_fn))

    def histogram(self, name: str, help_: str, buckets=DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_, buckets))

    def render_prometheus(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


@dataclass
class TraceEntry:
    """One scheduling attempt, end to end — the trace the reference lacked
    (its debugging story was klog.V(3) lines, reference scheduler.go:67,143)."""

    pod_key: str
    outcome: str
    node: str | None
    nodes_total: int
    nodes_feasible: int
    message: str = ""
    phases_ms: dict[str, float] = field(default_factory=dict)
    wall_unix: float = 0.0

    def oneline(self) -> str:
        ph = " ".join(f"{k}={v:.2f}ms" for k, v in self.phases_ms.items())
        return (
            f"{self.pod_key}: {self.outcome}"
            f"{' -> ' + self.node if self.node else ''} "
            f"[{self.nodes_feasible}/{self.nodes_total} feasible] {ph}"
            f"{' | ' + self.message if self.message else ''}"
        )


class SchedulingMetrics:
    """The scheduler's metric set + trace ring, shared across plugins.

    Also carries the cross-loop observability surfaces —
    ``tracer`` (yoda_tpu_torch/tracing.Tracer, the lifecycle span recorder) and
    ``pending`` (tracing.PendingIndex, the why-pending rejection index) —
    because this object is already threaded through every control loop
    (scheduler, reconciler, rebalancer, federation) and shared across
    profile stacks exactly the way traces must be."""

    def __init__(
        self,
        *,
        registry: Registry | None = None,
        trace_capacity: int = 512,
        tracer=None,
        pending=None,
        slo=None,
        overload=None,
    ):
        from yoda_tpu_torch.overload import OverloadMonitor
        from yoda_tpu_torch.slo import SloEngine
        from yoda_tpu_torch.tracing import PendingIndex, Tracer

        self.registry = registry or Registry()
        self.tracer = tracer if tracer is not None else Tracer()
        self.pending = pending if pending is not None else PendingIndex()
        # Fleet SLO engine (yoda_tpu_torch/slo): rides this object for
        # the same reason the tracer does — one engine must aggregate
        # per-tenant SLIs across every profile stack and federation
        # member that can bind the tenant's pods.
        self.slo = slo if slo is not None else SloEngine()
        # Overload brownout ladder (yoda_tpu_torch/overload.py): ONE
        # ladder across every serve loop sharing this registry — a shard
        # lane shedding while its sibling admits would defeat the
        # self-protection. build_stack registers queues/ingestors as
        # pressure sources and composes the repair-pause gates.
        self.overload = (
            overload if overload is not None else OverloadMonitor()
        )
        self.overload.attach(
            tracer=self.tracer, slo=self.slo
        )
        r = self.registry
        self.attempts = r.counter(
            "yoda_scheduling_attempts_total",
            "Scheduling attempts by result "
            "(bound/waiting/unschedulable/nominated/error/gone)",
        )
        self.binds = r.counter("yoda_binds_total", "Pods successfully bound")
        self.preemptions = r.counter(
            "yoda_preemptions_total", "Pods evicted by the preemption plugin"
        )
        self.events_dropped = r.counter(
            "yoda_events_dropped_total",
            "Events shed from the recorder backlog under pressure "
            "(oldest first)",
        )
        self.latency = r.histogram(
            "yoda_scheduling_latency_seconds",
            "Scheduling cycle latency by phase (phase=total for the full cycle)",
        )
        self.gang_wait = r.histogram(
            "yoda_gang_wait_seconds",
            "Time gang members spend parked at Permit before bind/reject",
        )
        # Failure-domain recovery (docs/OPERATIONS.md failure modes):
        # rollbacks = transactional gang-bind rollbacks initiated (a
        # member's bind failed after the binder's transient retries and
        # the whole release cohort was unwound); fenced = binds aborted
        # before the API write because the leader gate reported this
        # process not leading.
        self.recovery_rollbacks = r.counter(
            "yoda_recovery_gang_rollbacks_total",
            "Transactional gang bind rollbacks (a member's bind failure "
            "unwound the whole release: landed binds unbound, waiting "
            "members cascaded, reservations released)",
        )
        self.fenced_binds = r.counter(
            "yoda_recovery_fenced_binds_total",
            "Binds aborted before the API write because the scheduler was "
            "fenced (leader gate reported not-leader)",
        )
        # Bind pipeline (docs/OPERATIONS.md bind-pipeline section): wall
        # time of one bind plugin call — retries and backoff included — and
        # serve-loop turns whose snapshot/dispatch started while an earlier
        # release's binds were still in flight (the overlap the pipeline
        # exists to create; 0 with the pipeline off). The companion
        # yoda_bind_inflight gauge reads the executor and is registered in
        # standalone.build_stack.
        self.bind_wall = r.histogram(
            "yoda_bind_wall_ms",
            "Wall milliseconds of one bind call, transient retries and "
            "backoff sleeps included (pipelined binds accrue this on the "
            "executor workers, not the scheduling thread)",
            buckets=(0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                     1000.0, 5000.0),
        )
        # Speculative placement cache (framework/speculation.py,
        # docs/OPERATIONS.md "Sub-millisecond serve" runbook): wall time
        # of one cache-hit bind, end to end (lookup -> epoch validity ->
        # single-node revalidation -> Reserve). The companion
        # yoda_spec_cache_{hits,misses,invalidations}_total counters read
        # the per-stack caches and are registered in
        # standalone.build_stack (accumulator pattern).
        self.spec_bind = r.histogram(
            "yoda_spec_bind_ms",
            "Wall milliseconds of one speculative cache-hit bind (lookup, "
            "epoch validity, single-node revalidation, Reserve) — the "
            "sub-millisecond serve fast path; the full filter/score path "
            "reports under yoda_scheduling_latency_seconds instead",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0),
        )
        self.overlap_cycles = r.counter(
            "yoda_overlap_cycles_total",
            "Scheduling turns whose snapshot refresh and kernel dispatch "
            "overlapped in-flight binds from a previous release (the bind "
            "pipeline working; 0 = fully serial commitment)",
        )
        # Crash-safe failover (docs/OPERATIONS.md failover runbook): the
        # warm-start resync pass a promoted scheduler runs BEFORE admitting
        # any pod, and the periodic drift reconciler that repairs what the
        # watch stream dropped while running.
        self.resync_adopted = r.counter(
            "yoda_resync_adopted_gangs",
            "Partially-bound gangs the warm-start resync ADOPTED (bound "
            "members kept, siblings' claims charged, remaining members "
            "re-queued to complete the gang in place)",
        )
        self.resync_rolled_back = r.counter(
            "yoda_resync_rolled_back_gangs",
            "Partially-bound gangs the warm-start resync (or the adopt-"
            "window deadline) ROLLED BACK whole via the unbind path",
        )
        self.resync_rebuilt = r.counter(
            "yoda_resync_rebuilt_reservations",
            "Reservations the warm-start resync charged from cluster truth "
            "that local accounting was missing (bound pods the watch "
            "replay had not yet delivered)",
        )
        self.resync_duration_ms = r.gauge(
            "yoda_resync_duration_ms",
            "Wall milliseconds of the most recent warm-start resync pass "
            "(the window between promotion and the first admitted pod)",
        )
        self.reconciler_leaked = r.counter(
            "yoda_reconciler_leaked_reservations_total",
            "Reservations released by the drift reconciler because no "
            "live pod stands behind them (deletion events the watch "
            "stream dropped)",
        )
        self.reconciler_ghosts = r.counter(
            "yoda_reconciler_ghost_pods_total",
            "Pod records repaired by the drift reconciler: bindings the "
            "watch stream dropped (cluster truth bound, cache not) and "
            "cache entries for pods the cluster no longer has",
        )
        self.reconciler_stranded = r.counter(
            "yoda_reconciler_stranded_waits_total",
            "Permit waits cancelled by the drift reconciler because the "
            "waiting pod was deleted (instead of eating the full permit "
            "timeout)",
        )
        # Federated multi-cluster scheduling (docs/OPERATIONS.md
        # multi-cluster runbook): per-cluster health, health transitions,
        # and gangs migrated off the home cluster by spillover routing.
        self.cluster_state = r.gauge(
            "yoda_cluster_state",
            "Federated cluster-front health per cluster (0=up 1=degraded "
            "2=partitioned 3=lost); a non-up cluster takes no new "
            "spillover, and partitioned/lost clusters are fenced from "
            "binding entirely",
        )
        self.cluster_transitions = r.counter(
            "yoda_cluster_transitions_total",
            "Health-state transitions per cluster front (flapping here "
            "means the degraded/partitioned thresholds sit too close to "
            "the cluster's real probe/watch latency)",
        )
        self.spillover_gangs = r.counter(
            "yoda_spillover_gangs_total",
            "Gangs the federation migrated whole to a secondary cluster "
            "because the home cluster could not fit them (all-or-nothing: "
            "a gang is never split across clusters)",
        )
        # Goodput-driven rebalancer (docs/OPERATIONS.md rebalancer
        # runbook): background defragmentation moves, priority
        # preemptions (victims unbound + requeued, never deleted),
        # elastic resizes, and the fleet fragmentation score the pass
        # optimizes (rebalance/score.py; 0 = free capacity perfectly
        # consolidated).
        self.rebalance_moves = r.counter(
            "yoda_rebalance_moves_total",
            "Bound gangs the rebalancer migrated onto a tighter ICI block "
            "(take -> unbind -> install plan -> re-admit, all-or-nothing)",
        )
        self.rebalance_preemptions = r.counter(
            "yoda_rebalance_preemptions_total",
            "Pods the rebalancer unbound and requeued to admit a parked "
            "higher-priority gang whole (victims requeue, never deleted)",
        )
        self.rebalance_resizes = r.counter(
            "yoda_rebalance_resizes_total",
            "Elastic gang effective-size changes (grown into free "
            "capacity toward tpu/max-members, or shrunk under contention "
            "toward tpu/min-members — never below it)",
        )
        self.rebalance_aborted = r.counter(
            "yoda_rebalance_aborted_moves_total",
            "Repack moves abandoned mid-flight (fence flipped, or a "
            "member's unbind refused); the gang replans through normal "
            "admission — never split, never oversubscribed",
        )
        self.fragmentation = r.gauge(
            "yoda_fragmentation_score",
            "Fleet fragmentation in [0,1] (free-block islands in ICI "
            "slices + stranded free chips; 0 = perfectly consolidated). "
            "Monotonic growth with the rebalancer enabled means moves "
            "are being starved or min_gain sits too high",
        )
        self.preempted_weight = r.counter(
            "yoda_preempted_priority_weight_total",
            "Priority-weighted work evicted by rebalancer preemptions "
            "(sum over victims of (max(priority,0)+1) x chips) — the cost "
            "side of preemptive admission",
        )
        # Node failure domains (yoda_tpu_torch/nodehealth, docs/OPERATIONS.md
        # node-failure runbook): the per-node health ladder, gang-whole
        # repair actions, repair latency, and ghost reservations
        # released at node-deletion event time.
        self.node_state = r.gauge(
            "yoda_node_state",
            "Per-node health ladder state (0=healthy 1=degraded "
            "2=suspect 3=draining 4=down); suspect/draining/down nodes "
            "are fenced from new placements, down nodes trigger "
            "gang-whole repair",
        )
        self.node_transitions = r.counter(
            "yoda_node_transitions_total",
            "Node health-state transitions (flapping here means "
            "node_suspect_after_s sits too close to the agents' real "
            "publish cadence)",
        )
        self.gang_repairs = r.counter(
            "yoda_gang_repairs_total",
            "Gangs repaired whole after a node failure, by mode: patch "
            "(lost members re-planned into the same ICI block, healthy "
            "members kept bound), shrink (elastic gang reduced toward "
            "tpu/min-members), requeue (whole gang unbound and "
            "re-queued), drain (migrated off a draining node)",
        )
        self.repair_duration = r.histogram(
            "yoda_repair_duration_ms",
            "Wall milliseconds of one gang repair (take -> unbind lost "
            "-> install plan -> readd); the time-to-repair the node "
            "failure bench bounds",
            buckets=(0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                     1000.0, 5000.0),
        )
        self.node_ghost_releases = r.counter(
            "yoda_node_ghost_releases_total",
            "Reservations released at EVENT TIME because their pod was "
            "bound to a node whose TPU CR / Node object was deleted "
            "(used to stay charged against the ghost row until the "
            "periodic reconcile)",
        )
        # Batched watch-event ingestion + tenant fair queuing (
        # docs/OPERATIONS.md multi-tenancy runbook): raw events through
        # the ingest pipeline, coalesced events applied per batch (size 1
        # everywhere with batching off), and queue entries parked by
        # per-tenant quota admission. The companion per-tenant
        # yoda_tenant_dominant_share gauge reads the TenantLedger and is
        # registered in standalone.build_stack (accumulator pattern).
        self.ingest_events = r.counter(
            "yoda_ingest_events_total",
            "Watch events entering the batched ingest pipeline, counted "
            "before coalescing (the batch-size histogram counts after)",
        )
        self.ingest_batch = r.histogram(
            "yoda_ingest_batch_size",
            "Coalesced events applied per ingest batch under one informer "
            "lock acquisition (sitting at 1 = batching off or an idle "
            "stream; the amortization win is the mean of this series)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048),
        )
        # Scheduler shard-out (docs/OPERATIONS.md sharding
        # runbook): landed binds rolled back because a gang's optimistic
        # shard commit lost its validation (another shard's earlier-staged
        # claim owned the chips) — every one lands through the
        # transactional unbind path and the gang requeues whole. The
        # companion commit/conflict totals read the shared accountant and
        # are registered in standalone.build_stack (accumulator pattern);
        # the per-shard queue/cycle/bind gauges live there too.
        self.shard_rollbacks = r.counter(
            "yoda_shard_commit_rollbacks_total",
            "Landed gang-member binds rolled back through the "
            "transactional unbind path after a shard commit conflict "
            "(the losing shard requeues the gang whole)",
        )
        # Multi-process shard serve (docs/OPERATIONS.md
        # multi-process runbook): the commit RPC surface worker
        # PROCESSES reach the journal-owning accountant through
        # (framework/procserve.py). All three stay empty/zero under
        # shard_mode=thread — in-process lanes call the accountant
        # directly.
        self.commit_rpc_calls = r.counter(
            "yoda_commit_rpc_calls_total",
            "Commit RPC requests handled by the parent control plane, "
            "by op (stage/commit/release/residue/heartbeat) and worker "
            "lane — the per-lane commit-path traffic of "
            "shard_mode=process",
        )
        self.commit_rpc_conflicts = r.counter(
            "yoda_commit_rpc_conflicts_total",
            "Commit RPCs refused by first-staged-wins validation at the "
            "parent accountant, by worker lane (the process-mode view "
            "of yoda_shard_commit_conflicts_total)",
        )
        self.commit_rpc_latency = r.histogram(
            "yoda_commit_rpc_latency_ms",
            "Server-side wall milliseconds per commit RPC (decode -> "
            "accountant -> journal fsync for commits -> reply); the "
            "process-mode commit-point overhead a worker pays per "
            "decision",
            buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100),
        )
        # Multi-host control plane (docs/OPERATIONS.md
        # multi-host runbook): the commit RPC series above additionally
        # carry a `transport` label (unix | tcp); the two gauges below
        # are the failover observables — a term that jumps is a standby
        # promotion, a climbing standby lag means journal shipping is
        # slower than the commit rate and promotion will pay a catch-up.
        self.commit_term = r.gauge(
            "yoda_commit_term",
            "The parent control plane's current epoch term: bumped by "
            "standby promotion (journal T record); workers refuse any "
            "parent stamping an OLDER term, and a deposed parent refuses "
            "state-mutating requests carrying a NEWER one",
        )
        self.standby_lag_frames = r.gauge(
            "yoda_standby_lag_frames",
            "Journal frames the tailing hot standby is behind the live "
            "parent's tail (0 = caught up; sustained growth means "
            "shipping lags the commit rate and promotion pays a catch-up)",
        )
        self.tenant_quota_parks = r.counter(
            "yoda_tenant_quota_parks_total",
            "Queue entries parked by per-tenant quota admission (they "
            "re-enter and re-check when capacity frees); a climbing rate "
            "with flat binds means a tenant is submitting far past its "
            "quota",
        )
        # Fleet SLO engine series (docs/OPERATIONS.md "SLO monitoring"
        # runbook): all lazy reads of the shared engine's cached
        # evaluation — one scrape triggers at most one window walk, and
        # the serve path never evaluates anything. Label series come and
        # go with the engine's live tenant set (bounded cardinality).
        slo_engine = self.slo
        self.slo_admission_p99 = r.gauge(
            "yoda_slo_admission_wait_p99_seconds",
            "Per-tenant p99 of the enqueue->bound admission wait over the "
            "slow SLO window (the SLI judged against "
            "slo_targets.admission_wait_p99_s)",
            slo_engine.prom_admission_p99,
        )
        self.slo_starved = r.gauge(
            "yoda_slo_starved_windows",
            "Cumulative starved windows per tenant (queued work and ZERO "
            "admissions across a whole slo_starvation_window_s); any "
            "nonzero value on a healthy fleet is an SLO violation",
            slo_engine.prom_starved_windows,
        )
        self.slo_burn = r.gauge(
            "yoda_slo_burn_rate",
            "Fleet admission-SLI error-budget burn rate per window "
            "(window=fast|slow); an alert needs BOTH windows past "
            "slo_burn_threshold",
            slo_engine.prom_burn,
        )
        self.slo_preemption_rate = r.gauge(
            "yoda_slo_preemption_rate_per_min",
            "Fleet preemptions per minute over the fast SLO window "
            "(PostFilter evictions + rebalancer priority preemptions)",
            slo_engine.prom_preemption_rate,
        )
        self.slo_repair_rate = r.gauge(
            "yoda_slo_repair_rate_per_min",
            "Gang-whole repairs per minute over the fast SLO window "
            "(nodehealth patch/shrink/requeue + drain migrations)",
            slo_engine.prom_repair_rate,
        )
        self.slo_goodput = r.gauge(
            "yoda_slo_goodput",
            "Chip-utilization goodput sampled at the last SLO evaluation "
            "(bin-packing efficiency; judged against "
            "slo_targets.goodput_min while the fleet sees traffic)",
            slo_engine.prom_goodput,
        )
        self.slo_alerts = r.gauge(
            "yoda_slo_alerts_firing",
            "SLO alerts currently firing (multi-window burn, starvation, "
            "preemption/repair rate, goodput) — the pager-side summary of "
            "/debug/slo",
            slo_engine.prom_alerts_firing,
        )
        self.slo_evaluations = r.counter(
            "yoda_slo_evaluations_total",
            "SLO engine evaluations (scrape / /debug/slo / CLI / bench "
            "demand; the serve path never evaluates)",
            collect_fn=lambda: slo_engine.evaluations,
        )
        self._trace_lock = threading.Lock()
        self._trace: deque[TraceEntry] = deque(maxlen=trace_capacity)
        # Ring-overflow accounting for BOTH bounded trace surfaces: the
        # one-line TraceEntry ring below and the span tracer's ring. A
        # high rate means the rings are undersized for the traffic
        # (config trace_capacity) — entries are being evicted before an
        # operator could read them.
        self._trace_drops = 0
        self.trace_dropped = r.counter(
            "yoda_trace_dropped_total",
            "Trace entries evicted by ring overflow (one-line trace ring "
            "+ lifecycle span ring) before being read — raise "
            "trace_capacity if this climbs during incidents",
            collect_fn=lambda: self._trace_drops + self.tracer.dropped,
        )
        # Overload brownout ladder (docs/OPERATIONS.md
        # "Overload brownout + hot-reload" runbook): all lazy reads of
        # the shared monitor / pending index.
        ov = self.overload
        ov.attach(latency=self.latency)
        self.overload_level = r.gauge(
            "yoda_overload_level",
            "Brownout-ladder position (0=nominal 1=elevated 2=brownout "
            "3=shed): at 1+ the repair passes pause and trace sampling "
            "drops to 0, at 2+ per-tenant admission is capped, at 3 new "
            "non-prod arrivals park with overload-shed verdicts",
            collect_fn=lambda: float(ov.level_idx),
        )
        self.overload_transitions = r.counter(
            "yoda_overload_transitions_total",
            "Brownout-ladder level changes (rapid climbing means the "
            "overload_* high-water marks sit below steady-state load; "
            "step-down flapping should be impossible by debounce)",
            collect_fn=lambda: float(ov.transitions),
        )
        self.overload_shed = r.counter(
            "yoda_overload_shed_total",
            "Non-prod scheduling draws parked by SHED (they requeue "
            "when the ladder steps down — shed is deferral, never loss)",
            collect_fn=lambda: float(ov.shed_total),
        )
        self.pending_evicted = r.counter(
            "yoda_pending_evicted_total",
            "Why-pending entries LRU-evicted at the pending_index_max "
            "bound (a shed flood recycles oldest keys; `explain` then "
            "answers 'aged out' for them)",
            collect_fn=lambda: float(self.pending.evicted),
        )

    # --- fleet gauges (lazy, fed by the informer at scrape time) ---

    def attach_fleet(self, snapshot_fn, reserved_fn=None) -> None:
        def chips_total() -> float:
            return float(
                sum(len(ni.tpu.healthy_chips()) for ni in snapshot_fn().infos() if ni.tpu)
            )

        def chips_free() -> float:
            # A chip occupied by a running pod is charged either via its
            # metrics-visible HBM use OR via an accountant reservation,
            # never both — the same handoff model the filter uses
            # (filter_plugin.invisible_reservations); subtracting full
            # reservations here would double-count after agent refreshes.
            from yoda_tpu_torch.plugins.yoda.filter_plugin import invisible_reservations

            free = 0
            for ni in snapshot_fn().infos():
                if ni.tpu is None:
                    continue
                reserved = reserved_fn(ni.name) if reserved_fn else 0
                unused = sum(
                    1
                    for c in ni.tpu.healthy_chips()
                    if c.hbm_free >= c.hbm_total
                )
                free += max(unused - invisible_reservations(ni.tpu, reserved), 0)
            return float(free)

        self.registry.gauge(
            "yoda_tpu_chips_total", "Healthy TPU chips in the fleet", chips_total
        )
        self.registry.gauge(
            "yoda_tpu_chips_free",
            "Healthy TPU chips not occupied or reserved "
            "(bin-packing efficiency = 1 - free/total under saturation)",
            chips_free,
        )
        # THE BASELINE north-star companion to p99 latency (BASELINE.md):
        # fraction of allocatable chips actually in use.
        def binpack_efficiency() -> float:
            total = chips_total()
            return (total - chips_free()) / total if total > 0 else 0.0

        self.binpack_efficiency = self.registry.gauge(
            "yoda_tpu_binpack_efficiency",
            "Chips in use / chips allocatable (0 when the fleet is empty)",
            binpack_efficiency,
        )

        def duty_cycle_avg() -> float:
            # Tensorcore utilization across chips that report it (agents
            # running --libtpu-metrics). Observational: pairs with
            # binpack_efficiency to separate "chips handed out" from
            # "chips actually computing". 0 when no chip reports.
            total = n = 0.0
            for ni in snapshot_fn().infos():
                if ni.tpu is None:
                    continue
                for c in ni.tpu.chips:
                    if c.duty_cycle_pct is not None:
                        total += c.duty_cycle_pct
                        n += 1
            return total / n if n else 0.0

        self.registry.gauge(
            "yoda_tpu_duty_cycle_avg_pct",
            "Mean tensorcore duty cycle over chips reporting it "
            "(libtpu metrics service; 0 = no reporting chips)",
            duty_cycle_avg,
        )

    # --- trace ---

    def trace(self, entry: TraceEntry) -> None:
        entry.wall_unix = entry.wall_unix or time.time()
        with self._trace_lock:
            if len(self._trace) == self._trace.maxlen:
                self._trace_drops += 1
            self._trace.append(entry)

    def recent_traces(self, n: int = 50) -> list[TraceEntry]:
        with self._trace_lock:
            return list(self._trace)[-n:]


class PhaseTimer:
    """Accumulates per-phase wall time for one scheduling cycle."""

    def __init__(self, clock: Callable[[], float]) -> None:
        self.clock = clock
        self.phases_ms: dict[str, float] = {}

    class _Span:
        def __init__(self, timer: "PhaseTimer", name: str) -> None:
            self.timer = timer
            self.name = name

        def __enter__(self):
            self.t0 = self.timer.clock()
            return self

        def __exit__(self, *exc):
            dt = (self.timer.clock() - self.t0) * 1e3
            self.timer.phases_ms[self.name] = (
                self.timer.phases_ms.get(self.name, 0.0) + dt
            )
            return False

    def span(self, name: str) -> "_Span":
        return self._Span(self, name)

    def observe_into(self, hist: Histogram) -> None:
        for phase, ms in self.phases_ms.items():
            hist.observe(ms / 1e3, phase=phase)
