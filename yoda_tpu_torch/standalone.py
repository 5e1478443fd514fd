"""Wire a complete in-process scheduler stack (cluster + informer + plugins
+ scheduler loop).

Counterpart of ``yoda_tpu/standalone.py``: a single-stack ``build_stack``
that wires only the parts this port has — informer snapshot and delta feeds →
``YodaPreFilter`` → ``GangPlugin`` admission → ``YodaBatch`` dispatch over
the device-resident fleet state (the
hand CUDA kernels on the card: the fleet evaluation, and the joint-fit
scan for joint gang passes) → Reserve on ``ChipAccountant`` → Permit (the
gang barrier) → bind, with the gang plugin watching pods and hosts
(delete fast path, host-death marks, restart reconstruction), and
PostFilter preemption (``TpuPreemption``, on by default: evictions through
``FakeCluster.evict_pod``, nominations written to pod status, victim
preference by the informer's PodDisruptionBudgets). The informer watches
Namespaces, PersistentVolumeClaims, PersistentVolumes and budgets as the
cluster offers them, and their events reactivate parked pods. Every knob
that picks how a pod is evaluated is honoured: ``mesh_devices`` row-shards
the evaluation over a device mesh (``parallel/sharded.py``), and ``mode:
loop`` builds the reference's per-node plugins instead of ``YodaBatch``
(``Stack.batch`` is None; the per-node filter chain runs on the host over a
search window ``percentage_nodes_to_score`` caps).

The background parts are built, as in the reference, but not started: the
warm-start and drift ``Reconciler``, the ``Rebalancer`` (gated on the
leader fence and the reconciler's resync; its drain pass reads the node
health monitor's draining nodes), the ``SpeculativeCache``, whose private
mirror evaluates on the batch plugin's device (on the card, on a stream of
its own) and whose plans the scheduler's serve path consumes, and the
``NodeHealthMonitor`` (the health ladder, fed at event time through
``on_change_batch``; its fence set stamped on every snapshot through the
informer's ``fence_fn``, so the admission rows the card's kernels read
veto fenced hosts; gang-whole repair and drains). With ``bind_workers`` >
0 a ``BindExecutor`` carries the monitor's and the rebalancer's unbind
fan-out and, when the bind pipeline is on, a gang release's member binds
(``bind_pipeline`` "on", or "auto" with a cluster whose binds are real
I/O: ``remote_binds`` or ``bind_latency_s`` > 0); ``stop_event`` (the
CLI's serve stop) is the executor's stop event, so shutdown aborts
pending bind retry sleeps. The binder and preemption re-check the
scheduler's live leader fence before every API write. A caller drives ``reconciler.resync()`` / ``reconcile()``,
``rebalancer.run_once()`` or ``rebalancer.run_forever(stop)`` (which ticks
the cache), ``speculation.speculate_once()`` and ``nodehealth.run_once()``
/ ``run_forever(stop)`` / ``drain(name)``.

Observability is built as the reference builds it (``Stack.metrics``, a
``SchedulingMetrics`` from ``_metrics_from_config``): the lifecycle tracer
and the why-pending index (wired into the framework, the gang plugin and
the batch plugin), the ``SloEngine`` (fed by the enqueue hook, both bind
sites, evictions, the rebalancer's preemptions and every repair; a pending
pod's deletion retires its record) and the ``OverloadMonitor`` (the
queue's shed and quota hooks, with their why-pending records; its
``repairs_paused()`` gates the rebalancer and the node health monitor).
Every family the reference registers renders, the ones of parts this port
lacks at 0. ``build_stack`` starts no thread: a caller runs the ladder's
``overload.run_forever(stop)`` and serves ``metrics_server.MetricsServer``.
``apply_reloadable`` re-applies the reloadable knobs to a running stack
(the target of ``overload.ConfigReloader``).

Scheduling Events are recorded as the reference records them
(``Stack.events``, an ``EventRecorder`` over the cluster's
``write_event``): ``Scheduled`` and ``FailedScheduling`` from the
scheduler, ``Preempted`` from preemption's victims, ``GangRollback`` from
the gang plugin. With ``tenant_fairness`` the watch-driven
``TenantLedger`` (``Stack.tenants``) orders the queue's pops by dominant
share and, with a quota, parks over-quota tenants' entries; with
``ingest_batch_window_ms`` > 0 one ``EventBatcher`` (``Stack.ingestor``,
its drain thread started) coalesces the watch stream and applies each
batch through the same handler chain, the informer taking it under one
lock with one epoch bump, so the device-resident fleet state applies each
batch's changed rows once. ``Stack.close`` stops the batcher's drain
thread, the recorder's worker and the gang plugin's bind executor.

Durability and the shard-out, as the reference wires them:
``journal_path`` opens the durable claim journal (``journal/``) before any
watcher registers, restores the accountant from its replay and attaches
it, so every claim mutation is recorded write-ahead (``Stack.journal``,
the ``yoda_journal_*`` counters, ``yoda_commit_term`` from a replayed
term; ``apply_reloadable`` re-applies ``journal_sync`` and
``journal_segment_bytes``). ``build_sharded_stacks`` builds a
``ShardSet``: one global lane over the whole fleet and ``shard_count``
lanes over rendezvous partitions (``framework/shards.py``), sharing one
accountant (the optimistic commit point) and one metrics registry, each
with its own queue, cycle lock, bind executor, resident fleet state and
``TorchFleetKernel`` — on the card on a CUDA stream of its own, so lanes on
their own threads launch ``fleet_eval`` and ``joint_fit`` side by side.
``build_proc_parent`` builds the parent of process-mode lanes
(``shard_mode: process``): the same head with only the global lane in
this process, the shard lanes running in worker processes
(``framework/procserve.py``, each evaluating its partition on the card in
a CUDA context of its own) that reach the accountant through the commit
RPC; ``commit_listen`` and ``commit_endpoint`` are read by the CLI, which
wires the RPC server and the tailing standby.
``build_profile_stacks`` builds one stack per scheduler profile over one
accountant, one cycle lock and one metrics registry. ``build_federation``
builds a ``federation.Federation``: one whole stack per cluster front over
one shared metrics registry (each on the card unless ``kernel_platform:
cpu``), each front watched by a ``ClusterHealthMonitor`` fed by the
front's ``probe`` and its informer's ``last_event_age_s``, with the
``federation_*`` knobs as the reference reads them.

A knob of a part this port does not have yet loads
(``config.SchedulerConfig`` keeps every knob of the reference), but
``build_stack`` raises ``NotImplementedError`` naming it and the ROADMAP
item it waits for when it is set away from its default — except to the
value that turns the part off, which is what this port already does
(``UNPORTED_KNOB_VALUES``). The one such knob left is
``kernel_device_min_elems``, the reference's host-or-device cut-off under
``kernel_platform: auto`` (B7 in ROADMAP queue 2), which the port's "auto"
(the card, or raise) does not read.
Where the default turns such a part ON (the reference builds it),
``build_stack`` logs one warning naming every such part and lists them in
``Stack.not_built``; with every part of the default configuration ported,
that list is empty.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from dataclasses import dataclass

import torch

from yoda_tpu_torch.api.requests import LabelParseError, gang_name_of, pod_request
from yoda_tpu_torch.cluster.events import EventRecorder
from yoda_tpu_torch.cluster.fake import Event, FakeCluster
from yoda_tpu_torch.cluster.informer import InformerCache
from yoda_tpu_torch.cluster.ingest import EventBatcher
from yoda_tpu_torch.cluster.retry import BackoffPolicy
from yoda_tpu_torch.config import SchedulerConfig
from yoda_tpu_torch.framework.queue import QueuedPodInfo, SchedulingQueue
from yoda_tpu_torch.framework.reconciler import Reconciler
from yoda_tpu_torch.framework.runtime import BindExecutor, Framework
from yoda_tpu_torch.framework.scheduler import Scheduler
from yoda_tpu_torch.framework.shards import (
    GLOBAL_LANE,
    ShardMap,
    ShardRouter,
    shard_name,
)
from yoda_tpu_torch.framework.speculation import SpeculativeCache
from yoda_tpu_torch.framework.tenancy import TenantLedger, tenant_of
from yoda_tpu_torch.journal import FileJournal
from yoda_tpu_torch.nodehealth import NodeHealthMonitor
from yoda_tpu_torch.observability import SchedulingMetrics
from yoda_tpu_torch.ops.kernel import TorchFleetKernel
from yoda_tpu_torch.overload import OverloadMonitor
from yoda_tpu_torch.plugins.yoda import (
    GangPlugin,
    TpuPreemption,
    YodaBatch,
    default_plugins,
)
from yoda_tpu_torch.plugins.yoda.accounting import ChipAccountant
from yoda_tpu_torch.plugins.yoda.binder import ClusterBinder
from yoda_tpu_torch.plugins.yoda.filter_plugin import YodaPreFilter
from yoda_tpu_torch.rebalance import Rebalancer
from yoda_tpu_torch.slo import SloEngine
from yoda_tpu_torch.tracing import PendingIndex, Tracer, subject_of

log = logging.getLogger("yoda_tpu_torch.standalone")

# Knobs this port honours, at any valid value.
PORTED_KNOBS = frozenset(
    {
        "scheduler_name",
        "mode",
        "percentage_nodes_to_score",
        "mesh_devices",
        "weights",
        "scoring_strategy",
        "max_metrics_age_s",
        "kernel_platform",
        "kernel_backend",
        "batch_requests",
        "bind_retry_attempts",
        "bind_retry_base_s",
        "bind_retry_cap_s",
        "immediate_retry_attempts",
        "gang_permit_timeout_s",
        "enable_preemption",
        "spec_enabled",
        "spec_cache_size",
        "spec_shapes_max",
        "reconcile_period_s",
        "rebalance_period_s",
        "rebalance_min_gain",
        "rebalance_max_moves",
        "rebalance_max_victims",
        "rebalance_preemption",
        "rebalance_elastic",
        "failover_adopt_window_s",
        "bind_workers",
        "bind_pipeline",
        "node_suspect_after_s",
        "node_down_after_s",
        "node_repair",
        "node_drain_deadline_s",
        "node_health_period_s",
        "trace_sample_rate",
        "trace_capacity",
        "trace_sink",
        "trace_sink_max_bytes",
        "pending_index_max",
        "slo_enabled",
        "slo_targets",
        "slo_starvation_window_s",
        "slo_burn_fast_window_s",
        "slo_burn_slow_window_s",
        "slo_burn_threshold",
        "overload_period_s",
        "overload_queue_high",
        "overload_ingest_high",
        "overload_cycle_ms_high",
        "overload_step_down_hold_s",
        "overload_brownout_admit_per_s",
        "overload_shed_priority",
        "tenant_fairness",
        "tenant_quota_chips",
        "tenant_quota_hbm_gib",
        "ingest_batch_window_ms",
        "ingest_batch_max",
        "journal_path",
        "journal_sync",
        "journal_segment_bytes",
        "shard_count",
        "shard_mode",
        "commit_listen",
        "commit_endpoint",
        "profiles",
        "federation_degraded_after_s",
        "federation_partitioned_after_s",
        "federation_lost_after_s",
        "federation_probe_period_s",
        "federation_spillover",
    }
)

# The ROADMAP item each knob of a part this port does not have yet waits
# for; ``build_stack`` names it when such a knob is set. Every queue-1 item
# with a knob is ported (``kernel_device_min_elems`` waits for a
# measurement, not a module, and is named without one).
LATER_ITEMS: "dict[str, str]" = {}

# Every other knob belongs to a part this port does not have yet; it must
# keep its default or take one of these values, each of which switches
# that part off (the port's behaviour either way). Each is listed with the
# part it turns on, for ``Stack.not_built``. Every part the default
# configuration turns on is ported, so none is listed.
UNPORTED_KNOB_VALUES: "dict[str, tuple[str, tuple]]" = {}


def unported_settings(config: SchedulerConfig) -> list[str]:
    """The knobs of ``config`` that ask for a part this port lacks."""
    default = SchedulerConfig()
    out = []
    for f in dataclasses.fields(config):
        if f.name in PORTED_KNOBS:
            continue
        value = getattr(config, f.name)
        if value == getattr(default, f.name):
            continue
        if value in UNPORTED_KNOB_VALUES.get(f.name, ("", ()))[1]:
            continue
        item = LATER_ITEMS.get(f.name)
        out.append(
            f"{f.name}={value!r}" + (f" (ROADMAP item {item})" if item else "")
        )
    return out


def _metrics_from_config(
    config: SchedulerConfig, clock=time.monotonic
) -> SchedulingMetrics:
    """One SchedulingMetrics with the config-derived tracer, fleet SLO
    engine, overload monitor and why-pending index."""
    return SchedulingMetrics(
        tracer=Tracer(
            sample_rate=config.trace_sample_rate,
            capacity=config.trace_capacity,
            sink=config.trace_sink or None,
            sink_max_bytes=config.trace_sink_max_bytes,
        ),
        pending=PendingIndex(capacity=config.pending_index_max),
        slo=SloEngine(
            targets=config.slo_targets,
            enabled=config.slo_enabled,
            starvation_window_s=config.slo_starvation_window_s,
            fast_window_s=config.slo_burn_fast_window_s,
            slow_window_s=config.slo_burn_slow_window_s,
            burn_threshold=config.slo_burn_threshold,
            clock=clock,
        ),
        overload=OverloadMonitor(
            queue_high=config.overload_queue_high,
            ingest_high=config.overload_ingest_high,
            cycle_ms_high=config.overload_cycle_ms_high,
            step_down_hold_s=config.overload_step_down_hold_s,
            brownout_admit_per_s=config.overload_brownout_admit_per_s,
            shed_priority_floor=config.overload_shed_priority,
            period_s=config.overload_period_s,
            clock=clock,
        ),
    )


def _attach_journal(accountant: ChipAccountant, config: SchedulerConfig):
    """Durable claim journal: when ``journal_path`` is set, open
    (replaying + tail-repairing) the on-disk CommitLog, seed the
    accountant from the replayed state, and attach the journal so every
    later claim mutation is write-ahead recorded. MUST run before any
    watcher registers — the list-then-watch replay then layers
    idempotently over the restored claims. Returns the journal (or None,
    journal off — the accountant keeps its in-memory-only behavior, zero
    new hot-path work)."""
    if not config.journal_path:
        return None
    journal = FileJournal(
        config.journal_path,
        sync=config.journal_sync,
        segment_bytes=config.journal_segment_bytes,
    )
    state = journal.open()
    accountant.restore(state)
    accountant.journal = journal
    return journal


def not_built_parts(config: SchedulerConfig) -> tuple[str, ...]:
    """The parts ``config`` turns on (the reference would build them) that
    this port does not build, each named with its knob."""
    return tuple(
        f"{part} ({knob}={getattr(config, knob)!r})"
        for knob, (part, off) in UNPORTED_KNOB_VALUES.items()
        if getattr(config, knob) not in off
    )


@dataclass
class Stack:
    cluster: FakeCluster
    informer: InformerCache
    accountant: ChipAccountant
    framework: Framework
    queue: SchedulingQueue
    scheduler: Scheduler
    binder: ClusterBinder
    # The fused evaluation's plugin; None in loop mode (mode: loop), whose
    # per-node plugins evaluate on the host.
    batch: YodaBatch | None
    gang: GangPlugin
    # None when config.enable_preemption is off.
    preemption: TpuPreemption | None = None
    # Built always, started by nobody: the caller drives them.
    reconciler: Reconciler | None = None
    rebalancer: Rebalancer | None = None
    # Produced by the rebalancer's tick (or speculate_once), consumed by
    # the serve path; spec_enabled=False builds it disabled.
    speculation: SpeculativeCache | None = None
    # Built always, started by nobody: the caller drives run_once /
    # run_forever; node_repair=False keeps the ladder and fence, no repair.
    nodehealth: NodeHealthMonitor | None = None
    # None when config.bind_workers is 0: binds and unbinds then run
    # inline. The gang plugin's release fans out on it when the bind
    # pipeline is on (gang.parallel_release).
    bind_executor: BindExecutor | None = None
    # The registry, tracer, why-pending index, SLO engine and overload
    # ladder (metrics.tracer / .pending / .slo / .overload).
    metrics: SchedulingMetrics | None = None
    # Parts the config turns on that this port does not build
    # (not_built_parts); build_stack logs them once.
    not_built: tuple[str, ...] = ()
    # Scheduling Events (None when the cluster has no write_event).
    events: EventRecorder | None = None
    # Batched watch ingest: the coalescing batcher between the cluster's
    # watch delivery and the handler chain. None with
    # ingest_batch_window_ms = 0 (per-event delivery, the default).
    ingestor: EventBatcher | None = None
    # Per-tenant DRF ledger (tenant_fairness); None with fairness off.
    tenants: TenantLedger | None = None
    # The watcher fns build_stack registered on the cluster for THIS
    # stack — what ShardSet.resize unregisters when it retires a
    # dissolved shard lane (cluster.remove_watcher by fn identity).
    watch_fns: tuple = ()
    # Durable claim journal: the accountant's on-disk CommitLog, None with
    # journal_path unset. Shared-accountant assemblies (profiles, shards)
    # share one journal through the one accountant.
    journal: object = None

    def close(self) -> None:
        """Stop the stack's threads: the gang plugin's bind executor (its
        stop event set, so pending bind retry sleeps abort; in-flight
        binds are not waited for), the batcher's drain thread (its residue
        applied first) and the Event recorder's worker (its backlog
        written first)."""
        self.gang.close()
        if self.ingestor is not None:
            if self.metrics is not None:
                self.metrics.overload.remove_ingestor(self.ingestor)
            self.ingestor.stop()
        if self.events is not None:
            self.events.close()


def build_stack(
    cluster: FakeCluster | None = None,
    config: SchedulerConfig | None = None,
    *,
    clock=time.monotonic,
    extra_plugins: "list | None" = None,
    stop_event: "threading.Event | None" = None,
    accountant: ChipAccountant | None = None,
    cycle_lock=None,
    post_filter_lock=None,
    metrics: SchedulingMetrics | None = None,
    scheduler_names: "tuple[str, ...] | None" = None,
    shard: "str | None" = None,
    node_filter_fn=None,
    pod_route_fn=None,
) -> Stack:
    """Build a fully-wired scheduler stack against ``cluster`` (a fresh
    FakeCluster by default). Watchers are registered list-then-watch, so a
    stack built against a populated cluster reconstructs accounting and
    gang membership from existing bound pods. The fleet evaluation runs on
    the CUDA device unless ``config.kernel_platform`` is "cpu"; with no
    card present the default raises. ``extra_plugins`` join the set ahead
    of the binder (a bind plugin there answers first). ``stop_event`` (the
    CLI passes its serve stop) becomes the bind executor's stop event.

    A provided ``accountant``, ``cycle_lock`` / ``post_filter_lock`` and
    ``metrics`` are SHARED with other stacks (profiles, scheduler lanes):
    the caller registered the accountant's watcher and attached its
    journal. ``shard`` (with ``node_filter_fn`` / ``pod_route_fn``) builds
    the stack as ONE lane of a sharded assembly (build_sharded_stacks):
    its informer restricts snapshots to the lane's node partition and
    queues only the lane's routed pods, its scheduler tags cycles with the
    lane and commits staged claims through the shared accountant's
    optimistic claim->validate->commit, its gang plugin arms release
    cohorts for the commit flush, and on the card its kernel runs on a
    CUDA stream of its own. All default to None = the classic unsharded
    stack."""
    cluster = cluster or FakeCluster()
    config = config or SchedulerConfig()
    unported = unported_settings(config)
    if unported:
        raise NotImplementedError(
            "not yet ported to yoda_tpu_torch: " + ", ".join(unported)
        )
    not_built = not_built_parts(config)
    if not_built:
        log.warning(
            "build_stack: the config turns on parts this port does not build, "
            "so they do not run: %s",
            ", ".join(not_built),
        )
    # A provided accountant is SHARED across stacks (its watcher is
    # registered by the caller, once): reservations made by any stack are
    # visible to every other before the bind's watch event lands.
    own_accountant = accountant is None
    if own_accountant:
        accountant = ChipAccountant(scheduler_name=config.scheduler_name)
        # Durable claim journal: replay + restore BEFORE the watcher
        # registration below — warm-start state must exist before the
        # list-then-watch replay layers over it. Shared accountants had
        # theirs attached by the assembly that shares them.
        _attach_journal(accountant, config)
    journal = accountant.journal
    # A provided metrics registry is SHARED (one /metrics endpoint over
    # every profile or lane; the tracer, why-pending index, SLO engine and
    # overload ladder ride on it, so one gang's trace stays one trace).
    if metrics is None:
        metrics = _metrics_from_config(config, clock)
    # Replayed epoch term: a journal that lived through a promotion
    # replays its term, published from the first scrape on.
    if journal is not None and journal.term:
        metrics.commit_term.set(float(journal.term))
    # Scheduling Events (kubectl describe pod): the loop emits its own.
    recorder = (
        EventRecorder(cluster.write_event, on_drop=metrics.events_dropped.inc)
        if hasattr(cluster, "write_event")
        else None
    )
    # Bind pipeline: the bounded executor that fans gang releases out and
    # carries bind retry/backoff sleeps off the scheduling thread (and the
    # node health monitor's and the rebalancer's unbinds). `stop_event`
    # doubles as the binder's interruptible-sleep event, so shutdown and
    # leadership loss abort pending retries promptly. The release fans out
    # only when binds are real I/O — remote API round trips or injected
    # bind latency — unless forced by config; in-process microsecond binds
    # stay synchronous (the thread handoff would cost more than it hides).
    # Threads are made at the first submit.
    bind_executor = (
        BindExecutor(config.bind_workers, stop_event=stop_event)
        if config.bind_workers > 0
        else None
    )
    pipelined = bind_executor is not None and (
        config.bind_pipeline == "on"
        or (
            config.bind_pipeline == "auto"
            and (
                getattr(cluster, "remote_binds", False)
                or getattr(cluster, "bind_latency_s", 0.0) > 0.0
            )
        )
    )
    gang = GangPlugin(
        timeout_s=config.gang_permit_timeout_s,
        reserved_fn=accountant.chips_in_use,
        on_rollback=recorder.gang_rollback if recorder else None,
        parallel_release=pipelined,
        bind_executor=bind_executor,
    )
    if shard is not None:
        gang.shard = shard
        gang.track_commits = True
    plugins = default_plugins(
        mode=config.mode,
        weights=config.effective_weights(),
        reserved_fn=accountant.chips_in_use,
        max_metrics_age_s=config.max_metrics_age_s,
        kernel_platform=config.kernel_platform,
        mesh_devices=config.mesh_devices,
        kernel_backend=config.kernel_backend,
        batch_requests=config.batch_requests,
        # Gang members parked at Permit: their claims stay visible to
        # admission and to the burst gate.
        pending_fn=gang.pending_placements,
        # Bulk accountant read: one lock per dispatch, not N.
        reserved_map_fn=accountant.chips_by_node,
        # Reservation delta feed: the device-resident dynamics row applies
        # only the nodes whose totals moved since the last dispatch.
        reserved_delta_fn=accountant.reserved_changes_since,
    )
    plugins.append(gang)
    plugins.append(accountant)
    # Preemption's victim selection takes THE scheduler's cycle lock (one
    # lock across profiles when they share it), so it is normalized here
    # and handed to both.
    cycle_lock = cycle_lock or threading.Lock()
    preemption = None
    if config.enable_preemption:
        preemption = TpuPreemption(
            cluster.evict_pod,
            scheduler_name=config.scheduler_name,
            scheduler_names=scheduler_names,
            select_lock=cycle_lock,
            reserved_fn=accountant.chips_in_use,
            gang_status_fn=gang.gang_status,
            gang_plan_fn=gang.planned_unassigned_hosts,
            # Eviction counter + the SLO engine's preemption-rate SLI in
            # one hook (the rebalancer's priority preemptions feed the
            # same SLI from its own pass).
            on_evicted=lambda n: (
                metrics.preemptions.inc(n),
                metrics.slo.observe_preemption(n),
            ),
            on_victim=(
                (lambda v: recorder.preempted(v.pod, v.node))
                if recorder
                else None
            ),
        )
        plugins.append(preemption)
    if extra_plugins:
        plugins.extend(extra_plugins)
    binder = ClusterBinder(
        cluster,
        retry_attempts=config.bind_retry_attempts,
        retry_base_s=config.bind_retry_base_s,
        retry_cap_s=config.bind_retry_cap_s,
        # Interruptible backoff: the executor's stop event (set on
        # shutdown / leadership loss) aborts pending retry sleeps.
        stop_event=bind_executor.stop_event if bind_executor else None,
    )
    plugins.append(binder)
    framework = Framework(plugins)
    gang.attach_framework(framework)
    # Lifecycle tracing + why-pending: every hook that emits spans or
    # rejection verdicts reads the tracer / index off the metrics object —
    # bind/unbind spans land on whichever thread runs them (executor
    # workers included), gang releases/rollbacks and topology admission
    # parks annotate the gang's own trace.
    framework.tracer = metrics.tracer
    gang.tracer = metrics.tracer
    gang.pending = metrics.pending
    # Per-tenant DRF fair queuing: the watch-driven TenantLedger feeds
    # dominant-share ordering and quota admission into the queue. Off (the
    # default) the queue runs tenant-blind, bit-identical to the
    # pre-tenant behavior.
    ledger = None
    tenant_quota_fn = None
    if config.tenant_fairness:
        ledger = TenantLedger()
        if config.tenant_quota_chips or config.tenant_quota_hbm_gib:
            hbm_cap_mib = int(config.tenant_quota_hbm_gib * 1024)
            tenant_quota_fn = lambda tenant, pod: ledger.quota_verdict(  # noqa: E731
                tenant,
                pod,
                chips_cap=config.tenant_quota_chips,
                hbm_cap_mib=hbm_cap_mib,
            )

    # Overload brownout ladder (overload.py): the monitor rides the
    # queue's verdict hooks — BROWNOUT caps per-tenant admission through
    # the quota path, SHED parks non-prod draws per item. At NOMINAL both
    # hooks are one attribute compare.
    overload = metrics.overload

    def quota_fn(tenant: str, pod) -> "str | None":
        why = overload.quota_verdict(tenant)
        if why is not None:
            return why
        if tenant_quota_fn is not None:
            return tenant_quota_fn(tenant, pod)
        return None

    def on_quota_park(qpi, why: str) -> None:
        # Fired under the queue lock: counter bump + why-pending verdict
        # only, never back into the queue.
        metrics.tenant_quota_parks.inc()
        metrics.pending.record(
            qpi.pod.key,
            kind="quota-park",
            message=why,
            gang=gang_name_of(qpi.pod.labels),
            shard=shard,
        )

    def shed_fn(pod) -> "str | None":
        # Lock order: the queue lock (held by the caller), then the gang
        # plugin's own lock inside gang_status — the same order as the
        # reference; nothing under the gang lock takes the queue lock.
        why = overload.shed_verdict(pod)
        if why is None:
            return None
        g = gang_name_of(pod.labels)
        if g:
            status = gang.gang_status(g)
            if status is not None and (status[1] or status[2]):
                # Members already mid-flight (Permit-parked or bound):
                # shedding the rest would strand the barrier until the
                # permit timeout — admit instead, the whole-gang atomicity
                # half of the shed contract.
                return None
        return why

    def on_shed(qpi, why: str) -> None:
        overload.note_shed()
        metrics.pending.record(
            qpi.pod.key,
            kind="overload-shed",
            message=why,
            gang=gang_name_of(qpi.pod.labels),
            shard=shard,
        )

    queue = SchedulingQueue(
        framework.queue_sort,
        clock=clock,
        immediate_retry_attempts=config.immediate_retry_attempts,
        tenant_of=tenant_of if ledger is not None else None,
        share_fn=ledger.dominant_share if ledger is not None else None,
        quota_fn=quota_fn,
        on_quota_park=on_quota_park,
        shed_fn=shed_fn,
        on_shed=on_shed,
    )
    # The queue is a pressure source for the ladder (its overload_depth
    # excludes already-shed entries) and a step-down reactivation target,
    # and it feeds the SLO engine's pending/starvation side.
    overload.add_queue(queue)
    metrics.slo.add_queue(queue)
    _register_stack_families(
        metrics, queue, binder, accountant, bind_executor, ledger, journal
    )

    def _reactivates(event: Event) -> bool:
        # New/changed TPU metrics may make parked pods schedulable; pod
        # deletions free chips; Node changes re-open hosts; Namespace label
        # changes can open namespaceSelector scopes; a claim or volume
        # appearing (or changing) re-resolves pods parked on it. Binds
        # already reactivate via the scheduler.
        return (
            event.kind
            in (
                "TpuNodeMetrics",
                "Node",
                "Namespace",
                "PersistentVolumeClaim",
                "PersistentVolume",
            )
            or event.type == "deleted"
        )

    def on_change_batch(events: "list[Event]") -> None:
        """ONE reactivation decision per applied batch; a pod deleted while
        queued leaves the queue now (the Permit-parked half of this fast
        path lives in GangPlugin.handle: the deleted member's wait is
        rejected and the cascade releases the gang immediately)."""
        for event in events:
            if event.kind == "Pod" and event.type == "deleted":
                queue.remove(event.obj.uid)
                # SLO engine: a pod deleted while pending retires its
                # enqueue record — a cancelled ask is not an admission.
                metrics.slo.observe_retired(event.obj)
        if any(map(_reactivates, events)) and queue.has_parked():
            queue.move_all_to_active()
        # Node failure domains: condition signals (TPU CR / Node
        # deletions, NotReady) and per-chip health feed the health ladder
        # at EVENT TIME, and a deleted node's still-bound pods have their
        # ghost reservations released now. State only on this (watch)
        # thread; repair I/O runs in the monitor's pass. `nodehealth` is
        # assigned below, before any watcher registers, so the closure
        # never sees it unbound.
        nodehealth.observe_events(events)

    # Enqueue edge of the lifecycle trace: the pod's (or its gang's) trace
    # ROOT — everything later (gather, dispatch, cycles, binds, moves)
    # parents back to it.
    tracer = metrics.tracer

    def on_pod_pending(pod) -> None:
        if tracer.enabled:
            tracer.add(subject_of(pod), "enqueue", attrs={"pod": pod.key})
        # SLO engine: the enqueue half of the admission-wait SLI (the
        # bound half fires in the scheduler's bind completion paths).
        metrics.slo.observe_enqueue(pod)
        queue.add(pod)

    informer = InformerCache(
        scheduler_name=config.scheduler_name,
        on_pod_pending=on_pod_pending,
        on_change_batch=on_change_batch,
        # A backend with a claim / volume / budget surface enforces them
        # (an empty store then means "none exist"); without one, volume
        # constraints are not enforced and budgets act only through
        # refused evictions.
        watches_pvcs=hasattr(cluster, "put_pvc"),
        watches_pvs=hasattr(cluster, "put_pv"),
        watches_pdbs=hasattr(cluster, "put_pdb"),
        staleness_s=config.max_metrics_age_s,
        # The watch-staleness clock (last_event_age_s) runs on the stack's
        # scheduling clock so held-clock drives can advance it.
        mono_fn=clock,
        # Scheduler lanes: partition-restricted snapshots + one-queue pod
        # routing (both None on unsharded stacks).
        node_filter_fn=node_filter_fn,
        pod_route_fn=pod_route_fn,
    )
    # The per-node health ladder, built BEFORE any watcher registers so
    # the replayed events already flow through observe_events. Fencing
    # rides the existing host_ok admission row: the monitor's fence set is
    # stamped onto every snapshot (informer.fence_fn) and the admission
    # call sites veto it. The scheduler handle (repair's unbind path and
    # leader check) is wired after construction below.
    nodehealth = NodeHealthMonitor(
        cluster=cluster,
        informer=informer,
        accountant=accountant,
        gang=gang,
        framework=framework,
        queue=queue,
        metrics=metrics,
        bind_executor=bind_executor,
        suspect_after_s=config.node_suspect_after_s,
        down_after_s=config.node_down_after_s,
        drain_deadline_s=config.node_drain_deadline_s,
        repair=config.node_repair,
        clock=clock,
    )
    informer.fence_fn = nodehealth.fenced_nodes
    if preemption is not None:
        # Victim preference reads the informer's budget cache (None until a
        # budget watch is live).
        preemption.pdbs_fn = informer.list_pdbs
    # Loop mode builds no batch plugin: nothing below is wired and its
    # counters are not registered, as in the reference.
    batch = next(
        (p for p in framework.batch_plugins if isinstance(p, YodaBatch)), None
    )
    if batch is not None:
        batch.tracer = metrics.tracer
        batch.claimed_fn = informer.claimed_hbm_mib
        batch.claimed_map_fn = informer.claimed_hbm_mib_map
        batch.claimed_delta_fn = informer.claimed_changes_since
        batch.last_updated_map_fn = informer.last_updated_map
        # The informer's epoch/delta feed makes the batch plugin's fleet
        # state DEVICE-RESIDENT (ops/resident.py): watch deltas refill only
        # the changed rows and update them on the device in place; a full
        # re-stack happens only on epoch skew, node add/delete or bucket
        # growth.
        batch.changes_fn = informer.changes_since
        # Companion admission feed (Node-object events and pod-set changes
        # the metrics ring elides): the admission cache survives snapshot
        # rebuilds by patching only the touched rows.
        batch.admission_changes_fn = informer.admission_changes_since
        _register_batch_families(metrics, batch)
        if (
            shard is not None
            and batch.device.type == "cuda"
            and isinstance(batch._kern, TorchFleetKernel)
        ):
            # A lane launches and fetches on a stream of its own: on the
            # default stream every lane's result copy would wait on every
            # other lane's kernels.
            batch._kern.stream = torch.cuda.Stream(device=batch.device)
    # Watcher wiring. Per-event handlers run in registration order
    # (accountant and gang before the informer: reservation releases and
    # membership changes precede the informer's view of the same event).
    # With batched ingest ON (ingest_batch_window_ms > 0) ONE watcher — the
    # EventBatcher — is registered instead: it buffers + coalesces the
    # stream and applies each batch through the same chain, the informer
    # taking the whole list under one lock acquisition (handle_batch) with
    # one epoch bump and one reactivation decision.
    per_event_sinks = []
    if own_accountant:
        per_event_sinks.append(accountant.handle)
    per_event_sinks.append(gang.handle)
    if ledger is not None:
        per_event_sinks.append(ledger.handle)
    registered_fns: list = []  # -> Stack.watch_fns (resize retirement)
    ingestor = None
    if config.ingest_batch_window_ms > 0:

        def apply_batch(events: "list[Event]") -> None:
            for event in events:
                for sink in per_event_sinks:
                    sink(event)
            informer.handle_batch(events)
            if recorder is not None:
                for event in events:
                    recorder.handle(event)

        def on_ingest_batch(raw: int, applied: int) -> None:
            metrics.ingest_events.inc(raw)
            if applied:
                metrics.ingest_batch.observe(applied)

        ingestor = EventBatcher(
            apply_batch,
            batch_max=config.ingest_batch_max,
            window_s=config.ingest_batch_window_ms / 1000.0,
            on_batch=on_ingest_batch,
        )
        cluster.add_watcher(ingestor.offer, batch_fn=ingestor.offer_batch)
        registered_fns.append(ingestor.offer)
        overload.add_ingestor(ingestor)
    else:
        for sink in per_event_sinks:
            cluster.add_watcher(sink)
            registered_fns.append(sink)
        # batch_fn lets the list-shaped startup replay apply under one
        # informer lock even with the live stream per-event.
        cluster.add_watcher(informer.handle, batch_fn=informer.handle_batch)
        registered_fns.append(informer.handle)
        if recorder is not None:
            # Prune aggregation state for deleted pods.
            cluster.add_watcher(recorder.handle)
            registered_fns.append(recorder.handle)
    if not getattr(metrics, "_fleet_attached", False):
        # Fleet gauges (chips total/free, bin-packing efficiency, duty
        # cycle), collected at scrape time and attached once per registry
        # (the first stack built against a shared one wins); the SLO
        # engine samples the efficiency gauge as its goodput SLI.
        metrics.attach_fleet(informer.snapshot, accountant.chips_in_use)
        metrics._fleet_attached = True
        metrics.slo.goodput_fn = metrics.binpack_efficiency.value
    scheduler = Scheduler(
        framework,
        informer.snapshot,
        queue,
        clock=clock,
        metrics=metrics,
        percentage_nodes_to_score=config.percentage_nodes_to_score,
        cycle_lock=cycle_lock,
        post_filter_lock=post_filter_lock,
        # status.nominatedNodeName write (upstream preemption parity).
        on_nominated=lambda pod, node: cluster.set_nominated_node(pod.key, node),
        on_bound=recorder.scheduled if recorder else None,
        on_unschedulable=recorder.failed_scheduling if recorder else None,
        pod_alive=informer.pod_schedulable,
        burst_size=config.batch_requests,
        bind_executor=bind_executor,
    )
    # Worker-side fencing + pipeline observability: the binder re-checks
    # the scheduler's CURRENT fence immediately before every bind API
    # write (fence_fn is settable post-construction — the CLI wires the
    # leader elector later — so the indirection through _fenced reads the
    # live value), and feeds the yoda_bind_wall_ms histogram.
    binder.fenced_fn = scheduler._fenced
    binder.on_fenced = metrics.fenced_binds.inc
    binder.observe_wall_ms = metrics.bind_wall.observe
    if shard is not None:
        # Scheduler lane: tag this loop's cycles (the shared accountant
        # stages their claims) and wire the optimistic commit point. The
        # per-lane gauges pick the loop up here.
        scheduler.shard = shard
        scheduler.commit_fn = accountant.commit_staged
        metrics._shard_loops.append((shard, scheduler, queue))
    # Same worker-side fence for preemption's evictions: victim selection
    # runs under the cycle lock, the eviction round trips do not.
    if preemption is not None:
        preemption.fenced_fn = scheduler._fenced
    # Crash-safe failover: the warm-start resync + drift reconciler for
    # this stack. Built but NOT started.
    reconciler = Reconciler(
        cluster=cluster,
        informer=informer,
        accountant=accountant,
        gang=gang,
        framework=framework,
        queue=queue,
        scheduler=scheduler,
        metrics=metrics,
        adopt_window_s=config.failover_adopt_window_s,
        scheduler_names=(config.scheduler_name,),
        clock=clock,
    )
    # Goodput-driven rebalancer: background ICI defragmentation + priority
    # preemption + elastic resize. Built but NOT started. The gate composes
    # leadership (the scheduler's live fence) with the warm-start contract
    # (no rebalancing on un-resynced state) and the overload ladder's
    # first degradation step: at ELEVATED and above the pass yields its
    # cycles to the serve loop.
    rebalancer = Rebalancer(
        cluster=cluster,
        informer=informer,
        accountant=accountant,
        gang=gang,
        framework=framework,
        queue=queue,
        scheduler=scheduler,
        metrics=metrics,
        bind_executor=bind_executor,
        clock=clock,
        min_gain=config.rebalance_min_gain,
        max_moves=config.rebalance_max_moves,
        preemption=config.rebalance_preemption,
        elastic=config.rebalance_elastic,
        max_victims=config.rebalance_max_victims,
        gate_fn=lambda: (
            not scheduler._fenced()
            and reconciler.resynced.is_set()
            and not overload.repairs_paused()
        ),
        # Graceful drain: the pass migrates bound gangs off DRAINING nodes
        # proactively, before the monitor's deadline forces a DOWN-style
        # evacuation.
        draining_fn=nodehealth.draining_nodes,
    )
    # Speculative placement cache: the rebalancer thread's sub-tick
    # pre-validates one placement per recently-seen single-pod shape
    # against a PRIVATE resident mirror on the batch plugin's device; the
    # serve loop's fast path consumes plans behind the fence + epoch +
    # reserved-chip revalidation chain. Wired to the SAME feeds the batch
    # plugin uses so the two views cannot diverge on sourcing. The
    # reference hands it config.weights, not the effective (strategy)
    # weights the batch plugin gets; so does the port.
    speculation = SpeculativeCache(
        snapshot_fn=informer.snapshot,
        changes_fn=informer.changes_since,
        admission_changes_fn=informer.admission_changes_since,
        reserved_fn=accountant.chips_in_use,
        reserved_map_fn=accountant.chips_by_node,
        claimed_fn=informer.claimed_hbm_mib,
        claimed_map_fn=informer.claimed_hbm_mib_map,
        last_updated_map_fn=informer.last_updated_map,
        weights=config.weights,
        max_metrics_age_s=config.max_metrics_age_s,
        enabled=config.spec_enabled,
        size=config.spec_cache_size,
        shapes_max=config.spec_shapes_max,
        # Loop mode: the device kernel_platform names.
        device=batch.device if batch is not None else config.kernel_platform,
    )
    speculation.bind_observe = metrics.spec_bind.observe
    scheduler.speculation = speculation
    rebalancer.speculator = speculation
    _register_speculation_families(metrics, speculation)
    # Late wiring (the scheduler and reconciler are built after the
    # informer the monitor hangs off): repair runs through the scheduler's
    # unbind path, and run_forever's gate composes leadership with the
    # warm-start contract and the overload ladder's repair pause.
    nodehealth.scheduler = scheduler
    nodehealth.gate_fn = lambda: (
        not scheduler._fenced()
        and reconciler.resynced.is_set()
        and not overload.repairs_paused()
    )
    return Stack(
        cluster, informer, accountant, framework, queue, scheduler, binder,
        batch, gang, preemption, reconciler, rebalancer, speculation,
        nodehealth, bind_executor, metrics, not_built,
        events=recorder, ingestor=ingestor, tenants=ledger,
        watch_fns=tuple(registered_fns), journal=journal,
    )


def _accumulator(metrics, name: str, register) -> list:
    """The list of sources behind a family group on ``metrics``: made, and
    the group registered by ``register(acc)``, by the first stack built
    against this registry; later stacks sharing it (profiles, scheduler
    lanes) append their own sources, so each family is registered ONCE
    and sums over every stack — a duplicate family would break the whole
    scrape."""
    acc = getattr(metrics, name, None)
    if acc is None:
        acc = []
        setattr(metrics, name, acc)
        register(acc)
    return acc


def _register_stack_families(
    metrics, queue, binder, accountant, bind_executor, ledger, journal
):
    """The families the reference's build_stack registers around the queue,
    the tenant ledger, the binder, the commit point, the journal and the
    scheduler lanes, with the reference's names, help strings and types,
    each summed over every stack sharing the registry. The journal
    counters read 0 with the journal off, the commit counters on an
    unsharded stack, and the per-lane gauges have no series there; the
    dominant-share family renders empty with fairness off, keeping one
    scrape schema across configurations."""
    r = metrics.registry

    def tenants(acc):
        def shares():
            merged: dict = {}
            for led in acc:
                for tenant, share in led.shares().items():
                    key = (("tenant", tenant),)
                    merged[key] = max(merged.get(key, 0.0), share)
            return merged

        r.gauge(
            "yoda_tenant_dominant_share",
            "Per-tenant dominant resource share (max of chip and HBM "
            "fractions of fleet capacity) — the DRF ordering key: "
            "pops draw from the lowest-share tenant first",
            shares,
        )

    def queues(acc):
        r.gauge(
            "yoda_queue_active_pods",
            "Pods ready to be scheduled right now, across profiles",
            lambda: sum(q.depths()[0] for q in acc),
        )
        r.gauge(
            "yoda_queue_backoff_pods",
            "Pods waiting out their retry backoff (deep = chronic "
            "unschedulables throttled past immediate_retry_attempts)",
            lambda: sum(q.depths()[1] for q in acc),
        )
        r.gauge(
            "yoda_queue_parked_pods",
            "Pods parked unresolvable until a cluster event (bad labels, "
            "missing claims, gang capacity)",
            lambda: sum(q.depths()[2] for q in acc),
        )

    def binders(acc):
        r.counter(
            "yoda_recovery_bind_retries_total",
            "Bind attempts retried after a transient API error (409 "
            "conflict / 429 throttle / 5xx / timeout) with jittered "
            "backoff, instead of failing the pod",
            lambda: sum(b.retries for b in acc),
        )
        r.counter(
            "yoda_recovery_unbinds_total",
            "Landed binds reversed by the transactional gang rollback "
            "(unbind or delete-for-recreate, backend-dependent)",
            lambda: sum(b.unbinds for b in acc),
        )

    def commits(acc):
        r.counter(
            "yoda_shard_commit_commits_total",
            "Optimistic shard-commit groups validated and committed at "
            "the shared accountant (a singleton's pre-bind commit or a "
            "gang's fully-landed release cohort)",
            lambda: sum(a.commit_commits for a in acc),
        )
        r.counter(
            "yoda_shard_commit_conflicts_total",
            "Shard commits REFUSED by validation (an earlier-staged "
            "claim owned the chips): the losing shard unreserves (or "
            "rolls landed binds back) and requeues the gang whole",
            lambda: sum(a.commit_conflicts for a in acc),
        )

    def journals(acc):
        r.counter(
            "yoda_journal_appends_total",
            "Records appended to the durable claim journal (staged-claim"
            " / commit / rollback / release / snapshot): every commit-"
            "point state mutation, write-ahead of the in-memory apply",
            lambda: sum(j.appends for j in acc),
        )
        r.counter(
            "yoda_journal_bytes_total",
            "Bytes appended to the journal (length-prefixed, CRC-"
            "checksummed frames); divide by appends for mean record size",
            lambda: sum(j.bytes_written for j in acc),
        )
        r.counter(
            "yoda_journal_fsyncs_total",
            "fsync calls issued by the journal — rate tracks appends "
            "under journal_sync=always, commit edges + every ~64 appends"
            " under batch, and stays flat under off",
            lambda: sum(j.fsyncs for j in acc),
        )
        r.counter(
            "yoda_journal_replay_ms_total",
            "Wall milliseconds spent replaying the journal at open "
            "(warm-start promotion cost; compare yoda_resync_duration_ms"
            " for the cold-path blackout it replaces)",
            lambda: sum(j.replay_ms for j in acc),
        )
        r.counter(
            "yoda_journal_torn_records_total",
            "Torn/corrupt records repaired by truncate at replay (short "
            "header, truncated payload, or CRC mismatch; later segments "
            "discarded). Nonzero after a crash is normal; climbing "
            "during steady state means disk trouble",
            lambda: sum(j.torn_records for j in acc),
        )
        r.counter(
            "yoda_journal_compactions_total",
            "Segment rotations compacted into a snapshot-headed fresh "
            "segment (older segments deleted — journal size stays flat)",
            lambda: sum(j.compactions for j in acc),
        )

    def lanes(acc):
        def per_lane(fn):
            return lambda: {
                (("shard", sh),): float(fn(sched, q)) for sh, sched, q in acc
            }

        r.gauge(
            "yoda_shard_queue_depth",
            "Queued pods per scheduler shard (active + backoff + parked "
            "pools of the shard's DRF queue); series follow the live "
            "shard set",
            per_lane(lambda sched, q: len(q)),
        )
        r.gauge(
            "yoda_shard_cycles",
            "Scheduling cycles completed per shard serve loop "
            "(monotonic; series follow the live shard set)",
            per_lane(lambda sched, q: len(sched.stats.results)),
        )
        r.gauge(
            "yoda_shard_binds",
            "Pods bound per shard serve loop (monotonic; series follow "
            "the live shard set)",
            per_lane(lambda sched, q: sched.stats.binds),
        )

    def executors(acc):
        r.gauge(
            "yoda_bind_inflight",
            "Bind API calls currently in flight on the bind executor "
            "(the pipeline's overlap window; 0 = no pending binds)",
            lambda: float(sum(e.inflight() for e in acc)),
        )

    led_acc = _accumulator(metrics, "_tenant_ledgers", tenants)
    if ledger is not None:
        led_acc.append(ledger)
    _accumulator(metrics, "_queues", queues).append(queue)
    _accumulator(metrics, "_binders", binders).append(binder)
    commit_acc = _accumulator(metrics, "_commit_accountants", commits)
    if accountant not in commit_acc:
        commit_acc.append(accountant)
    journal_acc = _accumulator(metrics, "_journals", journals)
    if journal is not None and journal not in journal_acc:
        journal_acc.append(journal)
    _accumulator(metrics, "_shard_loops", lanes)
    if bind_executor is not None:
        _accumulator(metrics, "_bind_executors", executors).append(bind_executor)


def _register_batch_families(metrics, batch):
    """The batch plugin's lazy counters, as the reference registers them,
    summed over every stack's plugin sharing the registry. The dispatch
    fallback chain's families read the plugins' counters; a primary on the
    card never demotes, so there only ``yoda_dispatch_errors_total`` moves.
    The help strings stay the reference's."""
    r = metrics.registry

    def register(acc):
        r.counter(
            "yoda_kernel_dispatches_total",
            "Real fused-kernel dispatches (gang siblings served from a "
            "placement plan do not dispatch)",
            lambda: sum(p.dispatch_count for p in acc),
        )
        r.counter(
            "yoda_gang_plan_served_total",
            "Gang member cycles answered from a whole-gang placement plan",
            lambda: sum(p.plan_served for p in acc),
        )
        r.counter(
            "yoda_gang_plan_invalidated_total",
            "Live gang placement plans dropped before being fully served "
            "(validation failure or concurrent-gang eviction)",
            lambda: sum(p.plan_invalidated for p in acc),
        )
        r.counter(
            "yoda_gang_fused_dispatches_total",
            "Whole-gang kernel dispatches (the gang-fused pass: every "
            "gathered member evaluated in one burst-kernel call)",
            lambda: sum(p.gang_burst_dispatches for p in acc),
        )
        r.counter(
            "yoda_gang_fused_served_total",
            "Gang member cycles answered from a gang-fused dispatch "
            "(sibling claims deducted host-side)",
            lambda: sum(p.gang_burst_served for p in acc),
        )
        r.counter(
            "yoda_gang_fused_invalidated_total",
            "Gang-fused dispatch rows dropped by a failed serve-time "
            "validation (foreign reservation, metrics republish, "
            "allocatable conflict)",
            lambda: sum(p.gang_burst_invalidated for p in acc),
        )
        r.counter(
            "yoda_joint_dispatches_total",
            "Cross-gang joint kernel dispatches (several co-queued "
            "gangs evaluated in one kernel call, serving disjoint "
            "blocks)",
            lambda: sum(p.joint_dispatches for p in acc),
        )
        r.counter(
            "yoda_joint_gangs_fused_total",
            "Gangs whose placement rows came from a cross-gang joint "
            "dispatch",
            lambda: sum(p.joint_gangs for p in acc),
        )
        r.counter(
            "yoda_joint_gangs_parked_total",
            "Gangs the joint fit gate parked whole (restored to the "
            "queue untouched instead of reserving and cascading)",
            lambda: sum(p.joint_parked for p in acc),
        )
        r.counter(
            "yoda_burst_dispatches_total",
            "Multi-pod burst kernel dispatches (config batch_requests: "
            "one dispatch pre-evaluates up to K pending pods)",
            lambda: sum(p.burst_dispatches for p in acc),
        )
        r.counter(
            "yoda_burst_served_total",
            "Scheduling cycles answered from a multi-pod burst dispatch",
            lambda: sum(p.burst_served for p in acc),
        )
        r.counter(
            "yoda_burst_invalidated_total",
            "Burst rows dropped by a failed validation (metrics "
            "republish, foreign reservation, allocatable conflict) — a "
            "high rate means the amortization is being lost to churn",
            lambda: sum(p.burst_invalidated for p in acc),
        )
        r.gauge(
            "yoda_kernel_dispatch_floor_ms",
            "Measured default-device per-dispatch floor (0 until the "
            "auto platform policy probes it; ~0.1 locally-attached, "
            "~100 over a tunnel/RPC transport)",
            lambda: 0.0,
        )
        r.counter(
            "yoda_dispatch_errors_total",
            "Kernel dispatch exceptions caught by the fallback chain "
            "(each one demoted the dispatch a backend level instead "
            "of crashing the scheduling loop)",
            lambda: sum(p.dispatch_errors for p in acc),
        )
        r.counter(
            "yoda_dispatch_fallback_total",
            "Dispatches completed on a DEMOTED kernel backend "
            "(primary -> XLA host kernel -> numpy evaluator) — "
            "nonzero means degraded-mode operation",
            lambda: sum(p.dispatch_fallbacks for p in acc),
        )
        r.gauge(
            "yoda_dispatch_backend_level",
            "Circuit-breaker backend pin: 0 = primary kernel, 1 = XLA "
            "host fallback, 2 = numpy evaluator (max over profiles; "
            "nonzero = a backend was pinned down after repeated "
            "dispatch failures)",
            lambda: max((p.backend_level for p in acc), default=0),
        )
        r.counter(
            "yoda_snapshot_reuse_total",
            "Static fleet refreshes answered without touching the "
            "fleet (metrics epoch unchanged since the last dispatch) "
            "— the device-resident state's steady-state hit path",
            lambda: sum(p.snapshot_reuse for p in acc),
        )
        r.counter(
            "yoda_admission_cache_reuse_total",
            "Host-admission vectors reused ACROSS snapshot rebuilds "
            "(both informer feeds report the entry's epochs current)",
            lambda: sum(p.admission_reuse for p in acc),
        )
        r.counter(
            "yoda_admission_cache_patched_total",
            "Host-admission vectors carried across snapshots by "
            "re-checking only the delta-feed-touched rows",
            lambda: sum(p.admission_patched for p in acc),
        )
        r.counter(
            "yoda_admission_cache_rebuilds_total",
            "Full O(fleet) host-admission rebuilds (structural churn, "
            "feed ring eviction, or first sight of a shape)",
            lambda: sum(p.admission_rebuilds for p in acc),
        )
        r.counter(
            "yoda_restack_total",
            "Full fleet re-stacks (snapshot -> host arrays -> whole-"
            "fleet device upload): epoch skew, node add/delete, or "
            "bucket growth. At low churn this should sit near the "
            "boot count — a climbing rate means the delta feed is "
            "being outrun",
            lambda: sum(p.restacks for p in acc),
        )
        r.gauge(
            "yoda_delta_apply_ms",
            "Wall milliseconds of the most recent incremental fleet "
            "delta apply (changed-row refill + in-place device "
            "scatter); independent of fleet size at low churn",
            lambda: max((p.delta_apply_ms for p in acc), default=0.0),
        )
        r.counter(
            "yoda_sharded_dispatches_total",
            "Kernel dispatches served by the node-axis mesh-sharded "
            "backend (config mesh_devices; the fallback chain demotes "
            "to single-device XLA / numpy below it)",
            lambda: sum(p.sharded_dispatches for p in acc),
        )
        r.gauge(
            "yoda_kernel_on_accelerator",
            "1 when some fused kernel currently targets the process "
            "default accelerator device (0 = pinned to host CPU by the "
            "platform policy or config)",
            lambda: int(any(p.device.type != "cpu" for p in acc)),
        )

    _accumulator(metrics, "_batch_plugins", register).append(batch)


def _register_speculation_families(metrics, spec):
    r = metrics.registry

    def register(acc):
        r.counter(
            "yoda_spec_cache_hits_total",
            "Serve cycles bound from a speculative placement plan (the "
            "sub-millisecond fast path: filter/score spans skipped)",
            lambda: sum(s.hits for s in acc),
        )
        r.counter(
            "yoda_spec_cache_misses_total",
            "Speculation lookups finding no plan for an in-scope shape "
            "(the miss records the shape for the next producer tick)",
            lambda: sum(s.misses for s in acc),
        )
        r.counter(
            "yoda_spec_cache_invalidations_total",
            "Speculative plans dropped before consumption (delta-feed "
            "touch, failed revalidation, Reserve race, flush) — staleness "
            "caught, never bound",
            lambda: sum(s.invalidations for s in acc),
        )

    _accumulator(metrics, "_speculations", register).append(spec)


def apply_reloadable(stacks: "list[Stack]", config: SchedulerConfig) -> None:
    """Apply every RELOADABLE knob of ``config`` to a RUNNING assembly
    (profile stacks, shard lanes — ``stacks`` is the live list; the
    ``apply_fn`` of ``overload.ConfigReloader``). Each assignment lands on
    an attribute its consumer re-reads at use time, so the apply is atomic
    per knob — no consumer ever sees a half-reloaded composite."""
    metrics = stacks[0].metrics
    ov = metrics.overload
    ov.period_s = float(config.overload_period_s)
    ov.queue_high = int(config.overload_queue_high)
    ov.ingest_high = int(config.overload_ingest_high)
    ov.cycle_ms_high = float(config.overload_cycle_ms_high)
    ov.step_down_hold_s = float(config.overload_step_down_hold_s)
    ov.brownout_admit_per_s = float(config.overload_brownout_admit_per_s)
    ov.shed_priority_floor = int(config.overload_shed_priority)
    # Routed through the monitor so a reload during a feature-pause
    # updates the step-down restore value instead of unpausing tracing.
    ov.set_base_sample_rate(config.trace_sample_rate)
    metrics.slo.enabled = config.slo_enabled
    metrics.slo.burn_threshold = config.slo_burn_threshold
    metrics.pending.capacity = max(config.pending_index_max, 16)
    # Durable claim journal: sync policy + rotation threshold are live
    # attributes the journal re-reads per append (journal_path itself is
    # IMMUTABLE — repointing a live log would split the durable record).
    for st in stacks:
        j = st.accountant.journal
        if j is not None:
            j.sync = config.journal_sync
            j.segment_bytes = int(config.journal_segment_bytes)
    for st in stacks:
        st.queue.immediate_retry_attempts = config.immediate_retry_attempts
        if st.binder is not None:
            st.binder.policy = BackoffPolicy(
                attempts=max(config.bind_retry_attempts, 0),
                base_s=config.bind_retry_base_s,
                cap_s=config.bind_retry_cap_s,
            )
        if st.rebalancer is not None:
            st.rebalancer.min_gain = config.rebalance_min_gain
            st.rebalancer.max_moves = config.rebalance_max_moves
            st.rebalancer.max_victims = config.rebalance_max_victims
            st.rebalancer.enable_preemption = config.rebalance_preemption
            st.rebalancer.enable_elastic = config.rebalance_elastic
        if st.nodehealth is not None:
            st.nodehealth.repair = config.node_repair
            st.nodehealth.drain_deadline_s = config.node_drain_deadline_s
        if st.speculation is not None:
            # configure() flushes on disable and evicts on shrink, so a
            # live reload can never leave plans beyond the new bounds.
            st.speculation.configure(
                enabled=config.spec_enabled,
                size=config.spec_cache_size,
                shapes_max=config.spec_shapes_max,
            )


def build_federation(
    clusters: "list[tuple[str, object]]",
    config: SchedulerConfig | None = None,
    *,
    clock=time.monotonic,
    stop_event: "threading.Event | None" = None,
):
    """Assemble a federated multi-cluster scheduler: one fully-wired stack
    per cluster front (own informer, accountant, gang plugin, and warm-start
    reconciler — cluster capacity is disjoint, so only the metrics
    registry is shared), each front watched by a health monitor fed from
    the cluster's probe surface and the informer's watch-staleness clock.
    ``clusters`` is ordered (name, cluster) pairs; the FIRST entry is the
    HOME cluster — the front workloads arrive on, and the one spillover
    migrates gangs off when it cannot fit them whole. Every member stack
    evaluates on the card unless ``config.kernel_platform`` is "cpu"
    ("auto", the default, raises without one). Each stack is built through
    this module's ``build_stack`` attribute, so a caller's patch of it
    applies to every member.

    The returned ``Federation`` owns per-member fencing (health + resync
    gate + leader gate) and the background control loop
    (``Federation.run_forever``); member serve loops start fenced and open
    once the first health pass completes their warm-start resync."""
    from yoda_tpu_torch.federation import (
        ClusterHealthMonitor,
        Federation,
        FederationMember,
    )

    config = config or SchedulerConfig()
    shared_metrics = _metrics_from_config(config, clock)
    members: list[FederationMember] = []
    for name, cluster in clusters:
        stack = build_stack(
            cluster=cluster,
            config=config,
            metrics=shared_metrics,
            clock=clock,
            stop_event=stop_event,
        )
        health = ClusterHealthMonitor(
            name,
            # Probe the cluster front when it offers one (KubeCluster /
            # FakeCluster / ChaosCluster all do); a front without a probe
            # is judged on watch staleness alone.
            probe_fn=getattr(cluster, "probe", None),
            staleness_fn=stack.informer.last_event_age_s,
            degraded_after_s=config.federation_degraded_after_s,
            partitioned_after_s=config.federation_partitioned_after_s,
            lost_after_s=config.federation_lost_after_s,
            clock=clock,
        )
        members.append(FederationMember(name, cluster, stack, health))
    return Federation(
        members,
        metrics=shared_metrics,
        spillover=config.federation_spillover,
        clock=clock,
    )


@dataclass
class ShardSet:
    """N parallel shard stacks + the serialized global lane over ONE
    cluster (scheduler shard-out). ``stacks[0]`` is the global
    lane (full-fleet informer — it owns the fleet gauges, the started
    reconciler/rebalancer/nodehealth loops, and every cross-shard gang);
    ``stacks[1:]`` are the shards in index order. All share one
    ChipAccountant (the optimistic commit point) and one metrics
    registry; each has its OWN cycle lock, queue, bind executor, and
    partition-restricted resident fleet state — that independence is the
    whole point."""

    stacks: "list[Stack]"
    router: object            # framework.shards.ShardRouter
    shard_map: object         # framework.shards.ShardMap
    accountant: ChipAccountant
    metrics: SchedulingMetrics
    config: SchedulerConfig
    # Live-resize plumbing: the assembly inputs resize() needs
    # to build new shard stacks, and the fence new lanes inherit (cli
    # sets it to its leadership+resync composition).
    clock: object = time.monotonic
    stop_event: "threading.Event | None" = None
    shard_fence_fn: object = None
    # shard_mode=process: the worker-process lifecycle
    # (framework.shards.WorkerSupervisor). None in thread mode; when
    # set, stacks holds ONLY the global lane — the shard serve loops
    # live in the supervised worker processes.
    supervisor: object = None

    @property
    def global_stack(self) -> Stack:
        return self.stacks[0]

    @property
    def shard_stacks(self) -> "list[Stack]":
        return self.stacks[1:]

    def queue_depth(self, shard_idx: int) -> int:
        """Live queue depth of shard ``s<idx>`` — the router's occupancy
        tie-break signal (0 for unknown/retired lanes)."""
        name = shard_name(shard_idx)
        for st in self.stacks[1:]:
            if st.scheduler.shard == name:
                return len(st.queue)
        return 0

    def reroute(self) -> int:
        """Move queued entries whose owning lane is not the router's
        answer: a shard that lost its last feasible slice hands its
        parked gangs to a lane that can still host them, and a
        GLOBAL-lane entry that belongs to a shard (the reconciler's
        resync/repair requeues land in the global stack's queue, while
        never-bound siblings replay into their shard's — a gang must
        never sit split across two lanes' barriers) moves home. Global
        entries with attempts > 0 stay put: those are rescue_starved's
        deliberate fallbacks, and rerouting them back to the shard that
        starved them would ping-pong forever. Called from the shard
        set's structural-event watcher and the rescue pass; cheap when
        queues are shallow. Returns entries moved."""
        lanes = {GLOBAL_LANE: self.stacks[0]}
        for st in self.stacks[1:]:
            lanes[st.scheduler.shard] = st
        moved = 0
        for st in self.stacks:
            own = st.scheduler.shard
            for pod, attempts in st.queue.all_entries():
                if own == GLOBAL_LANE and attempts > 0:
                    continue  # rescued work: the global lane owns it
                want = self.router.route(pod)
                if want == own:
                    continue
                target = lanes.get(want)
                if target is None or not st.queue.remove(pod.uid):
                    continue
                if target.queue.find(pod.uid) is not None:
                    # Already queued on the target lane (a replay or a
                    # requeue raced the move): dropping the source entry
                    # IS the dedupe — one pod, one queue entry.
                    moved += 1
                    continue
                # Attempts PRESERVED across the move: resetting them
                # would erase the rescue marker (global entries with
                # attempts > 0 stay put) and ping-pong a rescued entry
                # between the global lane and a full home shard forever.
                target.queue.readd(
                    QueuedPodInfo(pod=pod, attempts=attempts)
                )
                moved += 1
        return moved

    def rescue_starved(self, *, min_attempts: int = 3) -> int:
        """Hand work a shard has REPEATEDLY failed to place to the
        global lane. Static routing is capacity-shape feasibility only —
        a gang can route to a shard whose slices are then occupied by
        earlier work — so the dynamic half of the contract lives here:
        a gang whose members are ALL queued (never mid-Permit: taking
        half a gang would split its barrier across lanes) after
        ``min_attempts`` local failures migrates whole via the
        federation-spillover take_gang primitive; starved singletons
        move individually. The global lane sees the whole fleet, so no
        workload is ever wedged behind a partition boundary. Returns
        entries moved."""
        g = self.stacks[0]
        # Misrouted entries first (a resync/repair requeue in the global
        # queue whose siblings replay into a shard's): a gang must be
        # whole in ONE lane before starvation can even be judged.
        moved = self.reroute()
        for st in self.shard_stacks:
            for name, (count, attempts) in st.queue.pending_gangs().items():
                if attempts < min_attempts:
                    continue
                probe = next(
                    (
                        pod
                        for pod, _a in st.queue.all_entries()
                        if gang_name_of(pod.labels) == name
                    ),
                    None,
                )
                if probe is None:
                    continue
                try:
                    spec = pod_request(probe).gang
                except LabelParseError:
                    continue
                if spec is None or count < spec.size:
                    continue  # members mid-flight: never split the gang
                taken = st.queue.take_gang(name)
                for qpi in taken:
                    g.queue.readd(qpi)
                moved += len(taken)
            for pod, attempts in st.queue.all_entries():
                if attempts < min_attempts or gang_name_of(pod.labels):
                    continue
                if st.queue.remove(pod.uid):
                    # Attempts preserved: they ARE the rescue marker
                    # (reroute leaves global entries with attempts > 0
                    # alone — see reroute's ping-pong note).
                    g.queue.readd(
                        QueuedPodInfo(pod=pod, attempts=attempts)
                    )
                    moved += 1
        return moved

    def resize(
        self,
        new_count: int,
        *,
        start_fn=None,
        quiesce_timeout_s: float = 5.0,
    ) -> dict:
        """Live ``shard_count`` resize — zero downtime, no restart. The
        sequence:

        1. **Quiesce commits at the ChipAccountant barrier**: new
           commit validations wait; in-flight bind fan-outs are given
           ``quiesce_timeout_s`` to land. Staged claims stay valid
           across the swap (validation never reads the shard map), so
           in-flight gangs complete on their staged claims — nothing
           mid-flight is aborted.
        2. **Rebuild the rendezvous map**: a fresh ``ShardMap(n)``
           swaps into the router (gang memos cleared, generation
           bumped) and every surviving shard's informer gets its new
           partition filter (snapshots invalidated, rebuilt lazily).
        3. **Grow/shrink lanes**: new shard stacks are built against
           the same cluster/accountant/metrics (``start_fn`` spawns
           their serve threads in cli mode); dissolved lanes have their
           Permit waiters force-expired — those gangs requeue WHOLE
           through the standard rejection cascade (the only work a
           resize requeues) — then retire: scheduler permanently
           fenced, serve thread exits, watchers unregistered, metric
           series and SLO/overload sources dropped.
        4. **Reroute the moved ~1/N**: one reroute pass moves exactly
           the queued entries whose rendezvous owner changed (the
           movement bound the drill asserts); everything else stays put.
        5. **Resume** commits.

        Returns a report with the movement accounting."""
        with self._resize_lock():
            old_count = len(self.shard_stacks)
            if new_count == old_count or new_count < 1:
                return {
                    "resized": False, "shards": old_count,
                    "moved_entries": 0, "total_entries": 0,
                    "pools_moved": 0, "pools_total": 0,
                }
            old_map = self.shard_map
            cluster = self.global_stack.cluster
            total_entries = sum(len(st.queue) for st in self.stacks)
            self.accountant.hold_commits()
            try:
                deadline = time.monotonic() + quiesce_timeout_s
                while time.monotonic() < deadline and any(
                    st.bind_executor is not None
                    and st.bind_executor.inflight() > 0
                    for st in self.stacks
                ):
                    time.sleep(0.005)
                pools = self.router.pools_snapshot()
                new_map = ShardMap(new_count)
                pools_moved = sum(
                    1
                    for p in pools
                    if old_map.shard_of_pool(p) != new_map.shard_of_pool(p)
                )
                # Dissolving lanes: force-expire their Permit waiters
                # BEFORE the swap — rejections cascade through the gang
                # plugin (reservations released, members requeued whole
                # into this lane's queue) and the reroute below carries
                # them home. The resolutions run synchronously here.
                retiring = (
                    self.stacks[1 + new_count:]
                    if new_count < old_count
                    else []
                )
                for st in retiring:
                    st.framework.expire_waiting(now=float("inf"))
                # Grow FIRST, swap SECOND: a new lane's informer replays
                # the cluster list-then-watch, and its pod_route_fn asks
                # the router at replay time — with the OLD map still
                # installed the router never answers a new lane's name,
                # so the replay queues nothing and the reroute pass below
                # is the single owner of every moved entry (no
                # double-queued pods).
                for i in range(old_count, new_count):
                    name = shard_name(i)
                    st = build_stack(
                        cluster=cluster,
                        config=self.config,
                        accountant=self.accountant,
                        metrics=self.metrics,
                        clock=self.clock,
                        stop_event=self.stop_event,
                        shard=name,
                        node_filter_fn=new_map.node_filter(i),
                        pod_route_fn=(
                            lambda pod, _n=name: self.router.route(pod) == _n
                        ),
                    )
                    all_pending = getattr(self, "_all_pending", None)
                    if all_pending is not None:
                        _wire_stack_pending(st, all_pending)
                    if self.shard_fence_fn is not None:
                        st.scheduler.fence_fn = self.shard_fence_fn
                    self.stacks.append(st)
                    if start_fn is not None:
                        start_fn(st)
                # The swap: router first (event-time routing follows the
                # new map immediately), then the surviving informers'
                # partition filters (snapshots rebuilt lazily).
                self.shard_map = new_map
                self.router.swap_map(new_map)
                for i, st in enumerate(self.stacks[1:]):
                    if i < min(old_count, new_count):
                        st.informer.node_filter_fn = new_map.node_filter(i)
                        st.informer.invalidate_snapshot()
                # Every lane's speculative plans were computed against
                # the OLD partition map — a plan's node may no longer
                # belong to its lane — so the resize flushes them
                # wholesale rather than trusting per-plan revalidation
                # to notice a boundary move.
                for st in self.stacks:
                    if st.speculation is not None:
                        st.speculation.flush()
                # Shrink: retire dissolved lanes.
                for st in retiring:
                    self.stacks.remove(st)
                    st.scheduler.retire()
                # Reroute queued entries whose owner changed — surviving
                # lanes via the standard pass, dissolved lanes drained
                # explicitly (they are no longer in self.stacks).
                moved = self.reroute()
                lanes = {GLOBAL_LANE: self.stacks[0]}
                for st in self.stacks[1:]:
                    lanes[st.scheduler.shard] = st
                for st in retiring:
                    for pod, attempts in st.queue.all_entries():
                        if not st.queue.remove(pod.uid):
                            continue
                        want = self.router.route(pod)
                        target = lanes.get(want, self.stacks[0])
                        if target.queue.find(pod.uid) is not None:
                            moved += 1
                            continue
                        target.queue.readd(
                            QueuedPodInfo(pod=pod, attempts=attempts)
                        )
                        moved += 1
                for st in retiring:
                    self._retire_stack(st, cluster)
            finally:
                self.accountant.resume_commits()
            return {
                "resized": True,
                "shards": new_count,
                "moved_entries": moved,
                "total_entries": total_entries,
                "pools_moved": pools_moved,
                "pools_total": len(pools),
            }

    def _resize_lock(self):
        lock = getattr(self, "_resize_mutex", None)
        if lock is None:
            lock = self._resize_mutex = threading.Lock()
        return lock

    def _retire_stack(self, st: Stack, cluster) -> None:
        """Detach a dissolved lane from every shared surface: watchers,
        metric accumulators (its per-shard series retire on the next
        scrape — bounded cardinality), SLO/overload
        pressure sources, its ingest drain thread, and its executor pool
        (released WITHOUT firing the shared stop event)."""
        remove = getattr(cluster, "remove_watcher", None)
        if remove is not None:
            for fn in st.watch_fns:
                remove(fn)
        m = self.metrics
        for acc_name, obj in (
            ("_queues", st.queue),
            ("_binders", st.binder),
            ("_bind_executors", st.bind_executor),
        ):
            acc = getattr(m, acc_name, None)
            if acc is not None and obj in acc:
                acc.remove(obj)
        sacc = getattr(m, "_shard_loops", None)
        if sacc is not None:
            sacc[:] = [
                row for row in sacc if row[1] is not st.scheduler
            ]
        spacc = getattr(m, "_speculations", None)
        if spacc is not None and st.speculation is not None:
            spacc[:] = [s for s in spacc if s is not st.speculation]
        bacc = getattr(m, "_batch_plugins", None)
        if bacc is not None:
            mine = {
                id(p)
                for p in st.framework.batch_plugins
                if isinstance(p, YodaBatch)
            }
            bacc[:] = [p for p in bacc if id(p) not in mine]
        m.slo.remove_queue(st.queue)
        m.overload.remove_queue(st.queue)
        if st.ingestor is not None:
            m.overload.remove_ingestor(st.ingestor)
            st.ingestor.stop()
        if st.bind_executor is not None:
            st.bind_executor.release()

    def run_until_idle(self, *, max_wall_s: float = 30.0) -> None:
        """Drive every lane to idle concurrently (tests and benches; the
        production loops are cli-started serve_forever threads plus the
        maintenance loop). Threads are required — a losing shard's
        rollback requeues work that another lane must then pick up.
        Starved work is rescued to the global lane between drain rounds,
        so a capacity-imbalanced routing never wedges the drain."""
        deadline = time.monotonic() + max_wall_s
        last_binds = -1
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            # Rescue BEFORE draining too (mirrors the production
            # serve-start ordering): a resync/repair requeue sitting
            # misrouted in the global queue must move home before any
            # lane can admit half a gang to a Permit barrier.
            self.rescue_starved(min_attempts=1)
            threads = [
                threading.Thread(
                    target=st.scheduler.run_until_idle,
                    kwargs={"max_wall_s": remaining},
                    name=f"shard-drain-{st.scheduler.shard}",
                    daemon=True,
                )
                for st in self.stacks
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=max(deadline - time.monotonic(), 0.0) + 5.0)
            moved = self.rescue_starved(min_attempts=1)
            # Cross-lane reactivation (the set-level fixed point): lane
            # A binding — or rolling reservations back — changes what
            # lane B's parked entries could fit, but no watch event
            # carries "reservations moved"; each scheduler's own
            # fixed-point check only sees its own binds. While ANY lane
            # made progress this round, re-arm every parked queue and
            # drain again; idle means no moves AND no new binds with
            # work still parked.
            total_binds = sum(
                st.scheduler.stats.binds for st in self.stacks
            )
            parked = any(st.queue.has_parked() for st in self.stacks)
            if moved == 0 and (
                not parked or total_binds == last_binds
            ):
                return
            last_binds = total_binds
            if parked:
                for st in self.stacks:
                    if st.queue.has_parked():
                        st.queue.move_all_to_active(force=True)

    def run_forever(
        self, stop: "threading.Event", *, period_s: float = 5.0
    ) -> None:
        """The shard-set maintenance loop (cli thread): periodically
        rescue starved work to the global lane. Reroutes ride the
        structural-event watcher; this loop is the attempts-based
        backstop, cheap when queues are shallow."""
        last_binds = -1
        while not stop.is_set():
            try:
                # Process mode: one supervision pass per tick — dead
                # workers respawn with backoff; their staged residue was
                # already recovered by journal replay + reconciliation.
                if self.supervisor is not None:
                    self.supervisor.poll()
                self.rescue_starved()
                # Cross-lane reactivation tick: another lane's binds or
                # rollbacks change what this lane's parked entries could
                # fit, and no watch event carries reservation movement.
                # Only when binds advanced since the last tick (an idle
                # fleet pays nothing), and through the event cutoff
                # (never force) so chronic unschedulables stay bounded
                # by their own backoff.
                total_binds = sum(
                    st.scheduler.stats.binds for st in self.stacks
                )
                if total_binds != last_binds:
                    last_binds = total_binds
                    for st in self.stacks:
                        if st.queue.has_parked():
                            st.queue.move_all_to_active()
            except Exception:  # noqa: BLE001 — maintenance must not die
                log.exception("shard-set rescue pass failed")
            stop.wait(period_s)

    def close(self) -> None:
        """Stop the worker processes (process mode) and every lane's
        threads (``Stack.close``)."""
        if self.supervisor is not None:
            self.supervisor.stop()
        for st in self.stacks:
            st.close()


def build_sharded_stacks(
    cluster=None,
    config: SchedulerConfig | None = None,
    *,
    clock=time.monotonic,
    stop_event: "threading.Event | None" = None,
    shard_map=None,
) -> ShardSet:
    """Assemble the sharded scheduler: ``config.shard_count`` parallel
    serve loops over rendezvous-partitioned ICI slices/pools, plus the
    serialized global lane, sharing one ChipAccountant through the
    optimistic claim->validate->commit protocol (every lane — global
    included — stages its Reserve claims and validates at commit; a
    losing gang rolls back through the transactional unbind path and
    requeues whole). ``shard_map`` overrides the default
    ``ShardMap(config.shard_count)`` — the cross_shard_contention chaos
    mode passes one with a pinned-open overlap window.

    Every lane is built by ``build_stack`` and so runs on the card unless
    ``config.kernel_platform`` is "cpu"; on the card each lane's kernel
    has a CUDA stream of its own."""
    cluster = cluster or FakeCluster()
    config = config or SchedulerConfig()
    shard_map = shard_map or ShardMap(config.shard_count)
    router = ShardRouter(shard_map)
    # The router's fleet registry must be current before any informer
    # routes a pod from the same event batch: register it FIRST (watchers
    # run in registration order), replay included.
    cluster.add_watcher(router.observe, batch_fn=router.observe_batch)
    # One accountant across every lane — the commit point. Registered
    # before any stack's informer (build_profile_stacks discipline:
    # reservation releases precede the informer's view of the same
    # event); capacity tracking feeds the commit validator.
    accountant = ChipAccountant(scheduler_name=config.scheduler_name)
    accountant.track_capacity = True
    # Durable journal before the watcher: replayed claims (per-lane
    # staged residue included) must exist before the list-then-watch
    # replay layers over them.
    _attach_journal(accountant, config)
    cluster.add_watcher(accountant.handle)
    shared_metrics = _metrics_from_config(config, clock)
    # Global lane first: full fleet view (it owns the fleet gauges), pods
    # no shard can host, and the only started background repair loops.
    stacks = [
        build_stack(
            cluster=cluster,
            config=config,
            accountant=accountant,
            metrics=shared_metrics,
            clock=clock,
            stop_event=stop_event,
            shard=GLOBAL_LANE,
            pod_route_fn=lambda pod: router.route(pod) == GLOBAL_LANE,
        )
    ]
    for i in range(config.shard_count):
        name = shard_name(i)
        stacks.append(
            build_stack(
                cluster=cluster,
                config=config,
                accountant=accountant,
                metrics=shared_metrics,
                clock=clock,
                stop_event=stop_event,
                shard=name,
                node_filter_fn=shard_map.node_filter(i),
                pod_route_fn=(
                    lambda pod, _n=name: router.route(pod) == _n
                ),
            )
        )
    # Cross-lane pending-placement visibility (the build_profile_stacks
    # contract): a gang member of ANY lane parked at Permit is invisible
    # in snapshots, and every other lane's evaluators must see it. The
    # closure walks the LIVE stacks list (the same object ShardSet
    # mutates in place on a live resize), so lanes added or retired by
    # resize() stay visible/invisible automatically.
    def all_pending() -> list:
        out: list = []
        for st in stacks:
            out.extend(st.gang.pending_placements())
        return out

    for st in stacks:
        _wire_stack_pending(st, all_pending)
    shard_set = ShardSet(
        stacks=stacks,
        router=router,
        shard_map=shard_map,
        accountant=accountant,
        metrics=shared_metrics,
        config=config,
        clock=clock,
        stop_event=stop_event,
    )
    shard_set._all_pending = all_pending
    # Occupancy-aware routing: rendezvous ties
    # break by live shard queue depth, so a starved shard stops
    # attracting new gangs (and starved work stops defaulting to the
    # serialized global lane). Reads the live lanes through the shard
    # set, so a resize re-targets it automatically.
    router.depth_fn = shard_set.queue_depth

    # Structural fleet changes re-route queued entries whose owning lane
    # changed (and keep the router's aggregates fresh). Registered LAST:
    # by the time it fires, every informer has applied the same batch.
    def on_fleet_event(event) -> None:
        if event.kind in ("TpuNodeMetrics", "Node") and event.type in (
            "added", "deleted",
        ):
            shard_set.reroute()

    def on_fleet_batch(events) -> None:
        if any(
            e.kind in ("TpuNodeMetrics", "Node")
            and e.type in ("added", "deleted")
            for e in events
        ):
            shard_set.reroute()

    cluster.add_watcher(
        on_fleet_event, replay=False, batch_fn=on_fleet_batch
    )
    return shard_set


def build_proc_parent(
    cluster=None,
    config: SchedulerConfig | None = None,
    *,
    clock=time.monotonic,
    stop_event: "threading.Event | None" = None,
    shard_map=None,
) -> ShardSet:
    """Assemble the PARENT control plane for ``shard_mode=process``:
    the same head as :func:`build_sharded_stacks` — router
    watcher, journal-owning track-capacity accountant, shared metrics —
    but only the GLOBAL lane stack is built in this process. The shard
    serve loops run in worker processes (``framework/procserve.py``)
    that reach this accountant through the commit RPC; the caller wires
    a ``CommitRPCServer`` around ``shard_set.accountant`` and attaches
    a ``WorkerSupervisor`` as ``shard_set.supervisor``.

    The parent keeps everything that must stay singular: the CommitLog
    writer, the full-fleet informer + fleet gauges, the reconciler /
    rebalancer / nodehealth repair loops, and the metrics server.
    Workers own everything per-lane: informer, queue, BindExecutor, and
    on the card a CUDA context and kernel of their own. The global lane
    is built by ``build_stack`` and so runs on the card unless
    ``config.kernel_platform`` is "cpu".
    """
    cluster = cluster or FakeCluster()
    config = config or SchedulerConfig()
    shard_map = shard_map or ShardMap(config.shard_count)
    router = ShardRouter(shard_map)
    cluster.add_watcher(router.observe, batch_fn=router.observe_batch)
    # Single journal-owning accountant — the commit point every worker
    # RPCs into. Same registration discipline as build_sharded_stacks:
    # journal replay before the watcher, watcher before the informer.
    accountant = ChipAccountant(scheduler_name=config.scheduler_name)
    accountant.track_capacity = True
    _attach_journal(accountant, config)
    cluster.add_watcher(accountant.handle)
    shared_metrics = _metrics_from_config(config, clock)
    stacks = [
        build_stack(
            cluster=cluster,
            config=config,
            accountant=accountant,
            metrics=shared_metrics,
            clock=clock,
            stop_event=stop_event,
            shard=GLOBAL_LANE,
            pod_route_fn=lambda pod: router.route(pod) == GLOBAL_LANE,
        )
    ]
    shard_set = ShardSet(
        stacks=stacks,
        router=router,
        shard_map=shard_map,
        accountant=accountant,
        metrics=shared_metrics,
        config=config,
        clock=clock,
        stop_event=stop_event,
    )
    # No depth_fn: worker queue depths live in other processes; the
    # router falls back to pure rendezvous, which is exactly what the
    # workers themselves compute (same pure function, same answer).
    return shard_set


def _wire_stack_pending(stack: Stack, all_pending) -> None:
    """Point one stack's evaluators at the cross-lane pending view
    (build_sharded_stacks at assembly; ShardSet.resize for lanes added
    live)."""
    for p in stack.framework.pre_filter_plugins:
        if isinstance(p, YodaPreFilter):
            p.pending_fn = all_pending
    for p in stack.framework.batch_plugins:
        if isinstance(p, YodaBatch):
            p.pending_fn = all_pending


def build_profile_stacks(
    cluster,
    config: SchedulerConfig,
    *,
    clock=time.monotonic,
    stop_event: "threading.Event | None" = None,
) -> "list[Stack]":
    """One stack per scheduler profile (upstream KubeSchedulerConfiguration
    profiles: one process, several schedulerNames with different plugin
    configs), all sharing ``cluster``'s watch streams. The base config is
    the first profile; ``config.profiles`` follow. Each stack schedules
    only pods whose spec.schedulerName matches its profile (the informer
    filters pending pods; accounting still tracks every TPU-holding pod,
    so profiles see each other's reservations). Every stack is built by
    ``build_stack`` and so evaluates on the card unless its profile's
    ``kernel_platform`` is "cpu"."""
    names = (config.scheduler_name,) + tuple(
        p.scheduler_name for p in config.profiles
    )
    shared = ChipAccountant(
        scheduler_name=config.scheduler_name, scheduler_names=names
    )
    # Durable journal before the watcher (same order as build_stack).
    _attach_journal(shared, config)
    # Registered once, before any stack's informer, so reservation releases
    # precede the informer's view of the same event (build_stack's order).
    cluster.add_watcher(shared.handle)
    # One cycle at a time ACROSS profiles: without this, two profile loops
    # can both pass Filter against the same free chips before either
    # Reserves (upstream profiles share a single scheduleOne loop).
    cycle_lock = threading.Lock()
    # PostFilter preemption is serialized separately: two profiles must not
    # both select victim sets before either evicts (overlapping victims =
    # double intent). Victim selection additionally re-takes the cycle lock
    # inside TpuPreemption so it is consistent with Reserve; only the
    # eviction round-trips run lock-free.
    post_filter_lock = threading.Lock()
    shared_metrics = _metrics_from_config(config, clock)
    stacks = [
        build_stack(
            cluster=cluster,
            config=config,
            accountant=shared,
            cycle_lock=cycle_lock,
            post_filter_lock=post_filter_lock,
            metrics=shared_metrics,
            scheduler_names=names,
            clock=clock,
            stop_event=stop_event,
        )
    ]
    for prof in config.profiles:
        stacks.append(
            build_stack(
                cluster=cluster,
                config=prof,
                accountant=shared,
                cycle_lock=cycle_lock,
                post_filter_lock=post_filter_lock,
                metrics=shared_metrics,
                scheduler_names=names,
                clock=clock,
                stop_event=stop_event,
            )
        )
    # Pending-placement visibility must span profiles: a gang member of
    # ANY profile parked at Permit is invisible in snapshots, and the
    # inter-pod / pending-resource evaluators of every other profile need
    # to see it (the same reason the accountant is shared).
    gangs = [st.gang for st in stacks]

    def all_pending() -> list:
        out: list = []
        for g in gangs:
            out.extend(g.pending_placements())
        return out

    for st in stacks:
        for p in st.framework.pre_filter_plugins:
            if isinstance(p, YodaPreFilter):
                p.pending_fn = all_pending
        for p in st.framework.batch_plugins:
            if isinstance(p, YodaBatch):
                # The burst guard must see EVERY profile's Permit-parked
                # members, not just this stack's: a foreign member's
                # cpu/memory claim is invisible in snapshots, and a burst
                # prepared without it could overcommit allocatable.
                p.pending_fn = all_pending
    return stacks
