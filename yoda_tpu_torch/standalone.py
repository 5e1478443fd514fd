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
cluster offers them, and their events reactivate parked pods. Left out
until a later slice: the speculative placement cache, node health, the
rebalancer, the reconciler, the bind executor (binds run inline), tracing
/ metrics / SLO / overload (so preemption has no eviction counter hook),
batched ingest, tenancy, the durable journal, profiles, shards and
federation.

A knob of such a subsystem loads (``config.SchedulerConfig`` keeps every
knob of the reference), but ``build_stack`` raises ``NotImplementedError``
naming it when it is set away from its default — except to the value that
turns the subsystem off, which is what this port already does
(``UNPORTED_KNOB_VALUES``). Where the default turns such a part ON (the
reference builds it), ``build_stack`` logs one warning naming every such
part and lists them in ``Stack.not_built``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from dataclasses import dataclass

from yoda_tpu_torch.cluster.fake import Event, FakeCluster
from yoda_tpu_torch.cluster.informer import InformerCache
from yoda_tpu_torch.config import SchedulerConfig
from yoda_tpu_torch.framework.queue import SchedulingQueue
from yoda_tpu_torch.framework.runtime import Framework
from yoda_tpu_torch.framework.scheduler import Scheduler
from yoda_tpu_torch.plugins.yoda import (
    GangPlugin,
    TpuPreemption,
    YodaBatch,
    default_plugins,
)
from yoda_tpu_torch.plugins.yoda.accounting import ChipAccountant
from yoda_tpu_torch.plugins.yoda.binder import ClusterBinder

log = logging.getLogger("yoda_tpu_torch.standalone")

# Knobs this port honours, at any valid value.
PORTED_KNOBS = frozenset(
    {
        "scheduler_name",
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
    }
)

# Every other knob belongs to a part this port does not have yet; it must
# keep its default or take one of these values, each of which switches
# that part off (the port's behaviour either way). Each is listed with the
# part it turns on, for ``Stack.not_built``.
UNPORTED_KNOB_VALUES = {
    "bind_workers": ("bind executor", (0,)),
    "bind_pipeline": ("bind pipeline", ("off",)),
    "reconcile_period_s": ("reconciler", (0,)),
    "rebalance_period_s": ("rebalancer", (0,)),
    "spec_enabled": ("speculative placement cache", (False,)),
    "node_repair": ("node repair", (False,)),
    "node_health_period_s": ("node health monitor", (0,)),
    "trace_sample_rate": ("tracing", (0,)),
    "slo_enabled": ("SLO engine", (False,)),
    "overload_period_s": ("overload controller", (0,)),
}


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
        out.append(f"{f.name}={value!r}")
    return out


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
    batch: YodaBatch
    gang: GangPlugin
    # None when config.enable_preemption is off.
    preemption: TpuPreemption | None = None
    # Parts the config turns on that this port does not build
    # (not_built_parts); build_stack logs them once.
    not_built: tuple[str, ...] = ()


def build_stack(
    cluster: FakeCluster | None = None,
    config: SchedulerConfig | None = None,
    *,
    clock=time.monotonic,
    extra_plugins: "list | None" = None,
) -> Stack:
    """Build a fully-wired scheduler stack against ``cluster`` (a fresh
    FakeCluster by default). Watchers are registered list-then-watch, so a
    stack built against a populated cluster reconstructs accounting and
    gang membership from existing bound pods. The fleet evaluation runs on
    the CUDA device unless ``config.kernel_platform`` is "cpu"; with no
    card present the default raises. ``extra_plugins`` join the set ahead
    of the binder (a bind plugin there answers first)."""
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
    accountant = ChipAccountant(scheduler_name=config.scheduler_name)
    gang = GangPlugin(
        timeout_s=config.gang_permit_timeout_s,
        reserved_fn=accountant.chips_in_use,
    )
    plugins = default_plugins(
        weights=config.effective_weights(),
        reserved_fn=accountant.chips_in_use,
        max_metrics_age_s=config.max_metrics_age_s,
        kernel_platform=config.kernel_platform,
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
    # Preemption's victim selection takes THE scheduler's cycle lock, so it
    # is made here and handed to both.
    cycle_lock = threading.Lock()
    preemption = None
    if config.enable_preemption:
        preemption = TpuPreemption(
            cluster.evict_pod,
            scheduler_name=config.scheduler_name,
            select_lock=cycle_lock,
            reserved_fn=accountant.chips_in_use,
            gang_status_fn=gang.gang_status,
            gang_plan_fn=gang.planned_unassigned_hosts,
        )
        plugins.append(preemption)
    if extra_plugins:
        plugins.extend(extra_plugins)
    binder = ClusterBinder(
        cluster,
        retry_attempts=config.bind_retry_attempts,
        retry_base_s=config.bind_retry_base_s,
        retry_cap_s=config.bind_retry_cap_s,
    )
    plugins.append(binder)
    framework = Framework(plugins)
    gang.attach_framework(framework)
    queue = SchedulingQueue(
        framework.queue_sort,
        clock=clock,
        immediate_retry_attempts=config.immediate_retry_attempts,
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
        if any(map(_reactivates, events)) and queue.has_parked():
            queue.move_all_to_active()

    informer = InformerCache(
        scheduler_name=config.scheduler_name,
        on_pod_pending=queue.add,
        on_change_batch=on_change_batch,
        # A backend with a claim / volume / budget surface enforces them
        # (an empty store then means "none exist"); without one, volume
        # constraints are not enforced and budgets act only through
        # refused evictions.
        watches_pvcs=hasattr(cluster, "put_pvc"),
        watches_pvs=hasattr(cluster, "put_pv"),
        watches_pdbs=hasattr(cluster, "put_pdb"),
        staleness_s=config.max_metrics_age_s,
    )
    if preemption is not None:
        # Victim preference reads the informer's budget cache (None until a
        # budget watch is live).
        preemption.pdbs_fn = informer.list_pdbs
    (batch,) = framework.batch_plugins
    batch.claimed_fn = informer.claimed_hbm_mib
    batch.claimed_map_fn = informer.claimed_hbm_mib_map
    batch.claimed_delta_fn = informer.claimed_changes_since
    batch.last_updated_map_fn = informer.last_updated_map
    # The informer's epoch/delta feed makes the batch plugin's fleet state
    # DEVICE-RESIDENT (ops/resident.py): watch deltas refill only the
    # changed rows and update them on the device in place; a full re-stack
    # happens only on epoch skew, node add/delete or bucket growth.
    batch.changes_fn = informer.changes_since
    # Companion admission feed (Node-object events and pod-set changes the
    # metrics ring elides): the admission cache survives snapshot rebuilds
    # by patching only the touched rows.
    batch.admission_changes_fn = informer.admission_changes_since
    # Accountant and gang before informer: reservation releases and
    # membership changes precede the informer's view of the same event.
    cluster.add_watcher(accountant.handle)
    cluster.add_watcher(gang.handle)
    cluster.add_watcher(informer.handle, batch_fn=informer.handle_batch)
    scheduler = Scheduler(
        framework,
        informer.snapshot,
        queue,
        clock=clock,
        cycle_lock=cycle_lock,
        # status.nominatedNodeName write (upstream preemption parity).
        on_nominated=lambda pod, node: cluster.set_nominated_node(pod.key, node),
        pod_alive=informer.pod_schedulable,
        burst_size=config.batch_requests,
    )
    return Stack(
        cluster, informer, accountant, framework, queue, scheduler, binder,
        batch, gang, preemption, not_built,
    )
