"""Scheduler configuration knobs.

The reference hard-coded its scoring weights as compile-time consts
(reference pkg/yoda/score/algorithm.go:17-27) and decoded-but-ignored its
plugin args (scheduler.go:38-41,55-58). Here the weights and operational
knobs are real configuration (SURVEY.md §5 config row), loadable from the
scheduler config YAML (deploy/) and validated.

Counterpart of ``yoda_tpu/config.py``: every knob of the reference loads
here with the same default and the same validation, so the shipped
ConfigMap parses alike. ``standalone.build_stack`` refuses a knob of a
subsystem this port does not have yet when it is set away from its
default (``standalone.UNPORTED_KNOB_VALUES``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

from yoda_tpu_torch.slo.engine import SloTargets

# --- hot-reload classification ----------------------------------------------
#
# Every SchedulerConfig knob belongs to exactly one reload class; the
# classes drive `SchedulerConfig.diff()` and the SIGHUP/ConfigMap-watch
# hot-reload surface (yoda_tpu/overload.ConfigReloader):
#
# - RELOADABLE_KNOBS apply to a RUNNING scheduler atomically via
#   `standalone.apply_reloadable` — each one is re-read by its consumer at
#   use time (a live attribute), never captured into a serve-path local at
#   build time. The yodalint `reload-safety` pass enforces both directions:
#   every knob here must be re-applied in apply_reloadable, and no module
#   outside the assembly/reload layer may read it off a config object.
# - RESIZE_KNOBS change live through a dedicated topology path
#   (`shard_count` -> ShardSet.resize: quiesce commits, rebuild the
#   rendezvous map, reroute the moved ~1/N, resume).
# - IMMUTABLE_KNOBS define the process identity (mode, kernel backend,
#   profile set); a reload that changes one is refused with the old value
#   kept.
# - Everything else is REQUIRES-DRAIN: correct only through a restart via
#   the failover path (reported by the reloader, never half-applied).

RELOADABLE_KNOBS = frozenset(
    {
        "trace_sample_rate",
        "slo_enabled",
        "slo_burn_threshold",
        "immediate_retry_attempts",
        "bind_retry_attempts",
        "bind_retry_base_s",
        "bind_retry_cap_s",
        "rebalance_min_gain",
        "rebalance_max_moves",
        "rebalance_max_victims",
        "rebalance_preemption",
        "rebalance_elastic",
        "spec_enabled",
        "spec_cache_size",
        "spec_shapes_max",
        "node_repair",
        "node_drain_deadline_s",
        "overload_period_s",
        "overload_queue_high",
        "overload_ingest_high",
        "overload_cycle_ms_high",
        "overload_step_down_hold_s",
        "overload_brownout_admit_per_s",
        "overload_shed_priority",
        "pending_index_max",
        "journal_sync",
        "journal_segment_bytes",
    }
)
RESIZE_KNOBS = frozenset({"shard_count"})
IMMUTABLE_KNOBS = frozenset(
    {
        "mode",
        "scheduler_name",
        "weights",
        "scoring_strategy",
        "kernel_platform",
        "kernel_device_min_elems",
        "kernel_backend",
        "mesh_devices",
        "profiles",
        # The journal directory identifies ONE durable log; repointing a
        # live process would split the record across two logs (neither
        # replayable alone) — restart to move it.
        "journal_path",
        # The commit transport is the control plane's spine: workers and
        # the tailing standby hold persistent connections to it, and the
        # epoch-term fence assumes one endpoint per parent generation —
        # restart to rewire it.
        "commit_listen",
        "commit_endpoint",
    }
)


def classify_knob(name: str) -> str:
    """The reload class of one knob: ``reloadable`` | ``resize`` |
    ``immutable`` | ``requires-drain``."""
    if name in RELOADABLE_KNOBS:
        return "reloadable"
    if name in RESIZE_KNOBS:
        return "resize"
    if name in IMMUTABLE_KNOBS:
        return "immutable"
    return "requires-drain"


@dataclass(frozen=True)
class Weights:
    """Score weights — reference consts parity (algorithm.go:17-27):
    Bandwidth/Clock/Core/Power 1, FreeMemory 2, TotalMemory 1, Actual 2,
    Allocate 2, with Core->tflops and the memory terms renamed to HBM."""

    hbm_bandwidth: int = 1
    clock: int = 1
    tflops: int = 1
    power: int = 1
    hbm_free: int = 2
    hbm_total: int = 1
    actual: int = 2
    allocate: int = 2
    # Anti-fragmentation (net-new, no reference analog): pods with no
    # tpu/topology requirement prefer hosts OUTSIDE multi-host ICI slices,
    # keeping slices whole for topology gangs. Tiered above the metric terms
    # (bonus = SLICE_PROTECT_BONUS x weight); 0 disables.
    slice_protect: int = 1
    # Soft steering: the pod's preferredDuringScheduling node-affinity
    # satisfaction ([0,100], api.types.preferred_affinity_score) x this
    # weight, added alongside the normalized metric score; 0 disables.
    preferred_affinity: int = 1
    # Soft avoidance: each PreferNoSchedule taint the pod does not
    # tolerate subtracts 100 x this weight (upstream TaintToleration's
    # scoring half, simplified: per-taint penalty, no fleet-wide
    # normalization); 0 disables.
    taint_prefer: int = 1
    # Inter-pod soft steering: the signed preferred pod-(anti-)affinity
    # weight sum (api.affinity.InterPodEvaluator.preference) x this weight;
    # 0 disables (upstream InterPodAffinity's scoring half).
    pod_affinity: int = 1
    # Topology-spread balance: the [0,100] ScheduleAnyway balance score
    # (api.affinity.SpreadEvaluator.score) x this weight; 0 disables
    # (upstream PodTopologySpread's scoring half).
    topology_spread: int = 1
    # Upstream ImageLocality: [0,100] size-and-spread-scaled presence of
    # the pod's container images on the node (needs Node.status.images
    # from the Node watch) x this weight; 0 disables. Deliberately small
    # by default — for TPU jobs image pulls are dwarfed by checkpoint
    # restore (plugins/yoda/image_locality.py).
    image_locality: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "Weights":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown weight keys: {sorted(unknown)}")
        bad = {k: v for k, v in d.items() if not isinstance(v, int) or v < 0}
        if bad:
            raise ValueError(f"weights must be non-negative ints: {bad}")
        return cls(**d)


# Added AFTER the metric score is min-max normalized to [0,100] (so metric
# resolution is not crushed by the tier): one tier step is 1000 > 100, and
# slice protection strictly dominates chip quality for non-topology pods.
SLICE_PROTECT_TIER = 1000


@dataclass(frozen=True)
class SchedulerConfig:
    """Top-level plugin configuration (the reference's pluginConfig Args
    analog, made real)."""

    mode: str = "batch"               # "batch" (fused kernel) | "loop"
    # The spec.schedulerName this profile serves (upstream profiles: one
    # binary, several schedulerNames with different plugin configs).
    scheduler_name: str = "yoda-tpu"
    weights: Weights = field(default_factory=Weights)
    # Upstream NodeResourcesFit scoringStrategy analog:
    # "least-allocated" (default) prefers the freest qualifying node —
    # spreads load, upstream's default; "most-allocated" inverts the
    # free-leaning score terms (hbm_free / actual / allocate) to prefer the
    # fullest node that still fits — bin-packing for saturation fleets
    # (BASELINE config 3). Hardware-quality terms and the slice-protect
    # tier keep their sign either way.
    scoring_strategy: str = "least-allocated"
    gang_permit_timeout_s: float = 120.0
    max_metrics_age_s: float = 0.0    # 0 disables staleness filtering
    # Cap per-node score-plugin work to this % of feasible nodes (upstream
    # percentageOfNodesToScore; rotating window, min 8 nodes). Applies to
    # mode="loop" only — the fused kernel scores the fleet in one dispatch.
    percentage_nodes_to_score: int = 100
    enable_preemption: bool = True    # modern-PostFilter eviction (BASELINE config 5)
    # Where the fused kernel runs: "auto" (default) and "device" mean the
    # CUDA card, and raise when none is present — there is no silent CPU
    # path; "cpu" runs the kernel's plain PyTorch version on the host (how
    # the tests ask for the CPU). kernel_device_min_elems belonged to the
    # reference's TPU-measured auto crossover, which is not carried over
    # (on an H100 the card beat the host at every padded shape measured,
    # chip_smoke.py run (t2)): it loads, and build_stack refuses any value
    # but None.
    kernel_platform: str = "auto"
    kernel_device_min_elems: int | None = None
    # Fused-kernel implementation: "xla" or "pallas", the reference's two
    # names. On a CUDA device both dispatch the hand-written CUDA kernel
    # (ops/cuda_kernel.py); the plain PyTorch version runs only on CPU
    # tensors. The reference's cross-knob validation is kept below.
    kernel_backend: str = "xla"
    # Node-axis sharding of the fleet evaluation over the first N devices
    # (parallel/sharded.py): contiguous row blocks of the resident state, the
    # hand kernel's shard entry per block and the cross-shard reductions
    # between its phases. N CUDA cards, or N host shards with
    # kernel_platform "cpu"; None = one device.
    mesh_devices: int | None = None
    # Multi-pod fused dispatch: pop up to this many pending pods per loop
    # turn and evaluate them in ONE kernel call (YodaBatch.prepare_burst),
    # amortizing the fleet scan and the dispatch floor across pods. 1 =
    # one dispatch per pod. Batch mode only.
    batch_requests: int = 1
    # Transient-error bind retry (failure-domain hardening): a bind that
    # fails with a retryable error (409 conflict, 429 throttle, 5xx,
    # socket timeout — cluster.retry classification) is retried up to
    # this many times with full-jitter exponential backoff (base
    # doubling, capped) before it becomes a scheduling failure and, for
    # gang members, a transactional rollback. 0 disables retry.
    bind_retry_attempts: int = 3
    bind_retry_base_s: float = 0.05
    bind_retry_cap_s: float = 1.0
    # Bind pipeline: size of the bounded executor that fans a gang's
    # member binds out in parallel and carries their retry/backoff sleeps
    # off the scheduling thread, letting the serve loop overlap the next
    # cycle's snapshot + kernel dispatch with the in-flight bind I/O.
    # 0 disables the executor entirely (every bind runs inline in its
    # scheduling cycle — the pre-pipeline shape). Size to the API server's
    # comfortable concurrent-write budget; 8 covers a 64-member gang in
    # 8 waves.
    bind_workers: int = 8
    # Gates the ASYNC fan-out: "auto" (default) pipelines only when binds
    # are real I/O — a remote API server (KubeCluster.remote_binds) or a
    # backend with injected bind latency; in-process microsecond binds
    # stay synchronous (the thread handoff would cost more than it
    # hides). "on" forces the pipeline, "off" forbids it.
    bind_pipeline: str = "auto"
    # Crash-safe failover (framework/reconciler.py): how a promoted
    # scheduler's warm-start resync treats a PARTIALLY-BOUND gang left by
    # the dead leader. > 0: the gang is ADOPTED — its bound members stay,
    # their claims are charged, and the remaining members get this many
    # seconds to complete the gang before the drift reconciler rolls the
    # whole thing back via the unbind path. 0: never adopt — every
    # partial gang is rolled back whole at resync (the conservative
    # policy: strictly no state inherited from the dead leader).
    failover_adopt_window_s: float = 60.0
    # Period of the background drift reconciler (leaked reservations,
    # ghost bindings the watch stream dropped, permit waits whose pod was
    # deleted). Each round diffs local accounting against cluster truth;
    # on a real API server it re-LISTs pods, so keep it tens of seconds.
    # 0 disables the background loop (the warm-start resync still runs).
    reconcile_period_s: float = 30.0
    # Federated multi-cluster scheduling (yoda_tpu/federation): the
    # per-cluster health ladder's silence thresholds. A cluster front
    # whose probes AND watch stream have been silent for degraded_after_s
    # stops receiving new spillover; past partitioned_after_s it is
    # fenced from binding entirely (and its warm-start gate closes, so a
    # rejoin resyncs through the reconciler before the first new bind);
    # past lost_after_s readiness stops waiting for it. Must satisfy
    # 0 < degraded <= partitioned <= lost.
    federation_degraded_after_s: float = 10.0
    federation_partitioned_after_s: float = 30.0
    federation_lost_after_s: float = 120.0
    # Period of the federation control loop (health probes, rejoin
    # resyncs, spillover migration) — one background thread, never the
    # serve loops. Probes are one cheap LIST per cluster per pass.
    federation_probe_period_s: float = 1.0
    # Spillover routing: migrate a gang the home cluster cannot fit whole
    # to the first healthy secondary whose snapshot fits it (all-or-
    # nothing, exactly one cluster). False = clusters federate for
    # health/failover only; every gang stays on its home cluster.
    federation_spillover: bool = True
    # Goodput-driven rebalancer (yoda_tpu/rebalance): period of the
    # background pass that repacks bound topology gangs onto tighter ICI
    # blocks, preempts strictly-lower-priority work to admit a parked
    # whole gang, and resizes elastic gangs (tpu/min-members /
    # tpu/max-members). One pass per stack, leadership-gated, never on a
    # serve loop. 0 disables the background loop (Stack.rebalancer can
    # still be driven manually via run_once()).
    rebalance_period_s: float = 30.0
    # Minimum fragmentation-score improvement (rebalance/score.py, [0,1])
    # a repack move must buy before a bound gang is migrated — moves are
    # not free (unbind + rebind I/O), so tiny gains are not worth churn.
    rebalance_min_gain: float = 0.05
    # At most this many gang moves per pass (migration cost is hidden
    # behind the bind pipeline, but each move still re-places a whole
    # gang — bound per pass keeps the blast radius one gang at a time).
    rebalance_max_moves: int = 1
    # Enable the priority-preemption pass (victims are UNBOUND and
    # requeued through the standard rollback path — never deleted — so
    # preempted work re-places when capacity returns).
    rebalance_preemption: bool = True
    # Enable elastic gang resize (grow toward tpu/max-members into free
    # capacity; shrink toward tpu/min-members as the cheapest preemption
    # unit).
    rebalance_elastic: bool = True
    # Victim budget per admitted gang: the preemption pass gives up
    # rather than evict more than this many pods for one parked gang.
    rebalance_max_victims: int = 8
    # Speculative placement cache (framework/speculation.py,
    # docs/OPERATIONS.md "Sub-millisecond serve" runbook): between serve
    # cycles the rebalancer thread's idle capacity pre-validates one
    # placement per recently-seen single-pod shape; a hot-shape arrival
    # binds from the cached plan after the epoch + staged-claim
    # revalidation, skipping the O(fleet) filter/score spans. All three
    # knobs hot-reload; spec_enabled=False flushes every cached plan
    # atomically (the operator kill switch).
    spec_enabled: bool = True
    # Bound on cached plans (one per shape; shapes beyond the bound serve
    # at the fused-dispatch baseline).
    spec_cache_size: int = 256
    # Bound on tracked miss shapes the speculator re-plans per tick.
    spec_shapes_max: int = 64
    # Durable claim journal (yoda_tpu/journal, docs/OPERATIONS.md
    # "Durability and warm-start" runbook): directory for the append-only
    # commit log of every claim mutation. "" (the default) = journal OFF
    # — the in-memory accountant is the commit log, today's behavior,
    # zero new hot-path work. Set (typically a PVC mount) the commit
    # point write-ahead-journals staged-claim/commit/rollback/release
    # records and a promoted standby warm-starts by REPLAY instead of
    # the full-LIST cold resync.
    journal_path: str = ""
    # fsync policy per append: "always" (every record durable before the
    # claim applies — strongest, slowest), "batch" (fsync on commit and
    # snapshot records plus every ~64 appends — the default; at most a
    # batch of uncommitted stage records can be lost, which replay +
    # divergence resync repair), "off" (OS page cache only — fastest,
    # survives process crash but not host crash).
    journal_sync: str = "batch"
    # Segment rotation threshold: when the active segment exceeds this
    # many bytes the journal rotates to a fresh segment headed by a full
    # snapshot record and deletes older segments (compaction) — steady-
    # state disk use stays ~flat at snapshot + one segment of deltas.
    journal_segment_bytes: int = 4 * 1024 * 1024
    # Node failure domains (yoda_tpu/nodehealth): the per-node health
    # ladder's silence thresholds. A node whose agent has been silent
    # past node_suspect_after_s is SUSPECT — fenced from NEW placements
    # (the debounce window: a publish returns it to HEALTHY, so a
    # flapping heartbeat never triggers repair); continuous silence past
    # node_down_after_s (or a TPU CR / Node deletion, or Node NotReady)
    # is DOWN — every gang with a member on the node is repaired WHOLE
    # (patch repair preferred: only the lost members re-plan, healthy
    # members keep their bindings; fallback whole unbind-and-requeue —
    # never a split gang, never a deleted pod). Must satisfy
    # 0 < suspect <= down.
    node_suspect_after_s: float = 15.0
    node_down_after_s: float = 60.0
    # Enable automatic DOWN repair (False = the monitor only classifies
    # and fences; repair is the operator's job).
    node_repair: bool = True
    # Graceful drain (NodeHealthMonitor.drain, rolling cluster
    # upgrades): how long the rebalancer gets to migrate bound gangs off
    # a draining node before the monitor force-evacuates the remainder.
    node_drain_deadline_s: float = 300.0
    # Period of the background node-health pass (ladder tick + repair),
    # leadership-gated like the rebalancer. 0 disables the loop
    # (Stack.nodehealth can still be driven via run_once()); event-time
    # signals (deletions, NotReady, ghost releases) stay live either way.
    node_health_period_s: float = 5.0
    # Lifecycle tracing (yoda_tpu/tracing.py): fraction of pod/gang
    # lifetimes traced end-to-end (enqueue -> gather -> dispatch ->
    # reserve -> permit-park -> bind -> bound, plus rebalancer moves,
    # spillover, and resync repairs). Sampling is deterministic per
    # subject (a gang's members always land on the same side). 0 turns
    # tracing off entirely — call sites pay one attribute read.
    trace_sample_rate: float = 1.0
    # Bounded span-ring size; overflow evicts oldest and counts into
    # yoda_trace_dropped_total. Sized for ~minutes of burst traffic.
    trace_capacity: int = 4096
    # Optional JSONL sink: every span is also appended to this file (one
    # JSON object per line) for offline analysis. "" disables. A sink
    # that becomes unwritable is dropped silently; the ring keeps working.
    trace_sink: str = ""
    # JSONL sink rotation: when the sink file grows past this many bytes
    # it is rotated to "<trace_sink>.1" (two generations kept: current +
    # .1, the previous .1 overwritten), so a week-long soak cannot fill
    # the disk. 0 = never rotate (the pre-rotation behavior).
    trace_sink_max_bytes: int = 0
    # Fleet SLO engine (yoda_tpu/slo, docs/OPERATIONS.md "SLO monitoring"
    # runbook): per-tenant sliding-window SLIs (admission-wait quantiles,
    # starvation windows, preemption/repair rates, goodput) computed from
    # events the scheduler already emits, judged against the declarative
    # slo_targets with multi-window burn-rate alerting, served at
    # /debug/slo + `yoda-tpu-scheduler slo` + the yoda_slo_* series.
    # False turns the record paths off entirely (one attribute read per
    # call site — the same near-zero-when-off contract as tracing).
    slo_enabled: bool = True
    # Declarative targets (keys of slo.SloTargets; unset keys keep their
    # defaults, 0 disables a target).
    slo_targets: "SloTargets" = field(default_factory=lambda: SloTargets())
    # A starved window: one tenant holding queued work with ZERO
    # admissions for this long. The bench matrix asserts zero of these.
    slo_starvation_window_s: float = 60.0
    # Multi-window burn-rate alerting: the admission SLI's error budget
    # is burned over BOTH windows; an alert needs both past the
    # threshold (fast-only = noise, slow-only = old news).
    slo_burn_fast_window_s: float = 300.0
    slo_burn_slow_window_s: float = 3600.0
    slo_burn_threshold: float = 2.0
    # Cluster events retry a parked pod immediately through this many
    # scheduling attempts; beyond it the pod's exponential backoff timer
    # holds regardless of event rate (upstream moveAllToActiveOrBackoffQueue
    # semantics — bounds retry storms over chronically unschedulable pods).
    # 0 = strict upstream behavior (every event move respects backoff).
    immediate_retry_attempts: int = 5
    # Batched watch-event ingestion (cluster/ingest.py): when
    # ingest_batch_window_ms > 0, watch events are drained into bounded
    # batches — coalesced by (kind, uid): last-write-wins for modifies,
    # delete supersedes — and each batch is applied under ONE informer
    # lock acquisition with one metrics-epoch bump and one parked-pod
    # reactivation decision. 0 (default) keeps per-event delivery:
    # every event applies synchronously, exactly the pre-batching
    # behavior. The window bounds event-to-queue latency; size it well
    # under the scheduling cadence (a few ms).
    ingest_batch_max: int = 256
    ingest_batch_window_ms: float = 0.0
    # Per-tenant DRF fair queuing (framework/tenancy.py): a tenant is
    # the pod's namespace, overridable via the tpu/tenant label. When
    # on, the scheduling queue pops from the LOWEST dominant-resource-
    # share (chips/HBM) tenant first, so a flooding tenant cannot starve
    # the others. Off (default) = the classic single tenant-blind queue.
    tenant_fairness: bool = False
    # Per-tenant quota admission (requires tenant_fairness): admitting a
    # pod whose tenant's BOUND usage would exceed these caps parks it
    # with a why-pending verdict until capacity frees. 0 = unlimited.
    tenant_quota_chips: int = 0
    tenant_quota_hbm_gib: float = 0.0
    # Overload brownout ladder (yoda_tpu/overload.py, docs/OPERATIONS.md
    # "Overload brownout + hot-reload" runbook): the scheduler's own
    # self-protection under flash-crowd floods. Pressure = the max of the
    # normalized signals below (plus the SLO engine's burn-rate alert);
    # the ladder climbs NOMINAL -> ELEVATED (pause the rebalancer /
    # node-health repair passes, drop trace sampling to 0) -> BROWNOUT
    # (cap per-tenant admission through the DRF quota path) -> SHED (park
    # new non-prod-tier arrivals with an `overload-shed` why-pending
    # verdict; they requeue when the ladder steps down). Step-up is one
    # level per evaluation; step-down is debounced by
    # overload_step_down_hold_s of sustained calm, so flapping load
    # cannot thrash features. overload_period_s drives the background
    # evaluation loop (0 disables it; the monitor can still be driven
    # manually). Signal thresholds: 0 disables that signal.
    overload_period_s: float = 1.0
    overload_queue_high: int = 10000       # queued (non-shed) entries
    overload_ingest_high: int = 50000      # buffered ingest events
    overload_cycle_ms_high: float = 250.0  # serve-cycle p99 wall ms
    overload_step_down_hold_s: float = 15.0
    # BROWNOUT admission cap: scheduling draws admitted per tenant per
    # second (token bucket on the monitor clock); over-cap draws park
    # with a quota verdict until the bucket refills or the ladder drops.
    overload_brownout_admit_per_s: float = 10.0
    # Pods whose tpu/priority is at least this are PROD-TIER: never shed
    # (and effectively exempt from brownout caps sized above their rate).
    overload_shed_priority: int = 10
    # Why-pending index bound (tracing.PendingIndex): LRU over keys, so a
    # million-pod shed flood cannot grow why-pending state without limit;
    # evictions count into yoda_pending_evicted_total.
    pending_index_max: int = 2048
    # Scheduler shard-out (framework/shards.py, docs/OPERATIONS.md
    # sharding runbook): partition the node fleet by ICI slice/pool
    # across this many INDEPENDENT serve loops (rendezvous-hashed
    # slice->shard assignment; each shard runs its own queue, resident
    # fleet state, and bind executor), sharing one ChipAccountant
    # through an optimistic claim->validate->commit protocol. Gangs no
    # single shard can host fall back to a serialized global lane.
    # 1 (default) = today's single serve loop, the staging/commit
    # machinery entirely off. Incompatible with `profiles` (each shard
    # serves the base profile) and with federated mode.
    shard_count: int = 1
    # How the shard serve loops are hosted (OPERATIONS.md
    # "Multi-process shard serve"): "thread" (default) runs all lanes
    # in one interpreter — the PR-14 shape, byte-identical behavior;
    # "process" runs each shard lane as its own OS process (GIL-free
    # bind pipelines) reaching the parent's journal-owning accountant
    # through the local commit RPC (framework/procserve.py). Ignored
    # when shard_count == 1. Requires-drain: changing the process
    # topology of a live scheduler means a restart.
    shard_mode: str = "thread"
    # Multi-host control plane (OPERATIONS.md "Multi-host
    # control plane runbook"). commit_listen: the parent's commit RPC
    # listen endpoint — "" (default) serves the single-host AF_UNIX socket
    # (single host, byte-identical behavior); "host:port" serves the
    # length-prefixed TCP transport so shard workers and the tailing
    # standby can live on other hosts. Every response is stamped with
    # the parent's epoch term; fencing is bidirectional (see the
    # runbook). Immutable: the transport is the control plane's spine —
    # restart to change it.
    commit_listen: str = ""
    # Where THIS process reaches the live parent's commit RPC:
    # "host:port" (TCP) or an AF_UNIX socket path. A leader-elected
    # standby uses it to TAIL the live parent's journal into a warm
    # mirror (journal/tail.py), so promotion is an O(1) handover + term
    # bump instead of a cold replay. "" = no tailing (cold promotion);
    # parent-spawned workers are handed the parent's own endpoint
    # regardless of this knob. Immutable for the same reason as
    # commit_listen.
    commit_endpoint: str = ""
    # Additional profiles (upstream KubeSchedulerConfiguration profiles):
    # each entry inherits every unspecified key from the base config and
    # serves its own scheduler_name. E.g. a spread-strategy "yoda-tpu"
    # base plus a bin-packing "yoda-tpu-batch" profile in one process.
    profiles: tuple = ()              # tuple[SchedulerConfig, ...]

    @classmethod
    def from_dict(cls, d: dict) -> "SchedulerConfig":
        d = dict(d)
        w = d.pop("weights", None)
        slo_t = d.pop("slo_targets", None)
        if slo_t is not None:
            # Instance passthrough: profile resolution re-runs from_dict
            # over merged base keys that may already be parsed.
            if isinstance(slo_t, SloTargets):
                d["slo_targets"] = slo_t
            elif isinstance(slo_t, dict):
                d["slo_targets"] = SloTargets.from_dict(slo_t)
            else:
                raise ValueError(
                    f"slo_targets must be a mapping, got {slo_t!r}"
                )
        profile_dicts = d.pop("profiles", None) or ()
        if profile_dicts:
            base = dict(d)
            base_w = dict(w or {})
            resolved = []
            for pd in profile_dicts:
                pd = dict(pd)
                if "scheduler_name" not in pd:
                    raise ValueError(
                        "each profile must set scheduler_name"
                    )
                merged = {**base, **pd}
                merged["weights"] = {**base_w, **(pd.get("weights") or {})}
                merged.pop("profiles", None)
                # A pallas profile is incompatible with kernel_platform
                # and mesh_devices; INHERITED values must not fail its
                # validation (the operator never set them on this profile)
                # — only explicit ones do.
                if merged.get("kernel_backend") == "pallas":
                    for knob in ("kernel_platform", "mesh_devices"):
                        if knob not in pd:
                            merged.pop(knob, None)
                resolved.append(cls.from_dict(merged))
            d["profiles"] = tuple(resolved)
            names = [d.get("scheduler_name", cls.scheduler_name)] + [
                p.scheduler_name for p in resolved
            ]
            if len(set(names)) != len(names):
                raise ValueError(
                    f"profiles must have distinct scheduler_names: {names}"
                )
        cfg = cls(**d, weights=Weights.from_dict(w) if w else Weights())
        if cfg.mode not in ("batch", "loop"):
            raise ValueError(f"mode must be 'batch' or 'loop', got {cfg.mode!r}")
        if not isinstance(cfg.scheduler_name, str) or not cfg.scheduler_name:
            raise ValueError(
                f"scheduler_name must be a non-empty string, got "
                f"{cfg.scheduler_name!r}"
            )
        if cfg.gang_permit_timeout_s <= 0:
            raise ValueError("gang_permit_timeout_s must be positive")
        if not isinstance(
            cfg.max_metrics_age_s, (int, float)
        ) or isinstance(
            cfg.max_metrics_age_s, bool
        ) or cfg.max_metrics_age_s < 0:
            raise ValueError(
                "max_metrics_age_s must be >= 0 (0 disables staleness "
                f"filtering), got {cfg.max_metrics_age_s!r}"
            )
        if not isinstance(cfg.enable_preemption, bool):
            raise ValueError(
                f"enable_preemption must be a bool, got "
                f"{cfg.enable_preemption!r}"
            )
        if cfg.kernel_device_min_elems is not None and (
            isinstance(cfg.kernel_device_min_elems, bool)
            or not isinstance(cfg.kernel_device_min_elems, int)
            or cfg.kernel_device_min_elems < 1
        ):
            raise ValueError(
                "kernel_device_min_elems must be a positive int or None "
                "(None defers to the batch plugin's threshold), got "
                f"{cfg.kernel_device_min_elems!r}"
            )
        if (
            isinstance(cfg.bind_retry_attempts, bool)
            or not isinstance(cfg.bind_retry_attempts, int)
            or not 0 <= cfg.bind_retry_attempts <= 100
        ):
            raise ValueError(
                "bind_retry_attempts must be an int in [0, 100] (0 "
                f"disables retry), got {cfg.bind_retry_attempts!r}"
            )
        retry_waits = (cfg.bind_retry_base_s, cfg.bind_retry_cap_s)
        if any(
            isinstance(v, bool) or not isinstance(v, (int, float)) or v <= 0
            for v in retry_waits
        ) or not retry_waits[0] <= retry_waits[1]:
            raise ValueError(
                "bind retry backoff must satisfy 0 < bind_retry_base_s "
                f"<= bind_retry_cap_s, got {retry_waits}"
            )
        if not isinstance(cfg.federation_spillover, bool):
            raise ValueError(
                f"federation_spillover must be a bool, got "
                f"{cfg.federation_spillover!r}"
            )
        if not isinstance(cfg.rebalance_preemption, bool):
            raise ValueError(
                f"rebalance_preemption must be a bool, got "
                f"{cfg.rebalance_preemption!r}"
            )
        if not isinstance(cfg.rebalance_elastic, bool):
            raise ValueError(
                f"rebalance_elastic must be a bool, got "
                f"{cfg.rebalance_elastic!r}"
            )
        if (
            isinstance(cfg.percentage_nodes_to_score, bool)
            or not isinstance(cfg.percentage_nodes_to_score, int)
            or not 1 <= cfg.percentage_nodes_to_score <= 100
        ):
            raise ValueError(
                "percentage_nodes_to_score must be an int in [1, 100], got "
                f"{cfg.percentage_nodes_to_score!r}"
            )
        if cfg.scoring_strategy not in ("least-allocated", "most-allocated"):
            raise ValueError(
                "scoring_strategy must be 'least-allocated' or "
                f"'most-allocated', got {cfg.scoring_strategy!r}"
            )
        if cfg.kernel_platform not in ("auto", "cpu", "device"):
            raise ValueError(
                "kernel_platform must be 'auto', 'cpu' or 'device', "
                f"got {cfg.kernel_platform!r}"
            )
        if cfg.kernel_backend not in ("xla", "pallas"):
            raise ValueError(
                f"kernel_backend must be 'xla' or 'pallas', got "
                f"{cfg.kernel_backend!r}"
            )
        if cfg.kernel_backend == "pallas" and cfg.mesh_devices is not None:
            raise ValueError(
                "kernel_backend='pallas' does not support mesh_devices "
                "(the mesh-sharded path is XLA-collective based)"
            )
        if cfg.kernel_backend == "pallas" and cfg.kernel_platform != "auto":
            raise ValueError(
                "kernel_backend='pallas' ignores kernel_platform; leave it "
                "'auto' (the hand kernel runs on the CUDA device)"
            )
        if (
            isinstance(cfg.batch_requests, bool)
            or not isinstance(cfg.batch_requests, int)
            or not 1 <= cfg.batch_requests <= 128
        ):
            raise ValueError(
                "batch_requests must be an int in [1, 128], got "
                f"{cfg.batch_requests!r}"
            )
        if cfg.batch_requests > 1 and cfg.mode != "batch":
            raise ValueError(
                "batch_requests > 1 requires mode='batch' (the fused kernel "
                "is what a burst amortizes)"
            )
        if (
            isinstance(cfg.bind_workers, bool)
            or not isinstance(cfg.bind_workers, int)
            or not 0 <= cfg.bind_workers <= 128
        ):
            raise ValueError(
                f"bind_workers must be an int in [0, 128], got "
                f"{cfg.bind_workers!r}"
            )
        if cfg.bind_pipeline not in ("auto", "on", "off"):
            raise ValueError(
                "bind_pipeline must be 'auto', 'on' or 'off', got "
                f"{cfg.bind_pipeline!r}"
            )
        if cfg.bind_pipeline == "on" and cfg.bind_workers == 0:
            raise ValueError(
                "bind_pipeline='on' requires bind_workers >= 1 (the "
                "pipeline IS the executor)"
            )
        if not isinstance(
            cfg.failover_adopt_window_s, (int, float)
        ) or isinstance(
            cfg.failover_adopt_window_s, bool
        ) or cfg.failover_adopt_window_s < 0:
            raise ValueError(
                "failover_adopt_window_s must be >= 0 (0 = never adopt), "
                f"got {cfg.failover_adopt_window_s!r}"
            )
        if not isinstance(
            cfg.reconcile_period_s, (int, float)
        ) or isinstance(
            cfg.reconcile_period_s, bool
        ) or cfg.reconcile_period_s < 0:
            raise ValueError(
                "reconcile_period_s must be >= 0 (0 disables the "
                f"background reconciler), got {cfg.reconcile_period_s!r}"
            )
        if not isinstance(
            cfg.rebalance_period_s, (int, float)
        ) or isinstance(
            cfg.rebalance_period_s, bool
        ) or cfg.rebalance_period_s < 0:
            raise ValueError(
                "rebalance_period_s must be >= 0 (0 disables the "
                f"background rebalancer), got {cfg.rebalance_period_s!r}"
            )
        if not isinstance(
            cfg.rebalance_min_gain, (int, float)
        ) or isinstance(
            cfg.rebalance_min_gain, bool
        ) or not 0 <= cfg.rebalance_min_gain <= 1:
            raise ValueError(
                "rebalance_min_gain must be in [0, 1], got "
                f"{cfg.rebalance_min_gain!r}"
            )
        if (
            isinstance(cfg.rebalance_max_moves, bool)
            or not isinstance(cfg.rebalance_max_moves, int)
            or cfg.rebalance_max_moves < 0
        ):
            raise ValueError(
                "rebalance_max_moves must be an int >= 0, got "
                f"{cfg.rebalance_max_moves!r}"
            )
        if (
            isinstance(cfg.rebalance_max_victims, bool)
            or not isinstance(cfg.rebalance_max_victims, int)
            or cfg.rebalance_max_victims < 1
        ):
            raise ValueError(
                "rebalance_max_victims must be an int >= 1, got "
                f"{cfg.rebalance_max_victims!r}"
            )
        if not isinstance(cfg.spec_enabled, bool):
            raise ValueError(
                f"spec_enabled must be a bool, got {cfg.spec_enabled!r}"
            )
        if (
            isinstance(cfg.spec_cache_size, bool)
            or not isinstance(cfg.spec_cache_size, int)
            or cfg.spec_cache_size < 1
        ):
            raise ValueError(
                "spec_cache_size must be an int >= 1, got "
                f"{cfg.spec_cache_size!r}"
            )
        if (
            isinstance(cfg.spec_shapes_max, bool)
            or not isinstance(cfg.spec_shapes_max, int)
            or cfg.spec_shapes_max < 1
        ):
            raise ValueError(
                "spec_shapes_max must be an int >= 1, got "
                f"{cfg.spec_shapes_max!r}"
            )
        if not isinstance(cfg.journal_path, str):
            raise ValueError(
                f"journal_path must be a directory path string ('' "
                f"disables the journal), got {cfg.journal_path!r}"
            )
        if cfg.journal_sync not in ("always", "batch", "off"):
            raise ValueError(
                "journal_sync must be 'always', 'batch', or 'off', got "
                f"{cfg.journal_sync!r}"
            )
        if (
            isinstance(cfg.journal_segment_bytes, bool)
            or not isinstance(cfg.journal_segment_bytes, int)
            or cfg.journal_segment_bytes < 4096
        ):
            raise ValueError(
                "journal_segment_bytes must be an int >= 4096, got "
                f"{cfg.journal_segment_bytes!r}"
            )
        node_thresholds = (cfg.node_suspect_after_s, cfg.node_down_after_s)
        if any(
            isinstance(t, bool) or not isinstance(t, (int, float))
            for t in node_thresholds
        ) or not 0 < node_thresholds[0] <= node_thresholds[1]:
            raise ValueError(
                "node health thresholds must satisfy 0 < "
                "node_suspect_after_s <= node_down_after_s, got "
                f"{node_thresholds}"
            )
        if not isinstance(cfg.node_repair, bool):
            raise ValueError(
                f"node_repair must be a bool, got {cfg.node_repair!r}"
            )
        if not isinstance(
            cfg.node_drain_deadline_s, (int, float)
        ) or isinstance(
            cfg.node_drain_deadline_s, bool
        ) or cfg.node_drain_deadline_s < 0:
            raise ValueError(
                "node_drain_deadline_s must be >= 0, got "
                f"{cfg.node_drain_deadline_s!r}"
            )
        if not isinstance(
            cfg.node_health_period_s, (int, float)
        ) or isinstance(
            cfg.node_health_period_s, bool
        ) or cfg.node_health_period_s < 0:
            raise ValueError(
                "node_health_period_s must be >= 0 (0 disables the "
                f"background loop), got {cfg.node_health_period_s!r}"
            )
        thresholds = (
            cfg.federation_degraded_after_s,
            cfg.federation_partitioned_after_s,
            cfg.federation_lost_after_s,
        )
        if any(
            isinstance(t, bool) or not isinstance(t, (int, float))
            for t in thresholds
        ) or not (0 < thresholds[0] <= thresholds[1] <= thresholds[2]):
            raise ValueError(
                "federation health thresholds must satisfy 0 < "
                "degraded_after_s <= partitioned_after_s <= lost_after_s, "
                f"got {thresholds}"
            )
        if not isinstance(
            cfg.federation_probe_period_s, (int, float)
        ) or isinstance(
            cfg.federation_probe_period_s, bool
        ) or cfg.federation_probe_period_s <= 0:
            raise ValueError(
                "federation_probe_period_s must be > 0, got "
                f"{cfg.federation_probe_period_s!r}"
            )
        if not isinstance(
            cfg.trace_sample_rate, (int, float)
        ) or isinstance(
            cfg.trace_sample_rate, bool
        ) or not 0 <= cfg.trace_sample_rate <= 1:
            raise ValueError(
                "trace_sample_rate must be in [0, 1] (0 = tracing off), "
                f"got {cfg.trace_sample_rate!r}"
            )
        if (
            isinstance(cfg.trace_capacity, bool)
            or not isinstance(cfg.trace_capacity, int)
            or cfg.trace_capacity < 16
        ):
            raise ValueError(
                f"trace_capacity must be an int >= 16, got "
                f"{cfg.trace_capacity!r}"
            )
        if not isinstance(cfg.trace_sink, str):
            raise ValueError(
                f"trace_sink must be a path string ('' disables), got "
                f"{cfg.trace_sink!r}"
            )
        if (
            isinstance(cfg.trace_sink_max_bytes, bool)
            or not isinstance(cfg.trace_sink_max_bytes, int)
            or cfg.trace_sink_max_bytes < 0
        ):
            raise ValueError(
                "trace_sink_max_bytes must be an int >= 0 (0 = never "
                f"rotate), got {cfg.trace_sink_max_bytes!r}"
            )
        if not isinstance(cfg.slo_enabled, bool):
            raise ValueError(
                f"slo_enabled must be a bool, got {cfg.slo_enabled!r}"
            )
        if not isinstance(cfg.slo_targets, SloTargets):
            raise ValueError(
                f"slo_targets must resolve to SloTargets, got "
                f"{cfg.slo_targets!r}"
            )
        slo_windows = (
            cfg.slo_starvation_window_s,
            cfg.slo_burn_fast_window_s,
            cfg.slo_burn_slow_window_s,
        )
        if any(
            isinstance(v, bool) or not isinstance(v, (int, float)) or v <= 0
            for v in slo_windows
        ) or not slo_windows[1] <= slo_windows[2]:
            raise ValueError(
                "SLO windows must satisfy slo_starvation_window_s > 0 and "
                "0 < slo_burn_fast_window_s <= slo_burn_slow_window_s, got "
                f"{slo_windows}"
            )
        if not isinstance(
            cfg.slo_burn_threshold, (int, float)
        ) or isinstance(
            cfg.slo_burn_threshold, bool
        ) or cfg.slo_burn_threshold <= 0:
            raise ValueError(
                "slo_burn_threshold must be > 0, got "
                f"{cfg.slo_burn_threshold!r}"
            )
        if (
            isinstance(cfg.immediate_retry_attempts, bool)
            or not isinstance(cfg.immediate_retry_attempts, int)
            or not 0 <= cfg.immediate_retry_attempts <= 1000
        ):
            raise ValueError(
                "immediate_retry_attempts must be an int in [0, 1000], got "
                f"{cfg.immediate_retry_attempts!r}"
            )
        if (
            isinstance(cfg.ingest_batch_max, bool)
            or not isinstance(cfg.ingest_batch_max, int)
            or not 1 <= cfg.ingest_batch_max <= 65536
        ):
            raise ValueError(
                "ingest_batch_max must be an int in [1, 65536], got "
                f"{cfg.ingest_batch_max!r}"
            )
        if not isinstance(
            cfg.ingest_batch_window_ms, (int, float)
        ) or isinstance(
            cfg.ingest_batch_window_ms, bool
        ) or not 0 <= cfg.ingest_batch_window_ms <= 10_000:
            raise ValueError(
                "ingest_batch_window_ms must be in [0, 10000] (0 = "
                "per-event delivery, batching off), got "
                f"{cfg.ingest_batch_window_ms!r}"
            )
        if not isinstance(cfg.tenant_fairness, bool):
            raise ValueError(
                f"tenant_fairness must be a bool, got "
                f"{cfg.tenant_fairness!r}"
            )
        if (
            isinstance(cfg.tenant_quota_chips, bool)
            or not isinstance(cfg.tenant_quota_chips, int)
            or cfg.tenant_quota_chips < 0
        ):
            raise ValueError(
                "tenant_quota_chips must be an int >= 0 (0 = unlimited), "
                f"got {cfg.tenant_quota_chips!r}"
            )
        if not isinstance(
            cfg.tenant_quota_hbm_gib, (int, float)
        ) or isinstance(
            cfg.tenant_quota_hbm_gib, bool
        ) or cfg.tenant_quota_hbm_gib < 0:
            raise ValueError(
                "tenant_quota_hbm_gib must be >= 0 (0 = unlimited), got "
                f"{cfg.tenant_quota_hbm_gib!r}"
            )
        if (
            cfg.tenant_quota_chips or cfg.tenant_quota_hbm_gib
        ) and not cfg.tenant_fairness:
            raise ValueError(
                "tenant_quota_* requires tenant_fairness: true (quotas "
                "are enforced by the tenant-aware queue)"
            )
        if (
            isinstance(cfg.shard_count, bool)
            or not isinstance(cfg.shard_count, int)
            or not 1 <= cfg.shard_count <= 64
        ):
            raise ValueError(
                "shard_count must be an int in [1, 64] (1 = single serve "
                f"loop, sharding off), got {cfg.shard_count!r}"
            )
        if cfg.shard_count > 1 and cfg.profiles:
            raise ValueError(
                "shard_count > 1 is incompatible with profiles (every "
                "shard serves the base profile; run profiles unsharded)"
            )
        if cfg.shard_mode not in ("thread", "process"):
            raise ValueError(
                "shard_mode must be 'thread' or 'process', got "
                f"{cfg.shard_mode!r}"
            )
        for knob in ("commit_listen", "commit_endpoint"):
            v = getattr(cfg, knob)
            if not isinstance(v, str):
                raise ValueError(
                    f"{knob} must be a string endpoint ('host:port' or "
                    f"a socket path), got {v!r}"
                )
        if cfg.commit_listen:
            host, sep, port = cfg.commit_listen.rpartition(":")
            if not sep or not host or not port.isdigit():
                raise ValueError(
                    "commit_listen must be 'host:port' (the TCP commit "
                    f"transport listen endpoint), got {cfg.commit_listen!r}"
                )
        if cfg.mesh_devices is not None and (
            isinstance(cfg.mesh_devices, bool)
            or not isinstance(cfg.mesh_devices, int)
            or cfg.mesh_devices < 1
        ):
            raise ValueError(
                f"mesh_devices must be a positive int, got {cfg.mesh_devices!r}"
            )
        for knob in (
            "overload_period_s",
            "overload_cycle_ms_high",
            "overload_step_down_hold_s",
        ):
            v = getattr(cfg, knob)
            if isinstance(v, bool) or not isinstance(v, (int, float)) or v < 0:
                raise ValueError(
                    f"{knob} must be >= 0 (0 disables it), got {v!r}"
                )
        for knob in ("overload_queue_high", "overload_ingest_high"):
            v = getattr(cfg, knob)
            if isinstance(v, bool) or not isinstance(v, int) or v < 0:
                raise ValueError(
                    f"{knob} must be an int >= 0 (0 disables the signal), "
                    f"got {v!r}"
                )
        if isinstance(
            cfg.overload_brownout_admit_per_s, bool
        ) or not isinstance(
            cfg.overload_brownout_admit_per_s, (int, float)
        ) or cfg.overload_brownout_admit_per_s <= 0:
            raise ValueError(
                "overload_brownout_admit_per_s must be > 0, got "
                f"{cfg.overload_brownout_admit_per_s!r}"
            )
        if isinstance(cfg.overload_shed_priority, bool) or not isinstance(
            cfg.overload_shed_priority, int
        ):
            raise ValueError(
                "overload_shed_priority must be an int (pods at or above "
                f"it are never shed), got {cfg.overload_shed_priority!r}"
            )
        if (
            isinstance(cfg.pending_index_max, bool)
            or not isinstance(cfg.pending_index_max, int)
            or cfg.pending_index_max < 16
        ):
            raise ValueError(
                f"pending_index_max must be an int >= 16, got "
                f"{cfg.pending_index_max!r}"
            )
        return cfg

    def diff(self, new: "SchedulerConfig") -> "dict[str, str]":
        """Changed knobs between this config and ``new``, each mapped to
        its reload class (:func:`classify_knob`) — the hot-reload
        surface's decision table: ``reloadable`` knobs apply live via
        ``standalone.apply_reloadable``, ``resize`` goes through
        ``ShardSet.resize``, ``requires-drain`` / ``immutable`` are
        reported and kept at their old values."""
        out: dict[str, str] = {}
        for f in fields(self):
            if getattr(self, f.name) != getattr(new, f.name):
                out[f.name] = classify_knob(f.name)
        return out

    def effective_weights(self) -> Weights:
        """The weights the score path actually runs with: under
        "most-allocated" the free-leaning terms are negated (a fuller node
        scores higher), while hardware-quality terms (bandwidth, clock,
        tflops, power, total HBM) and the slice-protect tier keep their
        sign. User-facing weights stay non-negative (Weights.from_dict);
        the sign is strategy-owned."""
        if self.scoring_strategy != "most-allocated":
            return self.weights
        from dataclasses import replace

        w = self.weights
        return replace(
            w, hbm_free=-w.hbm_free, actual=-w.actual, allocate=-w.allocate
        )
