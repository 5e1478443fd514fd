"""Fault-injection harness: deterministic, replayable failure schedules.

The reference plugin was verified by deploying it and watching (SURVEY.md
§4); its failure story is "the framework retries the pod". This harness
exists to PROVE the recovery machinery this repo adds — transactional gang
bind rollback, transient-error bind retry, the kernel dispatch fallback
chain, watch 410 relist — by injecting the failures production actually
produces, on a seeded schedule a test can replay exactly:

- ``ChaosPlan``: the schedule. Either an explicit list of ``FaultSpec``
  (op, invocation index, kind, consecutive count) or ``ChaosPlan.seeded``
  — the same seed always generates the same plan, and ``plan.fired``
  records what actually triggered, so a failing run's log IS its repro.
- ``ChaosCluster``: wraps a ``FakeCluster``; injects bind conflicts
  (409-status errors, duck-typing ``KubeApiError`` for the retry
  classifier), transient timeouts, unbind failures, dropped agent
  publishes, and metric staleness (backdated ``last_updated_unix``).
- ``ChaosKernel``: wraps any ``FleetKernelLike``; injects kernel dispatch
  exceptions (the launch-failure class). Only the PRIMARY kernel is
  wrapped, so on a host primary YodaBatch's fallback chain demotes to
  healthy backends — exactly the path the tests assert; on a card primary
  the fault is counted and re-raised, never demoted.
- ``maybe_drop_watch``: consumes a scheduled "watch" fault by compacting
  a ``FakeKubeApiServer``'s event window, killing open watch streams with
  410 Gone (forcing the client's relist-and-resync).

Ops recognized by the built-in wrappers: ``bind``, ``unbind``,
``metrics``, ``dispatch``, ``watch``, ``crash``, ``cluster_partition``,
``cluster_loss``, ``journal`` (disk faults against the durable claim
journal, consumed by ``FaultyJournalIO``), and the multi-host control
plane ops ``rpc_partition`` / ``rpc_slow`` (commit-transport faults,
consumed by :func:`maybe_rpc_fault` against a :class:`ChaosTcpProxy`)
and ``parent_kill`` (the sweep SIGKILLs the live parent and promotes
the tailing standby). Each retry of a faulted call counts as a fresh
invocation — a ``count=1`` bind conflict fails once and the binder's
first retry succeeds; ``count > retry budget`` forces the genuine-failure
path (gang rollback).

The ``cluster_partition`` / ``cluster_loss`` ops are the **federation
fault modes** (multi-cluster PR): while a ChaosCluster front is
partitioned, every scheduler-side read and write through it raises
:class:`ChaosTimeout` (retryable — the transport signature of a real
partition) and every watch event is dropped in transit, so cluster truth
and the scheduler's caches diverge for the whole window; ``heal()`` ends
a partition and the federation's rejoin path (health monitor transition →
reconciler resync) re-converges the state. ``cluster_loss`` is the
permanent form. Consumed via :func:`maybe_cluster_fault` at points the
sweep chooses, so the fault schedule stays seeded and replayable.

The ``crash`` op is the **scheduler_crash mode** (crash-safe failover
PR): a scheduled crash fault fires on the Nth bind call and kills the
"process" — kind ``after_bind`` lands the bind first (the worst case: the
dead leader's write reached the API but nothing in-memory survives),
``before_bind`` dies just before the write. From that point EVERY write
through this ChaosCluster raises :class:`SchedulerCrashed` (a dead
process makes no API calls) and ``on_crash`` fires (tests wire the serve
loop's stop event). The promoted standby is modeled by
:meth:`ChaosCluster.respawn` — a fresh front over the SAME backing
cluster — plus a fresh ``build_stack`` whose warm-start resync
(framework/reconciler.py) must then recover the half-bound state.

Counterpart of ``yoda_tpu/testing/chaos.py`` over the port's modules,
every import at call time as there. A scheduled ``dispatch`` fault
raises from the primary kernel's evaluation. On a primary on the host
(``kernel_platform: cpu``) the batch plugin's dispatch chain demotes that
dispatch to the plain version on a host copy (then to the numpy
evaluator), counted in ``dispatch_errors`` and ``dispatch_fallbacks``, as
in the reference. Two differences: on a primary on the card the fault is
counted in ``dispatch_errors`` and re-raised, never demoted (the cycle
ends in error and the pod is retried); and
:class:`DriveWorker` takes a ``device`` (a
``kernel_platform`` value: "auto", the default, is the card and raises
without one; "cpu" is how a caller asks for the host) and spawns the
port's worker entry with it. ``ChaosCluster.probe`` (the federation
health monitor's) reaches the inner cluster's ``probe`` where it has one.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field

# Backdate applied by the "stale" metrics fault — far past any reasonable
# max_metrics_age_s, so the staleness gate trips deterministically.
STALE_BACKDATE_S = 3600.0

_DEFAULT_KINDS = {
    "bind": ("conflict", "timeout"),
    "unbind": ("timeout",),
    "metrics": ("stale", "drop"),
    "dispatch": ("error",),
    "watch": ("drop",),
    "crash": ("after_bind", "before_bind"),
    # Federation fault modes (multi-cluster PR): a scheduled
    # cluster_partition fault partitions the scheduler from one cluster
    # front (every scheduler-side read/write times out, every watch event
    # is lost in transit) until the sweep heals it; cluster_loss is the
    # permanent version. Consumed via maybe_cluster_fault.
    "cluster_partition": ("partition",),
    "cluster_loss": ("loss",),
    # Node failure modes (node health PR, yoda_tpu/nodehealth): consumed
    # via maybe_node_fault against a FakeTpuAgent + cluster pair.
    # node_death deletes the host's TPU CR and Node object (cloud node
    # deletion); heartbeat_stop silences the agent — kind "stop" is
    # permanent until the sweep resumes it, "flap" signals the sweep to
    # resume it within the debounce window (the flapping-heartbeat case
    # the SUSPECT debounce exists for); chip_degrade marks chips
    # Unhealthy while the host stays alive (ladder: DEGRADED).
    "node_death": ("death",),
    "heartbeat_stop": ("stop", "flap"),
    "chip_degrade": ("degrade",),
    # Scheduler shard-out fault mode (cross_shard_contention, ISSUE 14):
    # a scheduled shard_crash fault kills the whole sharded "process" on
    # its Nth bind — kind mid_commit lands the bind FIRST (the worst
    # case: a gang's member binds reached the API, the staged claims and
    # the pending commit die with the process) — and the sweep respawns
    # a fresh ShardSet over the same backing cluster whose global-lane
    # resync (PR 5) must recover the half-committed state. Mechanically
    # this rides the crash machinery (ChaosCluster._maybe_crash).
    "shard_crash": ("mid_commit",),
    # Multi-host control plane fault modes (ISSUE 20): rpc_partition is
    # the HALF-OPEN network failure against the TCP commit transport —
    # via ChaosTcpProxy, established connections silently stop carrying
    # bytes (reads hang until the client's deadline fires; nothing
    # refuses, nothing resets — the transport signature of a dropped
    # path or a dead NIC), until the sweep heals it. rpc_slow stretches
    # every forwarded chunk by a delay (the degraded-link case backoff
    # and deadlines must ride out). parent_kill SIGKILLs the live
    # parent at a frame chosen by the plan — the sweep then promotes
    # the tailing standby and asserts the term fence against the old
    # parent's lingering socket. Consumed via maybe_rpc_fault (proxy
    # modes) and directly by the sweep (parent_kill).
    "rpc_partition": ("half_open",),
    "rpc_slow": ("latency",),
    "parent_kill": ("sigkill",),
    # Journal disk-fault mode (durable claim journal, ISSUE 18):
    # consumed by FaultyJournalIO, one invocation per journal append.
    # short_write leaves a torn frame on disk (the journal fail-stops;
    # recovery truncate-repairs the tail); fsync_error is the device
    # refusing durability (fail-stop, nothing torn); crash_after_append
    # dies AFTER the record is durable but BEFORE the accountant learns
    # — the worst case: the replayed journal knows a claim the dead
    # process's memory never held, and the promoted standby must adopt
    # it without double-binding.
    "journal": ("short_write", "fsync_error", "crash_after_append"),
}


class ChaosApiError(Exception):
    """Injected API error carrying an HTTP-ish ``status`` — duck-types
    ``cluster.kube.KubeApiError`` for ``cluster.retry.retryable_api_error``
    without importing kube internals into every test."""

    def __init__(self, status: int, message: str) -> None:
        super().__init__(f"chaos HTTP {status}: {message}")
        self.status = status


class ChaosTimeout(TimeoutError):
    """Injected transport timeout (retryable by classification)."""


class SchedulerCrashed(RuntimeError):
    """The scheduler "process" died (scheduler_crash mode): the API write
    that triggered the crash — and every write after it — fails with
    this. Non-retryable by classification, so the dying instance's own
    retry/rollback machinery cannot clean up after its death, exactly as
    a real crash leaves the cluster."""


def make_error(kind: str, detail: str) -> Exception:
    if kind == "conflict":
        return ChaosApiError(409, f"injected conflict: {detail}")
    if kind == "timeout":
        return ChaosTimeout(f"chaos: injected timeout: {detail}")
    return RuntimeError(f"chaos: injected failure ({kind}): {detail}")


@dataclass(frozen=True)
class FaultSpec:
    """Fire on invocations ``at .. at+count-1`` (0-based) of ``op``."""

    op: str
    at: int
    kind: str
    count: int = 1


class ChaosPlan:
    """A deterministic fault schedule plus the record of what fired.

    Thread-safe: the scheduler's permit-release pool may drive wrapped
    calls concurrently, and each call must consume exactly one invocation
    index."""

    def __init__(self, faults: "tuple[FaultSpec, ...] | list" = (), *, seed: int | None = None) -> None:
        self.seed = seed
        self.faults = tuple(faults)
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        # (op, invocation index, kind) triples, in firing order — a
        # failing chaos run's exact repro script.
        self.fired: list[tuple[str, int, str]] = []
        self._by_op: dict[str, dict[int, FaultSpec]] = {}
        for f in self.faults:
            slots = self._by_op.setdefault(f.op, {})
            for i in range(f.at, f.at + max(f.count, 1)):
                slots.setdefault(i, f)

    @classmethod
    def seeded(
        cls,
        seed: int,
        *,
        ops: "tuple[str, ...]" = ("bind", "dispatch"),
        horizon: int = 40,
        rate: float = 0.2,
        kinds_by_op: "dict[str, tuple[str, ...]] | None" = None,
    ) -> "ChaosPlan":
        """A random-but-replayable plan: the same seed ALWAYS yields the
        same schedule (random.Random(seed), op-ordered draw sequence).
        ``rate`` is the per-invocation fault probability over the first
        ``horizon`` invocations of each op."""
        rng = random.Random(seed)
        faults: list[FaultSpec] = []
        for op in ops:
            kinds = (kinds_by_op or {}).get(op) or _DEFAULT_KINDS.get(
                op, ("error",)
            )
            for at in range(horizon):
                if rng.random() < rate:
                    faults.append(
                        FaultSpec(op=op, at=at, kind=rng.choice(list(kinds)))
                    )
        return cls(faults, seed=seed)

    def next(self, op: str) -> "FaultSpec | None":
        """Consume one invocation of ``op``; the scheduled fault, if any."""
        with self._lock:
            i = self._counts.get(op, 0)
            self._counts[op] = i + 1
            f = self._by_op.get(op, {}).get(i)
            if f is not None:
                self.fired.append((op, i, f.kind))
            return f

    def has_op(self, op: str) -> bool:
        """Whether any fault is scheduled for ``op`` — wrappers with an
        opt-in op (crash) skip consuming invocation indices when the plan
        never schedules it, keeping other ops' indices stable."""
        return op in self._by_op

    def invocations(self, op: str) -> int:
        with self._lock:
            return self._counts.get(op, 0)


class ChaosCluster:
    """A ``FakeCluster`` front that injects faults per plan; every other
    attribute delegates, so ``standalone.build_stack`` and the agents run
    unchanged against it."""

    def __init__(self, inner=None, plan: "ChaosPlan | None" = None) -> None:
        from yoda_tpu_torch.cluster.fake import FakeCluster

        self._inner = inner if inner is not None else FakeCluster()
        self.plan = plan if plan is not None else ChaosPlan()
        # scheduler_crash mode: set when a scheduled "crash" fault fires;
        # from then on every write through THIS front raises
        # SchedulerCrashed. on_crash (tests wire the serve loop's stop
        # event) fires exactly once, before the triggering call raises.
        self.crashed = threading.Event()
        self.on_crash = None  # Callable[[], None] | None
        # cluster_partition / cluster_loss modes (federation PR): while
        # either is set, every scheduler-side read/write through this
        # front raises ChaosTimeout (retryable — exactly what a real
        # network partition produces) and every watch event is DROPPED in
        # transit: the inner store (cluster truth) keeps moving, the
        # scheduler's caches go silent and stale, and only a rejoin
        # resync re-converges them. Loss is partition made permanent.
        self._partitioned = threading.Event()
        self.lost = threading.Event()
        self.dropped_events = 0
        # original fn -> partition-gate wrapper (remove_watcher needs
        # the mapping: callers unregister by the fn they registered).
        self._gated_watchers: dict = {}

    def __getattr__(self, name: str):
        return getattr(self._inner, name)

    @property
    def inner(self):
        """The backing cluster — tests play EXTERNAL actors (users,
        controllers, node agents on the far side of the partition)
        through this; the partition severs only the scheduler's path."""
        return self._inner

    # --- partition / loss controls ---

    @property
    def partitioned(self) -> bool:
        return self._partitioned.is_set() or self.lost.is_set()

    def partition(self) -> None:
        """Sever the scheduler from this cluster front (heal() restores)."""
        self._partitioned.set()

    def heal(self) -> None:
        """End a partition. A LOST cluster stays lost — loss is the
        permanent failure mode (clear ``lost`` manually to model a
        rebuilt cluster)."""
        self._partitioned.clear()

    def lose(self) -> None:
        """Permanently sever the cluster (cluster_loss mode)."""
        self.lost.set()

    def _check_partition(self, detail: str) -> None:
        if self.partitioned:
            raise ChaosTimeout(f"chaos: cluster partitioned: {detail}")

    def add_watcher(self, fn, *, replay: bool = True, batch_fn=None) -> None:
        """Register ``fn`` behind the partition gate: events raised while
        partitioned/lost are dropped in transit (counted), exactly as a
        severed watch stream loses them — the drift the rejoin resync
        must repair. Batch deliveries (the ingest pipeline's list
        plumbing) are gated whole: a partitioned stream loses the entire
        run in transit."""

        def gated(event) -> None:
            if self.partitioned:
                self.dropped_events += 1
                return
            fn(event)

        gated_batch = None
        if batch_fn is not None:

            def gated_batch(events) -> None:
                if self.partitioned:
                    self.dropped_events += len(events)
                    return
                batch_fn(events)

        self._gated_watchers[fn] = gated
        self._inner.add_watcher(gated, replay=replay, batch_fn=gated_batch)

    def remove_watcher(self, fn) -> None:
        """Unregister by the ORIGINAL fn (the gate wrapper is internal)."""
        gated = self._gated_watchers.pop(fn, None)
        remove = getattr(self._inner, "remove_watcher", None)
        if gated is not None and remove is not None:
            remove(gated)

    def probe(self) -> None:
        """The health monitor's probe: times out while partitioned/lost
        (transient by classification — silence, not refusal), else
        delegates to the inner cluster's probe."""
        self._check_partition("probe")
        inner_probe = getattr(self._inner, "probe", None)
        if inner_probe is not None:
            inner_probe()

    # --- scheduler-side reads (partitioned reads time out too) ---

    def list_pods(self):
        self._check_partition("list pods")
        return self._inner.list_pods()

    def get_pod(self, pod_key: str):
        self._check_partition(f"get {pod_key}")
        return self._inner.get_pod(pod_key)

    def list_tpu_metrics(self):
        self._check_partition("list tpunodemetrics")
        return self._inner.list_tpu_metrics()

    def create_pod(self, pod):
        self._check_partition(f"create {pod.key}")
        return self._inner.create_pod(pod)

    def delete_pod(self, pod_key: str) -> None:
        self._check_partition(f"delete {pod_key}")
        return self._inner.delete_pod(pod_key)

    def respawn(self, plan: "ChaosPlan | None" = None) -> "ChaosCluster":
        """A fresh front over the SAME backing cluster — the promoted
        standby's API connection after the old leader crashed. Builds a
        new stack against this (build_stack registers fresh watchers on
        the shared inner cluster) and run the warm-start resync."""
        return ChaosCluster(inner=self._inner, plan=plan or ChaosPlan())

    # --- faulted surfaces ---

    def _check_alive(self, detail: str) -> None:
        if self.crashed.is_set():
            raise SchedulerCrashed(f"scheduler process is dead: {detail}")

    def _maybe_crash(self, pod_key: str, node_name: str) -> None:
        op = None
        if self.plan.has_op("crash"):
            op = "crash"
        elif self.plan.has_op("shard_crash"):
            # cross_shard_contention mode: same crash machinery, sharded
            # flavor — mid_commit lands the bind first, so the staged
            # claims and the pending shard commit die with the process
            # while the write survives on the cluster.
            op = "shard_crash"
        if op is None:
            return
        f = self.plan.next(op)
        if f is None:
            return
        if f.kind in ("after_bind", "mid_commit"):
            # The write reached the API; the process died before the
            # result could update any in-memory state.
            self._inner.bind_pod(pod_key, node_name)
        self.crashed.set()
        cb = self.on_crash
        if cb is not None:
            cb()
        raise SchedulerCrashed(
            f"injected crash at bind {pod_key} -> {node_name} ({f.kind})"
        )

    def bind_pod(self, pod_key: str, node_name: str) -> None:
        self._check_alive(f"bind {pod_key}")
        self._check_partition(f"bind {pod_key}")
        self._maybe_crash(pod_key, node_name)
        f = self.plan.next("bind")
        if f is not None:
            raise make_error(f.kind, f"bind {pod_key} -> {node_name}")
        return self._inner.bind_pod(pod_key, node_name)

    def unbind_pod(self, pod_key: str, node_name: str) -> None:
        self._check_alive(f"unbind {pod_key}")
        self._check_partition(f"unbind {pod_key}")
        f = self.plan.next("unbind")
        if f is not None:
            raise make_error(f.kind, f"unbind {pod_key} from {node_name}")
        return self._inner.unbind_pod(pod_key, node_name)

    def evict_pod(self, pod_key: str) -> bool:
        # Scheduler-originated write (preemption): dead processes evict
        # nothing. External actors (tests playing the user/controller)
        # use delete_pod on the inner cluster, which stays live.
        self._check_alive(f"evict {pod_key}")
        self._check_partition(f"evict {pod_key}")
        return self._inner.evict_pod(pod_key)

    def set_nominated_node(self, pod_key: str, node_name) -> None:
        self._check_alive(f"nominate {pod_key}")
        self._check_partition(f"nominate {pod_key}")
        return self._inner.set_nominated_node(pod_key, node_name)

    def put_tpu_metrics(self, tpu) -> None:
        f = self.plan.next("metrics")
        if f is not None:
            if f.kind == "drop":
                return  # publish lost in transit: the CR simply ages
            if f.kind == "stale":
                # Agent clock skew / scrape stall: the CR lands already
                # ancient, tripping any max_metrics_age_s gate.
                tpu.last_updated_unix -= STALE_BACKDATE_S
        return self._inner.put_tpu_metrics(tpu)


class ChaosKernel:
    """Wraps a ``FleetKernelLike``; scheduled "dispatch" faults raise from
    every evaluate path (the launch-failure class: a CUDA error, a refused
    launch). Like the reference's, it has no ``evaluate_joint_plan``: a
    fused plain-gang pass through it raises ``AttributeError``, which the
    batch plugin's dispatch chain on a host primary demotes as it demotes a
    failed launch, without drawing from the plan (a card primary re-raises
    it)."""

    def __init__(self, inner, plan: ChaosPlan) -> None:
        self._inner = inner
        self.plan = plan

    @property
    def names(self):
        return self._inner.names

    def put_static(self, arrays) -> None:
        self._inner.put_static(arrays)

    def _maybe_fail(self, what: str) -> None:
        f = self.plan.next("dispatch")
        if f is not None:
            raise make_error(f.kind, f"kernel {what} dispatch")

    def evaluate(self, dyn, request):
        self._maybe_fail("evaluate")
        return self._inner.evaluate(dyn, request)

    def evaluate_burst(self, dyn, host_ok_k, requests):
        self._maybe_fail("burst")
        return self._inner.evaluate_burst(dyn, host_ok_k, requests)

    def evaluate_joint(self, dyn, host_ok_groups, request_groups, minimum=1):
        self._maybe_fail("joint")
        if hasattr(self._inner, "evaluate_joint"):
            return self._inner.evaluate_joint(
                dyn, host_ok_groups, request_groups, minimum
            )
        from yoda_tpu_torch.ops.kernel import evaluate_joint_via_burst

        return evaluate_joint_via_burst(
            self._inner, dyn, host_ok_groups, request_groups, minimum
        )

    def update_rows(self, arrays, rows) -> None:
        # Incremental static refresh is not an evaluate: faults target
        # dispatches, so the row update passes through (kernels without
        # the method fall back to put_static upstream).
        if hasattr(self._inner, "update_rows"):
            self._inner.update_rows(arrays, rows)
        else:
            self._inner.put_static(arrays)


def install_chaos_kernel(batch_plugin, plan: ChaosPlan) -> ChaosKernel:
    """Wrap ``batch_plugin``'s PRIMARY kernel with a ``ChaosKernel``. The
    fallback levels (the plain version on the host, the numpy evaluator)
    are not wrapped — dispatch faults prove the demotion path, they don't
    sabotage it. The port's batch plugin builds its primary kernel at
    construction, so the wrapper installs before the first cycle too."""
    inner = batch_plugin._kern
    if inner is None:
        raise RuntimeError(
            "batch plugin has no kernel yet — build it before installing "
            "the chaos kernel"
        )
    wrapped = ChaosKernel(inner, plan)
    batch_plugin._kern = wrapped
    # The device-resident state cache (ops/resident.py) holds its own
    # kernel reference and re-publishes it to the plugin on every sync —
    # wrap it there too, or the next cycle would silently unwrap.
    resident = getattr(batch_plugin, "_resident", None)
    if resident is not None and resident.kern is inner:
        resident.kern = wrapped
    return wrapped


class FaultyJournalIO:
    """A ``journal.RealJournalIO`` front that injects disk faults per
    plan (op ``journal``, one invocation per append — the ``write`` call
    draws the fault and pins its kind for the rest of that append's
    ops):

    - ``short_write`` writes half the frame and reports the short count;
      the journal detects it, fail-stops, and leaves a TORN frame on
      disk for recovery to truncate-repair.
    - ``fsync_error`` raises from fsync — the device refused durability,
      the journal fail-stops with a clean tail. Only observable when the
      append's sync policy actually fsyncs (use ``journal_sync=always``
      in sweeps that schedule it).
    - ``crash_after_append`` raises from ``ack()``: the record IS
      durable but the caller dies before learning so — the in-memory
      mutation never applies, and only the standby's replay knows the
      claim existed. The double-bind trap the warm resync must not fall
      into.
    """

    def __init__(self, plan: ChaosPlan, inner=None) -> None:
        from yoda_tpu_torch.journal import RealJournalIO

        self.plan = plan
        self.inner = inner if inner is not None else RealJournalIO()
        self._pending: "str | None" = None

    def write(self, fobj, data: bytes) -> int:
        self._pending = None
        if self.plan.has_op("journal"):
            f = self.plan.next("journal")
            if f is not None:
                self._pending = f.kind
        if self._pending == "short_write":
            self._pending = None
            n = len(data) // 2
            self.inner.write(fobj, data[:n])
            return n
        return self.inner.write(fobj, data)

    def flush(self, fobj) -> None:
        self.inner.flush(fobj)

    def fsync(self, fobj) -> None:
        if self._pending == "fsync_error":
            self._pending = None
            raise OSError("chaos: injected fsync failure")
        self.inner.fsync(fobj)

    def ack(self) -> None:
        if self._pending == "crash_after_append":
            from yoda_tpu_torch.journal import JournalFault

            self._pending = None
            raise JournalFault(
                "chaos: process crashed between append and ack"
            )
        self.inner.ack()


def maybe_cluster_fault(plan: ChaosPlan, cluster: ChaosCluster) -> "str | None":
    """Consume one invocation each of the federation cluster-fault ops
    against ``cluster`` (a ChaosCluster front). A scheduled
    ``cluster_partition`` fault partitions the front (the sweep heals it
    on its own schedule); a scheduled ``cluster_loss`` fault severs it
    permanently. Returns which op fired ("cluster_partition" /
    "cluster_loss") or None. Ops never scheduled by the plan do not
    consume invocation indices (``has_op``), keeping other ops' indices
    stable — same discipline as the crash op."""
    if plan.has_op("cluster_loss"):
        f = plan.next("cluster_loss")
        if f is not None:
            cluster.lose()
            return "cluster_loss"
    if plan.has_op("cluster_partition"):
        f = plan.next("cluster_partition")
        if f is not None:
            cluster.partition()
            return "cluster_partition"
    return None


def maybe_node_fault(
    plan: ChaosPlan, agent, cluster, *, nodes=None
) -> "list[tuple[str, str, str]]":
    """Consume one invocation each of the node-failure ops against the
    fleet ``agent`` (a FakeTpuAgent) publishes into ``cluster``. Target
    choice is deterministic: invocation index i of an op strikes
    ``sorted(nodes)[i % len]`` — the same seed always kills the same
    hosts in the same order, so a failing sweep's log IS its repro.
    Returns the fired ``(op, kind, node)`` triples; the sweep uses them
    to resume "flap" heartbeats inside the debounce window and to know
    which nodes are genuinely dead. Ops never scheduled by the plan do
    not consume invocation indices (``has_op``), keeping other ops'
    indices stable — the crash-op discipline."""
    fired: list[tuple[str, str, str]] = []
    for op in ("node_death", "heartbeat_stop", "chip_degrade"):
        if not plan.has_op(op):
            continue
        # Recomputed per op: an earlier op this call may have removed a
        # host, and striking a ghost would crash the sweep.
        pool = nodes if nodes is not None else agent._hosts
        targets = sorted(n for n in pool if n in agent._hosts)
        if not targets:
            continue
        i = plan.invocations(op)
        f = plan.next(op)
        if f is None:
            continue
        name = targets[i % len(targets)]
        if op == "node_death":
            agent.remove_host(name)  # deletes the TPU CR
            delete_node = getattr(cluster, "delete_node", None)
            if delete_node is not None:
                delete_node(name)
        elif op == "heartbeat_stop":
            agent.stop_heartbeat(name)
        else:
            agent.fail_chips(name, [0])
        fired.append((op, f.kind, name))
    return fired


def build_cross_shard_contention(
    seed: int,
    *,
    shards: int = 2,
    contended_slices: int = 1,
    slice_topology: "tuple[int, int, int]" = (2, 2, 1),
    hosts: int = 2,
    chips: int = 8,
    plan: "ChaosPlan | None" = None,
    config=None,
    bind_latency_s: float = 0.0,
):
    """The ``cross_shard_contention`` chaos mode (scheduler shard-out,
    ISSUE 14): a ShardSet over a ChaosCluster whose contended slice(s)
    are pinned into EVERY shard's partition — the stale-shard-map window
    a live rendezvous rebalance opens, held open — so seeded arrival
    streams steer two shards' placements at the same ICI block and the
    accountant's optimistic claim->validate->commit is the only thing
    between them and a double-booked host. Returns ``(shard_set, agent,
    contended)``: drive arrivals with :func:`contention_stream`, crash
    the "process" mid-commit with a scheduled ``shard_crash`` fault, and
    respawn via a fresh ``build_sharded_stacks`` over
    ``shard_set.global_stack.cluster.respawn()``.

    Fleet: ``contended_slices`` v5p slices (every shard sees them) plus
    ``hosts`` v5e singleton hosts of ``chips`` chips (rendezvous-owned,
    for background singleton traffic)."""
    from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.framework.shards import ShardMap
    from yoda_tpu_torch.standalone import build_sharded_stacks

    config = config or SchedulerConfig(
        shard_count=shards, batch_requests=8
    )
    overlap = {
        f"v5p-{i}": tuple(range(shards))
        for i in range(contended_slices)
    }
    from yoda_tpu_torch.cluster.fake import FakeCluster

    shard_map = ShardMap(config.shard_count, overlap=overlap)
    # Bind latency must sit on the inner cluster BEFORE the stacks are
    # built: the bind-pipeline auto decision reads it at assembly time,
    # and the latency IS the stage->commit window the mid-commit faults
    # need open.
    cluster = ChaosCluster(
        inner=FakeCluster(bind_latency_s=bind_latency_s),
        plan=plan or ChaosPlan(seed=seed),
    )
    shard_set = build_sharded_stacks(
        cluster=cluster, config=config, shard_map=shard_map
    )
    agent = FakeTpuAgent(cluster)
    for i in range(contended_slices):
        agent.add_slice(
            f"v5p-{i}", generation="v5p", host_topology=slice_topology
        )
    for i in range(hosts):
        agent.add_host(f"h{i}", generation="v5e", chips=chips)
    agent.publish_all()
    return shard_set, agent, sorted(overlap)


def contention_stream(
    seed: int,
    round_idx: int,
    *,
    gangs: int = 2,
    singles: int = 2,
    topology: str = "2x2",
    chips: int = 4,
):
    """One round of the seeded arrival stream for the contention sweep:
    ``gangs`` topology gangs whose names are CHOSEN so the router spreads
    them across different shards (steering both serve loops at the
    contended slice set) plus ``singles`` background singletons. Same
    seed + round -> same pods, so a failing sweep's log is its repro.
    Returns a list of PodSpec."""
    import random as _random

    from yoda_tpu_torch.api.types import PodSpec

    rng = _random.Random((seed << 16) ^ round_idx)
    pods = []
    base = rng.randrange(1 << 30)
    for g in range(gangs):
        tag = f"r{round_idx}-g{base + g}"
        for m in range(4):
            pods.append(
                PodSpec(
                    f"{tag}-{m}",
                    labels={
                        "tpu/gang": tag,
                        "tpu/topology": topology,
                        "tpu/chips": str(chips),
                    },
                )
            )
    for s in range(singles):
        pods.append(
            PodSpec(
                f"r{round_idx}-p{base + s}",
                labels={"tpu/chips": str(chips)},
            )
        )
    return pods


def build_overload_storm(
    seed: int,
    *,
    hosts: int = 4,
    chips: int = 8,
    queue_high: int = 8,
    step_down_hold_s: float = 10.0,
    config=None,
):
    """The ``overload_storm`` chaos mode (ISSUE 15): a single stack on a
    virtual clock whose overload ladder is tuned to engage under the
    seeded flood :func:`storm_stream` produces — the sweep drives rounds
    of prod trickle + spot flood, ticks the monitor at explicit virtual
    times, and asserts the ladder's contract: prod keeps binding, spot
    sheds (never drops), everything binds after the storm. Returns
    ``(stack, agent, clock)``."""
    from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent
    from yoda_tpu_torch.config import SchedulerConfig
    from yoda_tpu_torch.standalone import build_stack
    from yoda_tpu_torch.testing.tracegen import ReplayClock

    clock = ReplayClock()
    config = config or SchedulerConfig(
        batch_requests=8,
        overload_queue_high=queue_high,
        overload_step_down_hold_s=step_down_hold_s,
        overload_cycle_ms_high=0.0,   # wall time is meaningless here
        overload_brownout_admit_per_s=4.0,
        overload_shed_priority=10,
        trace_sample_rate=1.0,        # proves the ELEVATED pause/restore
        # The burn signal is unit-tested on its own; here it would pin
        # BROWNOUT for the whole (virtual-time-huge) slow window after
        # the storm and hide the ladder's recovery mechanics.
        slo_enabled=False,
        # The sweep's zero-lost-pods ledger needs every created pod to
        # stay alive until its own departure: PostFilter eviction
        # DELETES victims on a FakeCluster (no controller recreates
        # them), which would read as loss. Priority still orders the
        # queue, so prod pops first when departures free capacity.
        enable_preemption=False,
    )
    stack = build_stack(config=config, clock=clock)
    agent = FakeTpuAgent(stack.cluster)
    for i in range(hosts):
        agent.add_host(f"h{i}", generation="v5e", chips=chips)
    agent.publish_all()
    return stack, agent, clock


def storm_stream(
    seed: int,
    round_idx: int,
    *,
    prod: int = 1,
    spot: int = 8,
    spot_gangs: int = 1,
    chips: int = 2,
):
    """One round of the seeded flash-crowd stream: ``prod`` prod-tier
    singletons (tpu/priority 10 — never shed), ``spot`` spot singletons
    and ``spot_gangs`` plain spot gangs of 4 (priority 0 — shed at
    SHED). Same seed + round -> same pods; a failing sweep's log is its
    repro. Returns (prod_pods, spot_pods)."""
    import random as _random

    from yoda_tpu_torch.api.types import PodSpec

    rng = _random.Random((seed << 20) ^ round_idx)
    base = rng.randrange(1 << 30)
    prod_pods = [
        PodSpec(
            f"prod-r{round_idx}-{base + i}",
            namespace="prod",
            labels={"tpu/chips": str(chips), "tpu/priority": "10"},
        )
        for i in range(prod)
    ]
    spot_pods = [
        PodSpec(
            f"spot-r{round_idx}-{base + i}",
            namespace="spot",
            labels={"tpu/chips": str(chips), "tpu/priority": "0"},
        )
        for i in range(spot)
    ]
    for g in range(spot_gangs):
        tag = f"sg-r{round_idx}-{base + g}"
        spot_pods.extend(
            PodSpec(
                f"{tag}-{m}",
                namespace="spot",
                labels={
                    "tpu/chips": str(chips),
                    "tpu/priority": "0",
                    "tpu/gang": tag,
                    "tpu/gang-size": "4",
                },
            )
            for m in range(4)
        )
    return prod_pods, spot_pods


class ChaosTcpProxy:
    """A loopback TCP forwarding proxy between a commit RPC client and
    the parent's TCP commit endpoint — the ``rpc_partition`` /
    ``rpc_slow`` chaos surface (ISSUE 20). Point the worker's or
    standby's ``--socket`` at :attr:`endpoint` instead of the parent.

    - :meth:`partition` — the HALF-OPEN failure: established
      connections silently stop carrying bytes in both directions
      (in-flight requests are swallowed, responses never arrive, reads
      hang until the client's deadline fires — no refusal, no reset,
      exactly what a dropped path looks like). New connects are still
      accepted (SYN handshakes often survive real partitions) but
      carry nothing either.
    - :meth:`slow` — every forwarded chunk is delayed by ``delay_s``
      (the degraded-link case reconnect backoff and read deadlines
      must ride out without tripping the fence).
    - :meth:`heal` — restore normal forwarding. Bytes held during a
      partition are released (late delivery, like a real route flap);
      clients that already timed out have dropped the connection, so
      the late bytes land on a closed socket and vanish.
    """

    def __init__(self, upstream: str) -> None:
        import socket as _socket

        host, _, port = upstream.rpartition(":")
        if host.startswith("tcp://"):
            host = host[len("tcp://"):]
        self._up = (host or "127.0.0.1", int(port))
        self.delay_s = 0.0
        self._partitioned = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._conns: list = []
        self._listener = _socket.socket(
            _socket.AF_INET, _socket.SOCK_STREAM
        )
        self._listener.setsockopt(
            _socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1
        )
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        self._thread = threading.Thread(
            target=self._accept_loop, name="chaos-tcp-proxy", daemon=True
        )
        self._thread.start()

    @property
    def endpoint(self) -> str:
        """The ``host:port`` clients dial instead of the real parent."""
        return f"127.0.0.1:{self.port}"

    @property
    def partitioned(self) -> bool:
        return self._partitioned.is_set()

    def partition(self) -> None:
        self._partitioned.set()

    def slow(self, delay_s: float = 0.05) -> None:
        self.delay_s = delay_s

    def heal(self) -> None:
        self._partitioned.clear()
        self.delay_s = 0.0

    def _accept_loop(self) -> None:
        import socket as _socket

        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            try:
                up = _socket.create_connection(self._up, timeout=5.0)
            except OSError:
                conn.close()
                continue
            with self._lock:
                self._conns += [conn, up]
            for src, dst in ((conn, up), (up, conn)):
                threading.Thread(
                    target=self._pump,
                    args=(src, dst),
                    name="chaos-tcp-pump",
                    daemon=True,
                ).start()

    def _pump(self, src, dst) -> None:
        import time as _time

        while not self._stop.is_set():
            try:
                data = src.recv(65536)
            except OSError:
                break
            if not data:
                break
            # Half-open: hold the bytes in transit until heal (or the
            # proxy closes). The peer's read blocks with the connection
            # still "established" — the failure deadlines exist for.
            while self._partitioned.is_set() and not self._stop.is_set():
                _time.sleep(0.01)
            if self._stop.is_set():
                break
            if self.delay_s:
                _time.sleep(self.delay_s)
            try:
                dst.sendall(data)
            except OSError:
                break
        for s in (src, dst):
            try:
                s.close()
            except OSError:
                pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for s in conns:
            try:
                s.close()
            except OSError:
                pass


def maybe_rpc_fault(plan: ChaosPlan, proxy: ChaosTcpProxy) -> "str | None":
    """Consume one invocation each of the commit-transport fault ops
    against ``proxy``. A scheduled ``rpc_partition`` fault half-opens
    the link (the sweep heals it on its own schedule); ``rpc_slow``
    stretches every chunk. Returns which op fired or None. Ops never
    scheduled do not consume invocation indices (``has_op``) — the
    crash-op discipline. ``parent_kill`` is consumed by the sweep
    itself (it owns the parent process handle)."""
    if plan.has_op("rpc_partition"):
        f = plan.next("rpc_partition")
        if f is not None:
            proxy.partition()
            return "rpc_partition"
    if plan.has_op("rpc_slow"):
        f = plan.next("rpc_slow")
        if f is not None:
            proxy.slow()
            return "rpc_slow"
    return None


def maybe_drop_watch(plan: ChaosPlan, server) -> bool:
    """Consume a scheduled "watch" fault: compact ``server``'s event
    window (testing.fake_kube_api.FakeKubeApiServer) so open watch
    streams die with 410 Gone and clients must relist-and-resync."""
    f = plan.next("watch")
    if f is None:
        return False
    server.compact()
    return True


class DriveWorker:
    """One scripted commit-RPC driver subprocess (ISSUE 19 chaos
    surface: ``python -m yoda_tpu_torch.framework.procserve --drive``,
    with ``--device``: "cuda" for ``device`` "auto", the default, which
    raises without a card; "cpu" when the caller asks for the host). The
    child stages its spec'd claims over the parent's commit RPC socket,
    prints ``STAGED``, then executes stdin commands — which gives the
    sweep deterministic kill points: SIGKILL at the STAGED barrier
    plants pure staged residue; SIGKILL after sending COMMIT while the
    parent holds the commit gate closed (``hold_commits``) kills the
    worker mid-commit, the exact window the journal's write-ahead
    discipline exists for."""

    def __init__(
        self,
        socket_path: str,
        shard: str,
        claims: "list[dict]",
        *,
        tmpdir: str,
        device: str = "auto",
    ) -> None:
        import json as _json
        import os as _os
        import subprocess as _sp
        import sys as _sys

        from yoda_tpu_torch.ops.kernel import resolve_device

        # A kernel_platform value, resolved before the spawn: "auto" is
        # the card and raises here without one; "cpu" asks for the host.
        self.device = resolve_device(device).type
        self.shard = shard
        self.claims = list(claims)
        self.spec_path = _os.path.join(tmpdir, f"drive-{shard}.json")
        with open(self.spec_path, "w") as f:
            _json.dump(
                {"socket": socket_path, "shard": shard, "claims": claims},
                f,
            )
        self.proc = _sp.Popen(
            [
                _sys.executable,
                "-m",
                "yoda_tpu_torch.framework.procserve",
                "--drive",
                self.spec_path,
                "--device",
                self.device,
            ],
            stdin=_sp.PIPE,
            stdout=_sp.PIPE,
            stderr=_sp.DEVNULL,
            text=True,
            bufsize=1,
        )

    @property
    def pid(self) -> int:
        return self.proc.pid

    def _read_line(self, timeout_s: float) -> str:
        import select as _select
        import time as _time

        deadline = _time.monotonic() + timeout_s
        while _time.monotonic() < deadline:
            r, _, _ = _select.select([self.proc.stdout], [], [], 0.1)
            if r:
                line = self.proc.stdout.readline()
                if line:
                    return line.strip()
                break  # EOF: child died
            if self.proc.poll() is not None:
                break
        raise ChaosTimeout(
            f"drive worker {self.shard}: no output within {timeout_s}s "
            f"(alive={self.proc.poll() is None})"
        )

    def wait_staged(self, timeout_s: float = 30.0) -> None:
        line = self._read_line(timeout_s)
        if line != "STAGED":
            raise SchedulerCrashed(
                f"drive worker {self.shard}: expected STAGED, got {line!r}"
            )

    def send(self, cmd: str) -> None:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()

    def commit(
        self, uids: "list[str] | None" = None, *, timeout_s: float = 30.0
    ) -> "tuple[bool, str]":
        """Send COMMIT and wait for the result line. With the parent's
        commit gate held, the send returns immediately while the child
        blocks inside the RPC — SIGKILL it THERE for mid-commit."""
        self.send_commit(uids)
        return self.read_commit_result(timeout_s=timeout_s)

    def send_commit(self, uids: "list[str] | None" = None) -> None:
        if uids is None:
            self.send("COMMIT")
        else:
            self.send("COMMIT " + ",".join(uids))

    def read_commit_result(
        self, *, timeout_s: float = 30.0
    ) -> "tuple[bool, str]":
        line = self._read_line(timeout_s)
        if not line.startswith("COMMITTED"):
            raise SchedulerCrashed(
                f"drive worker {self.shard}: expected COMMITTED, "
                f"got {line!r}"
            )
        parts = line.split(" ", 2)
        ok = parts[1] == "1"
        why = parts[2] if len(parts) > 2 else ""
        return ok, why

    def sigkill(self) -> None:
        """kill -9: the worker dies without a word; its staged residue
        is the parent journal's to recover."""
        import signal as _signal

        try:
            self.proc.send_signal(_signal.SIGKILL)
        except (OSError, ValueError):
            pass
        self.proc.wait(timeout=10.0)

    def exit(self, timeout_s: float = 10.0) -> int:
        try:
            self.send("EXIT")
        except (OSError, ValueError, BrokenPipeError):
            pass
        try:
            return self.proc.wait(timeout=timeout_s)
        finally:
            self.close()

    def close(self) -> None:
        for f in (self.proc.stdin, self.proc.stdout):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10.0)
