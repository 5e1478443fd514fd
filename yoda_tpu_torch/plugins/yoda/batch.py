"""YodaBatch: the fused-evaluation implementation of Filter+PreScore+Score.

Semantically equivalent to the per-node plugin chain but evaluated for the
whole fleet in one device computation (yoda_tpu_torch/ops/kernel.py).

Transfer discipline: the [9, C, N] chip grids live on the evaluation's
device, uploaded once per metrics version; a scheduling cycle transfers
one packed [4, N] dynamics array, the [K, N] admission rows and the
[K, 5] requests, and fetches one packed [K, 6, N] result
(ops.kernel.TorchFleetKernel). On a CUDA device every evaluation is ONE
round trip through the hand-written kernels (ops/cuda_kernel.py): the
fleet evaluation for one pod (K = 1) or a K-row burst, and for a joint
gang pass the joint-fit scan right after it on the card.

Counterpart of ``yoda_tpu/plugins/yoda/batch.py``, ported as far as the
singleton, gang, affinity and volume paths reach it: the device-resident
fleet state (ops/resident.py ``FleetStateCache``, fed by the informer's
and the accountant's delta feeds, which ``standalone.build_stack`` wires)
with the classic per-metrics-version refresh and its incremental row
refills kept for bare constructions, the per-pod admission vector and its
cross-snapshot cache (``_admission_vec``; a pod with an ``AffinityData``
bypasses both caches), the preference bonus with its inter-pod and spread
terms, ``filter_and_score_batch``, the multi-pod burst (``prepare_burst`` /
``_serve_burst`` with its serve-time spot-checks), the lazy whole-gang
plan (``_GangPlan``), the gang-fused and cross-gang joint dispatches with
their fit gate (``prepare_gang_burst`` / ``prepare_joint_burst``; plain
gangs' gate runs in the joint-fit kernel, topology gangs' in the host
block planner, as in the reference), and the retention of cached sets
across epoch bumps on nodes they do not reference (``_retain_set``), and
the dispatch tracer (``tracer``, wired by ``build_stack``: a gang-dispatch
or joint-dispatch span on each gathered gang's trace, from before the
kernel launches to after their results are back on the host), and the
node-sharded evaluation (``mesh_devices``: a
``parallel.ShardedDeviceFleetKernel`` over contiguous row blocks of the
resident state, counted in ``sharded_dispatches``), and the dispatch
fallback chain with its circuit breaker (``_dispatch`` / ``_kernel_at``)
for a primary on the host (``kernel_platform: cpu``): an evaluation call
that raises there is demoted, in the same cycle, to a fresh plain version
on a host copy and then to the numpy evaluator
(ops.kernel.NumpyFleetKernel), each demotion counted
(``dispatch_errors``, ``dispatch_fallbacks``, ``backend_level``; the
``yoda_dispatch_*`` families). Only a failure inside the evaluation call
is demoted: a failure of the resident state's row sync before it
(``_refresh_static``) raises out of the cycle. A primary on the card never
demotes, a departure from the reference: a failed launch, build or load
there is counted in ``dispatch_errors`` and re-raised, the cycle ends in
error and the pod is retried, so the card's faults are never served
quietly from the host. Left out: the reference's TPU-measured platform
policy (``_device_for`` / ``_dispatch_floor_ms`` and the
``AUTO_DEVICE_MIN_ELEMS`` / ``AUTO_REMOTE_FLOOR_MS`` cut-offs):
``kernel_platform`` picks the device outright (ops.kernel.resolve_device).
"""

from __future__ import annotations

import logging
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from yoda_tpu_torch.api.affinity import pod_has_inter_pod_terms
from yoda_tpu_torch.api.requests import gang_name_of
from yoda_tpu_torch.api.types import (
    PodSpec,
    pod_admits_on,
    preferred_affinity_score,
    untolerated_soft_taints,
)
from yoda_tpu_torch.config import Weights
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import (
    BatchFilterScorePlugin,
    Snapshot,
    Status,
)
from yoda_tpu_torch.ops.arrays import FleetArrays, bucket_rows
from yoda_tpu_torch.ops.kernel import (
    REASON_MESSAGES,
    KernelRequest,
    KernelResult,
    NumpyFleetKernel,
    TorchFleetKernel,
    resolve_device,
)
from yoda_tpu_torch.ops.resident import FleetStateCache
from yoda_tpu_torch.plugins.yoda.filter_plugin import (
    AffinityData,
    get_affinity,
    get_pending_resources,
    get_request,
    node_fits_host_ports,
    node_fits_resources,
)
from yoda_tpu_torch.plugins.yoda.gang import ALLOWED_HOSTS_KEY, GANG_REMAINING_KEY

log = logging.getLogger("yoda_tpu_torch.batch")

# Dispatch fallback chain (failure-domain hardening) for a primary on the
# host: an exception from the evaluation call demotes the call one backend
# level instead of crashing the scheduling loop. Levels: 0 = the primary
# (the plain version under kernel_platform: cpu, or the mesh kernel over
# host shards), 1 = a fresh TorchFleetKernel on the host (the plain version
# on a host copy; kept for parity with the reference's levels, whose level
# 1 is its XLA host kernel), 2 = the numpy evaluator
# (ops.kernel.NumpyFleetKernel). After this many consecutive failures at a
# level the circuit breaker pins dispatches below it until restart, so a
# level that keeps failing is not probed every cycle. A primary on the card
# never demotes (YodaBatch._dispatch).
CIRCUIT_BREAK_FAILURES = 3
_MAX_FALLBACK_LEVEL = 2
_LEVEL_NAMES = ("primary", "plain version on the host", "numpy evaluator")


def _pod_constraints(pod: PodSpec) -> tuple:
    """Everything pod-side that shapes admission or ranking beyond the
    KernelRequest: a burst row is servable only while its pod still
    matches on ALL of it."""
    return (
        tuple(pod.tolerations),
        tuple(sorted(pod.node_selector.items())),
        tuple(pod.node_affinity),
        tuple(pod.preferred_node_affinity),
        pod.pod_affinity,
        pod.pod_anti_affinity,
        pod.preferred_pod_affinity,
        pod.preferred_pod_anti_affinity,
        pod.topology_spread,
        pod.cpu_milli_request,
        pod.memory_request,
        pod.host_ports,
        pod.pvc_names,
    )


def _admission_key(pod: PodSpec) -> "tuple | None":
    """Everything pod-side that shapes the cacheable admission vector: two
    pods with equal keys get identical vectors against the same snapshot +
    fleet arrays. None when a constraint is unhashable."""
    try:
        key = (
            tuple(pod.tolerations),
            tuple(sorted(pod.node_selector.items())),
            tuple(pod.node_affinity),
            tuple(pod.host_ports),
            pod.cpu_milli_request,
            pod.memory_request,
        )
        hash(key)
    except TypeError:
        return None
    return key


def _node_admission_ok(
    name: str,
    snapshot: Snapshot,
    fenced: "frozenset | None",
    pod: PodSpec,
    aff: "AffinityData | None" = None,
    pending_res: dict | None = None,
) -> bool:
    """ONE node's admission verdict: the fence, cordon + taints +
    nodeSelector + required node affinity, resource fit, host ports and —
    with an ``AffinityData`` — volume pins, attach limits, inter-pod
    affinity and topology spread, in-flight gang members' claims
    included. The per-row unit of :func:`_host_admission`, which the
    cross-snapshot cache (YodaBatch._admission_vec) re-runs for single
    rows."""
    if fenced and name in fenced:
        return False
    if name not in snapshot:
        return True
    ni = snapshot.get(name)
    if not pod_admits_on(ni.node, pod)[0]:
        return False
    if not node_fits_resources(ni, pod, pending_res)[0]:
        return False
    if pod.host_ports and not node_fits_host_ports(
        ni, pod, aff.pending_ports if aff is not None else None
    )[0]:
        return False
    return aff is None or aff.feasible(ni)[0]


def _host_admission(
    static: FleetArrays,
    snapshot: Snapshot,
    pod: PodSpec,
    aff: "AffinityData | None" = None,
    pending_res: dict | None = None,
) -> np.ndarray:
    """Per-pod Node-object admission vector (padding rows are masked by
    node_valid in the evaluation, so their value is irrelevant). With an
    ``AffinityData`` every row also runs its volume, attach-limit,
    inter-pod and spread checks: one O(N) Python loop per pod.

    Cached on the snapshot object keyed by (fleet arrays identity,
    constraint tuple) when neither an AffinityData nor in-flight claims
    are in play: every plain label-only pod of a burst (and every gang
    member) shares one key, so a K-pod burst pays the O(N) loop once. The
    snapshot is rebuilt (and the cache with it) on any watch event."""
    key = None
    cache = None
    if aff is None and not pending_res:
        key = _admission_key(pod)
    if key is not None:
        cache = getattr(snapshot, "_admission_cache", None)
        if cache is None:
            # yodalint: ok snapshot-immutability memoization keyed on snapshot identity, not a fleet-state mutation; rebuilt with the snapshot on every watch event
            cache = snapshot._admission_cache = {}
        hit = cache.get(key)
        if hit is not None and hit[0] is static:
            return hit[1]
    # A snapshot without a ``fenced`` set (one built outside the informer)
    # fences nothing.
    fenced = getattr(snapshot, "fenced", None)
    vec = np.array(
        [
            _node_admission_ok(name, snapshot, fenced, pod, aff, pending_res)
            for name in static.names
        ]
        + [True] * (static.node_valid.shape[0] - len(static.names)),
        dtype=bool,
    )
    if cache is not None:
        if len(cache) >= 256:  # runaway-constraint-diversity backstop
            cache.clear()
        cache[key] = (static, vec)
    return vec


@dataclass
class _BurstEntry:
    """One pod's pre-evaluated row of a K-pod burst dispatch."""

    request: KernelRequest
    constraints: tuple            # _pod_constraints at prepare time
    result: KernelResult
    pref_bonus: np.ndarray        # [n_nodes] int64 soft-score term


@dataclass
class _BurstSet:
    """One multi-pod dispatch's results: K pending pods evaluated against
    ONE snapshot in ONE kernel call, then served to their scheduling
    cycles with host-side conflict resolution — each serve subtracts the
    chips/resources consumed by earlier burst picks from the candidate's
    claimable before ranking, and spot-checks the accountant on the chosen
    node (reserved must equal the dispatch baseline plus exactly the burst
    consumption; any foreign reservation invalidates the burst)."""

    # The fleet-arrays cache key at dispatch (the metrics version in the
    # wired stack): the burst's own binds bump the snapshot version by
    # design, while metrics stay put.
    fleet_version: int
    names: list[str]
    index: dict[str, int]              # node name -> row index
    base_reserved: np.ndarray          # dyn[1] at dispatch time, [N]
    entries: dict[str, _BurstEntry]    # pod uid -> row
    consumed: dict[str, int] = field(default_factory=dict)   # node -> chips
    # node -> [(pod uid, cpu milli, memory bytes)] taken by burst picks.
    res: dict[str, list[tuple[str, int, int]]] = field(default_factory=dict)
    # Gang names sharing this set's dispatch baseline (cross-gang joint
    # placement): the per-gang sets of one joint dispatch share the SAME
    # consumed/res ledgers — gang g's members see capacity net of gangs
    # 0..g-1's claims — so a validation failure on any one set means the
    # common baseline is stale and the whole group drops.
    group: tuple[str, ...] | None = None


@dataclass
class _GangPlan:
    """One dispatch's placement plan for a whole gang.

    Built when the FIRST unplaced member of a gang is evaluated: the
    result's per-node ``claimable`` chips let the remaining members be
    placed host-side against the SAME snapshot — one dispatch per gang
    instead of one per member. Each sibling cycle is served from ``picks``
    after validating that (a) the snapshot hasn't changed and (b) every
    previously-served member actually reserved where predicted (``base`` +
    chips x served picks on that node, via ``reserved_fn``) — any
    divergence invalidates the plan and falls back to a fresh dispatch."""

    gang: str
    snapshot_version: int
    request: KernelRequest              # members must request identically
    constraints: tuple                  # ...and constrain identically
    picks: list[str]                    # node per member, picks[0] = the
                                        # dispatching member's own placement
    base: dict[str, int]                # reserved_fn(node) at dispatch time
    statuses: dict[str, Status]         # private copy of the dispatch's map
    scores: dict[str, int]
    next_idx: int = 1                   # picks[0] is consumed by the dispatch


class YodaBatch(BatchFilterScorePlugin):
    name = "yoda-batch"

    def __init__(
        self,
        reserved_fn: Callable[[str], int] | None = None,
        *,
        claimed_fn: Callable[[str], int] | None = None,
        weights: Weights | None = None,
        max_metrics_age_s: float = 0.0,
        platform: str = "auto",
        mesh_devices: int | None = None,
        kernel_backend: str = "xla",
        batch_requests: int = 1,
        pending_fn: Callable[[], list] | None = None,
        reserved_map_fn: "Callable[[], dict] | None" = None,
        claimed_map_fn: "Callable[[], dict] | None" = None,
        last_updated_map_fn: "Callable[[], dict] | None" = None,
        changes_fn: "Callable | None" = None,
        reserved_delta_fn: "Callable | None" = None,
        claimed_delta_fn: "Callable | None" = None,
        admission_changes_fn: "Callable | None" = None,
    ) -> None:
        if batch_requests < 1:
            raise ValueError(f"batch_requests must be >= 1, got {batch_requests}")
        if kernel_backend not in ("xla", "pallas"):
            raise ValueError(
                f"kernel_backend must be xla|pallas, got {kernel_backend!r}"
            )
        if kernel_backend == "pallas" and mesh_devices:
            raise ValueError("kernel_backend='pallas' excludes mesh_devices")
        if kernel_backend == "pallas" and platform != "auto":
            raise ValueError(
                "kernel_backend='pallas' ignores platform; leave it 'auto'"
            )
        if mesh_devices is not None and mesh_devices < 1:
            raise ValueError(f"mesh_devices must be >= 1, got {mesh_devices}")
        # Bulk-map sources accelerate the dynamics build only; every other
        # consumer keys off the per-node fns, so a map without its fn would
        # silently disable those paths: refuse it.
        if reserved_map_fn is not None and reserved_fn is None:
            raise ValueError("reserved_map_fn requires reserved_fn")
        if claimed_map_fn is not None and claimed_fn is None:
            raise ValueError("claimed_map_fn requires claimed_fn")
        self.reserved_fn = reserved_fn
        self.claimed_fn = claimed_fn
        self.reserved_map_fn = reserved_map_fn
        self.claimed_map_fn = claimed_map_fn
        # Live metric timestamps for the freshness row (heartbeat
        # republishes do not bump the metrics version).
        self.last_updated_map_fn = last_updated_map_fn
        self.weights = weights or Weights()
        self.max_metrics_age_s = max_metrics_age_s
        self.platform = platform
        self.mesh_devices = mesh_devices
        self.kernel_backend = kernel_backend
        if mesh_devices:
            # Eager: an infeasible mesh (more devices than exist) fails at
            # construction, not mid-cycle. The mesh is fixed for the
            # plugin's lifetime; its first device is the plugin's device.
            from yoda_tpu_torch.parallel.sharded import (
                ShardedDeviceFleetKernel,
                default_mesh,
            )

            self._kern = ShardedDeviceFleetKernel(
                self.weights, mesh=default_mesh(mesh_devices, platform=platform)
            )
            self.device = self._kern.device
        else:
            # The evaluation's device, chosen once: both kernel backends
            # run the hand kernel on a CUDA device and the plain version on
            # the CPU.
            self.device = resolve_device(platform)
            self._kern = TorchFleetKernel(self.weights, device=self.device)
        self._cache_version: int | None = None
        self._static: FleetArrays | None = None
        # Per-row CR object tags for incremental static updates
        # (_incremental_update): row i was built from _row_src[i].
        self._row_src: "list | None" = None
        # Device-resident incremental fleet state (ops/resident.py):
        # active when the informer's epoch/delta feed is wired alongside
        # live claims — watch deltas then refill only the changed rows and
        # scatter them into the resident tensors in place, and the delta
        # feeds below maintain the dynamics vector the same way. Without
        # the feed the classic per-snapshot refresh above serves.
        self.changes_fn = changes_fn
        self.reserved_delta_fn = reserved_delta_fn
        self.claimed_delta_fn = claimed_delta_fn
        self._resident: FleetStateCache | None = None  # built lazily
        # Classic-path counts; the properties below add the resident ones.
        self._reuse_count = 0
        self._restack_count = 0
        # Cross-snapshot admission-vector cache: constraint key -> [static,
        # metrics epoch, admission epoch, fenced set, vec]. Valid only while
        # the admission delta feed (InformerCache.admission_changes_since)
        # is wired; entries are patched per changed host instead of rebuilt
        # per snapshot.
        self.admission_changes_fn = admission_changes_fn
        self._adm_cache: dict = {}
        self._adm_index: "tuple | None" = None
        self.admission_reuse = 0      # vectors carried across snapshots
        self.admission_patched = 0    # rows re-checked during carries
        self.admission_rebuilds = 0   # full O(N) loop runs
        self.sets_retained = 0        # burst/joint sets kept across an
                                      # unrelated-node epoch bump
        self.dispatch_count = 0   # real kernel dispatches
        self.sharded_dispatches = 0  # level-0 dispatches on the mesh kernel
        # Dispatch fallback chain + circuit breaker: the counters feed the
        # yoda_dispatch_* families; _fb_* cache the demoted kernels and the
        # static arrays they last put.
        self.dispatch_errors = 0      # dispatch exceptions caught
        self.dispatch_fallbacks = 0   # dispatches completed on a demoted level
        self._backend_level = 0       # circuit-breaker pin (0 = primary)
        self._level_failures: dict[int, int] = {}
        self._fb_kerns: dict[int, object] = {}
        self._fb_static_key: dict[int, tuple] = {}
        # Multi-pod burst dispatch: prepare_burst evaluates up to
        # batch_requests pending pods in one kernel call; their cycles are
        # then served from _burst.
        self.batch_requests = batch_requests
        self._burst: _BurstSet | None = None
        self.burst_dispatches = 0   # multi-pod kernel dispatches
        self.burst_served = 0       # cycles answered from a burst
        self.burst_invalidated = 0  # burst rows dropped by failed validation
        # Gang members parked at Permit (GangPlugin.pending_placements):
        # a burst is refused while one's cpu/memory/port claim is not yet
        # visible in the snapshot (_pending_blocking).
        self.pending_fn = pending_fn
        # Whole-gang placement plans: gang name -> _GangPlan. One dispatch
        # places every remaining member; siblings are served from the plan.
        self._gang_plans: dict[str, _GangPlan] = {}
        self.plan_served = 0       # sibling cycles answered from a gang plan
        self.plan_invalidated = 0  # plans dropped by a failed validation
        # Gang-fused dispatch: prepare_gang_burst evaluates a gathered
        # gang's members — heterogeneous requests included — in ONE call;
        # each member's cycle is served from its own row with siblings'
        # claims deducted (_serve_joint_burst).
        self._gang_bursts: dict[str, _BurstSet] = {}
        self.gang_burst_dispatches = 0   # whole-gang kernel dispatches
        self.gang_burst_served = 0       # member cycles answered from one
        self.gang_burst_invalidated = 0  # rows dropped by failed validation
        # Cross-gang joint dispatch: prepare_joint_burst evaluates SEVERAL
        # co-queued gangs in one call; gang g's members are served net of
        # gangs 0..g-1's claims (shared ledger), and a gang the joint plan
        # cannot fit whole is parked untouched.
        self.joint_dispatches = 0   # multi-gang kernel dispatches
        self.joint_gangs = 0        # gangs whose rows came from a joint one
        self.joint_parked = 0       # gangs parked whole by the joint fit gate
        # Joint dispatches whose fit gate ran on the evaluation's device
        # (TorchFleetKernel.evaluate_joint_plan: the joint-fit kernel on
        # the card) instead of the host block planner.
        self.fused_plan_dispatches = 0
        # (snapshot.version, flag) caches for fleet-wide scans.
        self._fleet_terms: tuple[int, bool] = (0, False)
        self._soft_taints: tuple[int, bool] = (0, False)
        # Lifecycle tracer (tracing.py), wired by build_stack: gang-fused
        # and joint kernel dispatches record a span on each gathered
        # gang's trace, which lands the dispatch wall time on the gang's
        # own timeline.
        self.tracer = None

    # --- fleet-state counters (classic and resident paths summed) ---

    @property
    def snapshot_reuse(self) -> int:
        """Static refreshes answered without touching the fleet (epoch or
        version unchanged)."""
        r = self._resident
        return self._reuse_count + (r.reuse if r is not None else 0)

    @property
    def restacks(self) -> int:
        """Full fleet re-stacks (from_snapshot + whole-fleet upload)."""
        r = self._resident
        return self._restack_count + (r.restacks if r is not None else 0)

    @property
    def delta_apply_ms(self) -> float:
        """Wall ms of the most recent delta sync (row refill + in-place
        update on the device); 0 until the resident path served one."""
        r = self._resident
        return r.last_delta_ms if r is not None else 0.0

    @property
    def backend_level(self) -> int:
        """0 = primary kernel, 1 = the plain version on the host, 2 = the
        numpy evaluator: the circuit breaker's current pin
        (yoda_dispatch_backend_level; nonzero means the scheduler serves
        in degraded mode; always 0 for a primary on the card)."""
        return self._backend_level

    def _primary_on_card(self) -> bool:
        """Whether the primary kernel's tensors live on the card (no
        demotion then; see :meth:`_dispatch`)."""
        return self.device.type == "cuda"

    def _kernel_at(self, level: int, static: FleetArrays):
        """The kernel serving fallback ``level``, with ``static`` put. Level
        0 is the primary (already loaded by _refresh_static); the demoted
        levels are built lazily and re-put ``static`` only when it changed.
        None = this level is unavailable (its construction or put failed)
        and the chain skips it for good."""
        if level == 0:
            return self._kern
        kern = self._fb_kerns.get(level)
        if kern is False:
            return None  # permanently unavailable (construction failed)
        try:
            if kern is None:
                if level == 1:
                    kern = TorchFleetKernel(self.weights, device="cpu")
                else:
                    kern = NumpyFleetKernel(self.weights)
                self._fb_kerns[level] = kern
            # The arrays by identity (a FleetArrays compares its arrays
            # element-wise, so == on two fleets of the same names raises);
            # the key holds a strong reference, so a collected object's
            # reused id cannot alias it.
            last = self._fb_static_key.get(level)
            if last is None or last[0] is not static or last[1] != self._cache_version:
                kern.put_static(static)
                self._fb_static_key[level] = (static, self._cache_version)
            return kern
        except Exception:  # noqa: BLE001 — a broken level is skipped, not fatal
            log.exception("fallback kernel level %d unavailable", level)
            self._fb_kerns[level] = False
            return None

    def _dispatch(self, static: FleetArrays, call):
        """Run ``call`` (kern -> result) on the primary kernel.

        On the card (the hand kernels, or the mesh kernel over the card's
        shards) a failure is counted in ``dispatch_errors`` and re-raised,
        whatever it is (a failed build or load, a refused launch, a CUDA
        error, a wrong argument): the cycle ends in error and the pod is
        retried, and nothing the card was asked to evaluate is served from
        the host. This departs from the reference, which demotes there too.

        On the host (``kernel_platform: cpu``) it runs the reference's chain:
        the primary -> the plain version on a host copy -> the numpy
        evaluator. An exception from ``call`` falls to the next level in
        the SAME call, so the cycle completes: each is counted in
        ``dispatch_errors``, each completion below the primary in
        ``dispatch_fallbacks``, and the circuit breaker pins dispatches
        below a level after CIRCUIT_BREAK_FAILURES consecutive failures
        there. Only ``call`` is covered: the row sync before it
        (``_refresh_static``) is not. Raises the last error when every
        level failed."""
        if self._primary_on_card():
            try:
                out = call(self._kern)
            except Exception:
                self.dispatch_errors += 1
                raise
            if self.mesh_devices:
                self.sharded_dispatches += 1
            return out
        level = self._backend_level
        last_error: Exception | None = None
        while level <= _MAX_FALLBACK_LEVEL:
            kern = self._kernel_at(level, static)
            if kern is None:
                level += 1
                continue
            try:
                out = call(kern)
            except Exception as e:  # noqa: BLE001 — any failure demotes, as the reference
                self.dispatch_errors += 1
                last_error = e
                fails = self._level_failures.get(level, 0) + 1
                self._level_failures[level] = fails
                if (
                    fails >= CIRCUIT_BREAK_FAILURES
                    and self._backend_level == level
                    and level < _MAX_FALLBACK_LEVEL
                ):
                    self._backend_level = level + 1
                    log.error(
                        "kernel backend level %d failed %d times (%s); "
                        "circuit breaker pins dispatches to level %d (%s) "
                        "until restart",
                        level, fails, e, level + 1, _LEVEL_NAMES[level + 1],
                    )
                else:
                    log.warning(
                        "kernel dispatch failed at backend level %d (%s); "
                        "demoting this dispatch", level, e,
                    )
                level += 1
                continue
            self._level_failures[level] = 0  # consecutive-failure semantics
            if level > 0:
                self.dispatch_fallbacks += 1
            elif self.mesh_devices:
                # Level 0 on the mesh kernel: a node-sharded dispatch
                # (yoda_sharded_dispatches_total).
                self.sharded_dispatches += 1
            return out
        if last_error is not None:
            raise last_error
        raise RuntimeError("no kernel backend available for dispatch")

    def _dyn_for(
        self, static: FleetArrays, host_ok: "np.ndarray | None" = None
    ) -> np.ndarray:
        """The per-dispatch [4, N] dynamics array: maintained in place by the
        resident cache's delta feeds when it serves ``static`` (O(changed)
        per cycle), else rebuilt from the live sources (the bulk map
        snapshots when wired)."""
        if self._resident is not None and self._resident.arrays is static:
            return self._resident.dyn_packed(host_ok=host_ok)
        return static.dyn_packed(
            self.reserved_map_fn() if self.reserved_map_fn else self.reserved_fn,
            self.claimed_map_fn() if self.claimed_map_fn else self.claimed_fn,
            max_metrics_age_s=self.max_metrics_age_s,
            host_ok=host_ok,
            last_updated=(
                self.last_updated_map_fn()
                if self.max_metrics_age_s > 0 and self.last_updated_map_fn
                else None
            ),
        )

    def _fleet_version(self, snapshot: Snapshot) -> int:
        """The cache key for fleet-static state: the metrics version when
        claims are supplied dynamically (pod binds then cost O(N), not
        O(N x C)); otherwise the full snapshot version."""
        if self.claimed_fn is not None:
            return snapshot.metrics_version or snapshot.version
        return snapshot.version

    def _resident_active(self, snapshot: Snapshot) -> bool:
        """The device-resident delta path needs the informer's epoch feed,
        live claims (so _fleet_version IS the metrics epoch), accounting,
        and a metrics-versioned snapshot."""
        return (
            self.changes_fn is not None
            and self.claimed_fn is not None
            and self.reserved_fn is not None
            and bool(snapshot.metrics_version)
        )

    def _refresh_static(self, snapshot: Snapshot) -> FleetArrays:
        if self._resident_active(snapshot):
            if self._resident is None:
                self._resident = FleetStateCache(
                    changes_fn=self.changes_fn,
                    kern_fn=lambda _arrays: self._kern,
                    max_metrics_age_s=self.max_metrics_age_s,
                    mesh_multiple=self.mesh_devices,
                    reserved_delta_fn=self.reserved_delta_fn,
                    reserved_map_fn=self.reserved_map_fn,
                    reserved_fn=self.reserved_fn,
                    claimed_delta_fn=self.claimed_delta_fn,
                    claimed_map_fn=self.claimed_map_fn,
                    claimed_fn=self.claimed_fn,
                    last_updated_map_fn=self.last_updated_map_fn,
                )
            static = self._resident.sync(snapshot)
            self._static = static
            self._cache_version = self._resident.epoch
            self._row_src = None  # the delta feed replaces the identity diff
            return static
        version = self._fleet_version(snapshot)
        if version and self._cache_version == version and self._static is not None:
            self._reuse_count += 1
            return self._static
        incremental = self._incremental_update(snapshot)
        static = incremental or FleetArrays.from_snapshot(
            snapshot,
            max_metrics_age_s=self.max_metrics_age_s,
            node_bucket=(
                bucket_rows(len(snapshot), multiple_of=self.mesh_devices)
                if self.mesh_devices
                else None
            ),
        )
        if incremental is None:
            self._restack_count += 1
        self._kern.put_static(static)
        if version:
            self._cache_version = version
            self._static = static
            # Per-row CR identity tags for the next incremental diff.
            self._row_src = [
                snapshot.get(nm).tpu if nm in snapshot else None
                for nm in static.names
            ]
        else:
            self._row_src = None
        return static

    def _incremental_update(self, snapshot: Snapshot) -> "FleetArrays | None":
        """Update only the rows whose CR object changed, in place, instead
        of a full O(N x C) rebuild. Applicable when the node set, order,
        and buckets are unchanged; None = do the full rebuild."""
        static = self._static
        if static is None or self._row_src is None:
            return None
        if self.claimed_fn is None:
            # Without dynamic claims the baked claimed_hbm_mib row is
            # recomputed only on rebuild, and pod binds change ni.pods
            # without touching the CR this diff keys on.
            return None
        names = snapshot.names()
        if names != static.names:
            return None  # node set/order changed: full rebuild
        changed = []
        for i, nm in enumerate(names):
            tpu = snapshot.get(nm).tpu
            src = self._row_src[i]
            if tpu is src:
                continue  # identity fast path: same stored CR object
            if tpu is not None and src is not None and src.values_equal(tpu):
                # Heartbeat: equal values, only the baked timestamp moves.
                static.last_updated[i] = tpu.last_updated_unix
                if self.max_metrics_age_s > 0:
                    static.fresh[i] = tpu.fresh(max_age_s=self.max_metrics_age_s)
                continue
            changed.append(i)
            if tpu is not None and tpu.chip_count > static.padded_shape[1]:
                return None  # chip bucket outgrown: full rebuild
        # Beyond ~a quarter of the fleet the row loop costs what the
        # vectorized rebuild does — rebuild instead.
        if len(changed) > max(len(names) // 4, 8):
            return None
        for i in changed:
            static.fill_row(
                i, snapshot.get(names[i]), max_metrics_age_s=self.max_metrics_age_s
            )
        return static

    def filter_and_score_batch(
        self, state: CycleState, pod: PodSpec, snapshot: Snapshot
    ) -> tuple[dict[str, Status], dict[str, int]]:
        if len(snapshot) == 0:
            return {}, {}
        req = get_request(state)
        reqk = KernelRequest.from_request(req)
        gang_name = req.gang.name if req.gang is not None else None
        if gang_name is not None:
            served = self._serve_joint_burst(state, pod, gang_name, snapshot, reqk)
            if served is None:
                served = self._serve_gang_plan(state, pod, gang_name, snapshot, reqk)
            if served is not None:
                return served
        elif self._burst is not None:
            served = self._serve_burst(pod, snapshot, reqk)
            if served is not None:
                return served
        static = self._refresh_static(snapshot)
        aff = get_affinity(state)
        pending_res = get_pending_resources(state)
        # Reservations/claims/freshness change cycle-to-cycle without a
        # metrics bump, and Node-object admission (cordon + taints +
        # inter-pod affinity/spread + resource fit + host ports + volume
        # pins vs THIS pod, in-flight gang claims included) is per (pod,
        # cycle): one packed upload.
        dyn = self._dyn_for(
            static,
            host_ok=self._admission_vec(static, snapshot, pod, aff, pending_res),
        )
        result = self._dispatch(static, lambda kern: kern.evaluate(dyn, reqk))
        self.dispatch_count += 1
        # Soft steering (preferred node affinity, preferred pod affinity,
        # spread balance) is a host-side additive term, per (pod, node).
        pref_bonus = self._preference_bonus(static, snapshot, pod, aff)
        statuses: dict[str, Status] = {}
        scores: dict[str, int] = {}
        for i, name in enumerate(static.names):
            if result.feasible[i]:
                statuses[name] = Status.ok()
                scores[name] = int(result.scores[i]) + int(pref_bonus[i])
            else:
                # Bare reason text so identical failures aggregate in
                # summarize_failure ("6 node(s): not enough ...").
                reason = REASON_MESSAGES.get(int(result.reasons[i]), "infeasible")
                statuses[name] = Status.unschedulable(reason)
        if gang_name is not None:
            self._build_gang_plan(
                state, pod, gang_name, snapshot, reqk, static, result,
                statuses, scores, pref_bonus,
            )
        return statuses, scores

    def _preference_bonus(
        self,
        static: FleetArrays,
        snapshot: Snapshot,
        pod: PodSpec,
        aff: AffinityData | None = None,
    ) -> np.ndarray:
        """[n_nodes] int64 soft score per real node row: preferred node
        affinity bonus minus the PreferNoSchedule penalty (100 per
        untolerated soft taint), plus the signed preferred
        pod-(anti-)affinity sum, the [0,100] spread-balance score and
        ImageLocality — api.types / api.affinity semantics."""
        n = len(static.names)
        out = np.zeros(n, dtype=np.int64)
        w_pref = self.weights.preferred_affinity
        w_taint = (
            self.weights.taint_prefer
            if self._fleet_has_soft_taints(snapshot)
            else 0
        )
        w_pod = self.weights.pod_affinity
        w_spread = self.weights.topology_spread
        # Gate on actual contribution, not evaluator existence: an
        # evaluator built only for the symmetry filter has no preferred
        # terms and must not bring in the O(N) loop.
        inter = (
            aff.inter
            if (aff is not None and w_pod and aff.inter is not None
                and aff.inter.has_preferences)
            else None
        )
        spread = (
            aff.spread
            if (aff is not None and w_spread and aff.spread is not None
                and aff.spread.has_soft)
            else None
        )
        w_image = self.weights.image_locality
        image_spread = None
        if w_image and pod.container_images:
            from yoda_tpu_torch.plugins.yoda.image_locality import build_image_spread

            image_spread = build_image_spread(snapshot, pod)
        want_pref = w_pref and pod.preferred_node_affinity
        if (
            not want_pref
            and not w_taint
            and inter is None
            and spread is None
            and image_spread is None
        ):
            # The common case (no preferences, taint-free fleet) pays no
            # O(N) Python loop.
            return out
        from yoda_tpu_torch.plugins.yoda.image_locality import image_locality_score

        for i, name in enumerate(static.names):
            ni = snapshot.get(name) if name in snapshot else None
            node = ni.node if ni else None
            v = 0
            if want_pref:
                v += preferred_affinity_score(node, pod) * w_pref
            if w_taint:
                v -= 100 * w_taint * untolerated_soft_taints(node, pod)
            if ni is not None:
                if inter is not None:
                    v += inter.preference(ni) * w_pod
                if spread is not None:
                    v += spread.score(ni) * w_spread
                if image_spread is not None:
                    v += image_locality_score(pod, ni, image_spread) * w_image
            out[i] = v
        return out

    def _fleet_has_soft_taints(self, snapshot: Snapshot) -> bool:
        """Any PreferNoSchedule taint anywhere in the fleet, cached per
        snapshot version."""
        if snapshot.version and self._soft_taints[0] == snapshot.version:
            return self._soft_taints[1]
        flag = any(
            ni.node is not None
            and any(t.effect == "PreferNoSchedule" for t in ni.node.taints)
            for ni in snapshot.infos()
        )
        if snapshot.version:
            self._soft_taints = (snapshot.version, flag)
        return flag

    # --- multi-pod burst dispatch ---

    def _fleet_has_terms(self, snapshot: Snapshot) -> bool:
        """Any bound pod with inter-pod terms: bursting is refused. Cached
        per snapshot version."""
        from yoda_tpu_torch.api.affinity import fleet_has_inter_pod_terms

        if snapshot.version and self._fleet_terms[0] == snapshot.version:
            return self._fleet_terms[1]
        flag = fleet_has_inter_pod_terms(snapshot.infos())
        if snapshot.version:
            self._fleet_terms = (snapshot.version, flag)
        return flag

    def prepare_burst(self, pods: Sequence[PodSpec], snapshot: Snapshot) -> None:
        """Evaluate up to ``batch_requests`` pending pods against ONE
        snapshot in ONE kernel dispatch; their scheduling cycles are then
        served from the cached per-pod rows (:meth:`_serve_burst`).
        Refused (silently — cycles just dispatch individually) when the
        preconditions for cheap, safe serving don't hold."""
        self._burst = None
        if (
            self.batch_requests <= 1
            or len(pods) < 2
            or len(snapshot) == 0
            or not snapshot.version
            or self.reserved_fn is None
            or self._pending_blocking(snapshot)
            or self._fleet_has_terms(snapshot)
        ):
            return
        from yoda_tpu_torch.api.requests import LabelParseError, pod_request

        candidates: list[tuple[PodSpec, KernelRequest]] = []
        for pod in pods:
            if len(candidates) >= self.batch_requests:
                break
            try:
                req = pod_request(pod)
            except LabelParseError:
                continue  # the pod's own cycle reports the parse error
            if (
                req.gang is not None
                or pod_has_inter_pod_terms(pod)
                or pod.topology_spread
                or pod.host_ports
                or pod.pvc_names
            ):
                continue
            candidates.append((pod, KernelRequest.from_request(req)))
        if len(candidates) < 2:
            return  # nothing to amortize
        static = self._refresh_static(snapshot)
        dyn = self._dyn_for(static)
        k = self.batch_requests
        n_pad = static.node_valid.shape[0]
        host_ok_k = np.zeros((k, n_pad), dtype=np.int32)
        requests: list[KernelRequest] = []
        for i, (pod, reqk) in enumerate(candidates):
            host_ok_k[i] = self._admission_vec(static, snapshot, pod)
            requests.append(reqk)
        # Pad to the fixed burst width: all-False host_ok rows are
        # infeasible everywhere and their results are never read.
        pad = KernelRequest(1, 0, 0, 0, 0)
        requests += [pad] * (k - len(requests))
        results = self._dispatch(
            static, lambda kern: kern.evaluate_burst(dyn, host_ok_k, requests)
        )
        self.dispatch_count += 1
        self.burst_dispatches += 1
        entries = {
            pod.uid: _BurstEntry(
                request=reqk,
                constraints=_pod_constraints(pod),
                result=results[i],
                pref_bonus=self._preference_bonus(static, snapshot, pod),
            )
            for i, (pod, reqk) in enumerate(candidates)
        }
        self._burst = _BurstSet(
            fleet_version=self._fleet_version(snapshot),
            names=list(static.names),
            index={nm: i for i, nm in enumerate(static.names)},
            base_reserved=np.asarray(dyn[1]).copy(),
            entries=entries,
        )

    def _pending_blocking(self, snapshot: Snapshot) -> bool:
        """True when some Permit-parked placement's pod is NOT yet visible
        in the snapshot AND claims more than chips (cpu/memory/hostPort/
        PVC): a burst dispatch cannot see that claim, so serving from one
        could overcommit. Chip-only members never refuse a burst — their
        chips are read live through ``reserved_fn`` by every dispatch."""
        if self.pending_fn is None:
            return False
        for host, spec in self.pending_fn():
            if not (
                spec.cpu_milli_request
                or spec.memory_request
                or spec.host_ports
                or spec.pvc_names
            ):
                continue
            if host not in snapshot:
                return True
            if all(p.uid != spec.uid for p in snapshot.get(host).pods):
                return True
        return False

    def _pick_checks(
        self, b: _BurstSet, pod: PodSpec, best: str, snapshot: Snapshot
    ) -> bool:
        """Serve-time validation of a burst pick on the chosen node: the
        accountant must hold exactly the dispatch baseline plus the set's
        own consumption, the node must still be in the snapshot with fresh
        metrics, and the live Node object must still admit the pod with
        allocatable room for it on top of the set's pending siblings."""
        idx = b.index[best]
        if self.reserved_fn(best) != int(b.base_reserved[idx]) + b.consumed.get(
            best, 0
        ):
            return False
        if best not in snapshot:
            return False
        ni = snapshot.get(best)
        if self.max_metrics_age_s > 0 and (
            ni.tpu is None
            or not ni.tpu.fresh(max_age_s=self.max_metrics_age_s)
        ):
            return False
        on_node = {p.uid for p in ni.pods}
        p_cpu = p_mem = p_cnt = 0
        for uid, c, m in b.res.get(best, ()):
            if uid not in on_node:
                p_cpu += c
                p_mem += m
                p_cnt += 1
        return (
            pod_admits_on(ni.node, pod)[0]
            and node_fits_resources(ni, pod, {best: (p_cpu, p_mem, p_cnt)})[0]
        )

    def _retain_set(self, b: _BurstSet, ver: int) -> bool:
        """Epoch-skew tolerance for cached dispatch sets: the fleet epoch
        moved past the set's baseline, but if every node that changed is
        UNREFERENCED by the set — infeasible for every remaining entry and
        untouched by its consumption ledger — the rows' capacity math is
        intact and the set keeps serving (its baseline advances to
        ``ver``). Structural deltas (node add/delete: row indices may have
        moved) and feed gaps always drop. Changed-but-unreferenced nodes
        can only have become more attractive; missing that is bounded
        staleness, and every pick is still spot-checked live
        (_pick_checks)."""
        if self.changes_fn is None or self.claimed_fn is None:
            return False  # fleet_version is not a metrics epoch here
        delta = self.changes_fn(b.fleet_version)
        if delta is None or delta.structural:
            return False
        if delta.changed:
            mask = np.zeros(len(b.names), dtype=bool)
            for e in b.entries.values():
                mask |= e.result.feasible[: len(b.names)].astype(bool)
            for nm in delta.changed:
                if nm in b.consumed:
                    return False
                i = b.index.get(nm)
                if i is not None and mask[i]:
                    return False
        b.fleet_version = ver
        self.sets_retained += 1
        log.debug("cached dispatch set retained across unrelated epoch bump")
        return True

    def _drop_burst(self) -> None:
        if self._burst is not None:
            self.burst_invalidated += len(self._burst.entries)
            self._burst = None

    def _serve_burst(
        self, pod: PodSpec, snapshot: Snapshot, reqk: KernelRequest
    ) -> tuple[dict[str, Status], dict[str, int]] | None:
        """Serve this pod's cycle from the burst dispatch — after adjusting
        for sibling consumption and validating the accountant still matches
        the dispatch baseline on the chosen node. None = dispatch fresh."""
        b = self._burst
        ver = self._fleet_version(snapshot)
        if ver != b.fleet_version and not self._retain_set(b, ver):
            self._drop_burst()  # a referenced node changed: rows are stale
            return None
        entry = b.entries.get(pod.uid)
        if entry is None:
            return None
        if reqk != entry.request or _pod_constraints(pod) != entry.constraints:
            # The pod changed between prepare and its cycle (watch update).
            del b.entries[pod.uid]
            self.burst_invalidated += 1
            return None
        chips = max(reqk.number, 1)
        result = entry.result
        statuses: dict[str, Status] = {}
        scores: dict[str, int] = {}
        sibling = Status.unschedulable("chips consumed by a burst sibling")
        for i, name in enumerate(b.names):
            if result.feasible[i]:
                used = b.consumed.get(name, 0)
                if used and result.claimable[i] - used < chips:
                    statuses[name] = sibling
                    continue
                statuses[name] = Status.ok()
                scores[name] = int(result.scores[i]) + int(entry.pref_bonus[i])
            else:
                reason = REASON_MESSAGES.get(int(result.reasons[i]), "infeasible")
                statuses[name] = Status.unschedulable(reason)
        del b.entries[pod.uid]
        if not b.entries:
            self._burst = None
        if not scores:
            # Never park a pod off a stale row (reservation releases do not
            # bump the metrics version): fall back to a fresh dispatch.
            return None
        best = max(scores, key=lambda nm: (scores[nm], nm))
        if not self._pick_checks(b, pod, best, snapshot):
            self._drop_burst()
            self.burst_invalidated += 1  # this row, beyond the set drop
            return None
        b.consumed[best] = b.consumed.get(best, 0) + chips
        b.res.setdefault(best, []).append(
            (pod.uid, pod.cpu_milli_request, pod.memory_request)
        )
        self.burst_served += 1
        # Steer the cycle to the ONE spot-checked node (single-choice
        # serving): another plugin must not redirect the bind to a node
        # whose burst row was never validated.
        held = Status.unschedulable(
            "feasible, but a burst sibling was steered here first "
            "(single-choice serving)"
        )
        statuses = {
            nm: (st if not st.success else (Status.ok() if nm == best else held))
            for nm, st in statuses.items()
        }
        return statuses, {best: scores[best]}

    # --- gang-fused / cross-gang joint dispatch ---

    def prepare_gang_burst(
        self, pods: Sequence[PodSpec], snapshot: Snapshot
    ) -> None:
        """Evaluate a gathered gang — every co-queued member, handed over
        by the scheduler's gang gather — against ONE snapshot in ONE
        dispatch, so the whole gang places in a single pass. Member cycles
        are served from their own rows by :meth:`_serve_joint_burst` with
        inter-member capacity deduction. The single-group case of
        :meth:`prepare_joint_burst` with no fit gate: a gang that cannot
        complete parks through the normal admission path. Refused silently
        under the same preconditions as ``prepare_burst``."""
        if len(pods) < 2:
            return
        self._prepare_groups([list(pods)], snapshot, fit_gate=False)

    def prepare_joint_burst(
        self, groups: "Sequence[Sequence[PodSpec]]", snapshot: Snapshot
    ) -> "list[str] | None":
        """Cross-gang joint placement: evaluate SEVERAL co-queued gangs
        (distinct names, priority order) in ONE dispatch and build per-gang
        row sets that share one consumption ledger, so gang g's member
        cycles see capacity net of gangs 0..g-1's claims. A fit gate walks
        the groups in priority order — the host block planner for
        topology gangs, the joint-fit scan for plain gangs (on the
        evaluation's device) — and a gang that cannot place WHOLE net of
        the earlier gangs' claims has its rows dropped before any cycle
        runs. An unfit gang consumes nothing: gangs below it still see its
        capacity.

        Returns one verdict per group, in order: ``"fused"`` (rows built;
        drive the members this turn), ``"solo"`` (ineligible for a fused
        dispatch; schedule per-cycle), ``"park"`` (cannot fit whole;
        restore untouched). None = the joint pass is refused entirely and
        every gang falls back to the per-gang path."""
        return self._prepare_groups(
            [list(g) for g in groups], snapshot, fit_gate=True
        )

    def _admission_vec(
        self,
        static: FleetArrays,
        snapshot: Snapshot,
        pod: PodSpec,
        aff: "AffinityData | None" = None,
        pending_res: dict | None = None,
    ) -> np.ndarray:
        """:func:`_host_admission` with a CROSS-SNAPSHOT cache: entries key
        on the pod's constraint tuple and carry the informer epochs stamped
        on the snapshot they were built from. A later snapshot whose deltas
        touch none of the fleet's hosts reuses the vector as is; one that
        touches a few re-checks only those rows. Three signals together
        cover every input of the per-node check: the metrics delta feed
        (candidate-set changes are structural: full rebuild), the admission
        delta feed (Node-object and pod-set changes per node) and the
        snapshot's fence set, diffed directly. Falls back to the
        per-snapshot cache when a feed or a snapshot stamp is missing (bare
        constructions) or on ring-behind/structural deltas."""
        if aff is not None or pending_res:
            # Per-cycle inputs a cached row cannot track (bound pods'
            # inter-pod terms, spread counts, claim attachments, in-flight
            # claims): full loop.
            return _host_admission(static, snapshot, pod, aff, pending_res)
        key = _admission_key(pod)
        m_epoch = snapshot.metrics_version
        a_epoch = snapshot.admission_epoch
        if (
            key is None
            or self.changes_fn is None
            or self.admission_changes_fn is None
            or not m_epoch
            or a_epoch is None
        ):
            return _host_admission(static, snapshot, pod)
        fenced = getattr(snapshot, "fenced", None) or frozenset()
        entry = self._adm_cache.get(key)
        if entry is not None and entry[0] is static:
            _e_static, e_m, e_a, e_fenced, vec = entry
            if e_m == m_epoch and e_a == a_epoch and e_fenced == fenced:
                self.admission_reuse += 1
                return vec
            mdelta = self.changes_fn(e_m)
            _acur, achanged = self.admission_changes_fn(e_a)
            if mdelta is not None and not mdelta.structural and achanged is not None:
                idx = self._adm_index
                if idx is None or idx[0] is not static:
                    idx = (static, {nm: i for i, nm in enumerate(static.names)})
                    self._adm_index = idx
                touched = set(mdelta.changed) | set(achanged)
                touched |= fenced ^ e_fenced
                for nm in touched:
                    i = idx[1].get(nm)
                    if i is not None:
                        vec[i] = _node_admission_ok(nm, snapshot, fenced, pod)
                        self.admission_patched += 1
                # Stamp the SNAPSHOT's epochs, not the feeds' live ones:
                # events landing after this snapshot's build are re-patched
                # on the next carry.
                entry[1] = m_epoch
                entry[2] = a_epoch
                entry[3] = fenced
                self.admission_reuse += 1
                return vec
        vec = _host_admission(static, snapshot, pod)
        self.admission_rebuilds += 1
        if len(self._adm_cache) >= 256:  # constraint-diversity backstop
            self._adm_cache.clear()
        self._adm_cache[key] = [static, m_epoch, a_epoch, fenced, vec.copy()]
        return vec

    def _prepare_groups(
        self,
        groups: "list[list[PodSpec]]",
        snapshot: Snapshot,
        *,
        fit_gate: bool,
    ) -> "list[str] | None":
        gang_names: list[str] = []
        for pods in groups:
            gang = None
            for pod in pods:
                name = gang_name_of(pod.labels)
                if name is None or (gang is not None and name != gang):
                    return None  # not one gang per group: caller bug
                gang = name
            if gang is None or gang in gang_names:
                return None  # empty group or duplicate gang: caller bug
            gang_names.append(gang)
        for name in gang_names:
            self._drop_gang_burst(name)
        if (
            len(snapshot) == 0
            or not snapshot.version
            or self.reserved_fn is None
            or self._pending_blocking(snapshot)
            or self._fleet_has_terms(snapshot)
        ):
            return None
        cands = [self._gang_candidates(pods) for pods in groups]
        eligible = [i for i, c in enumerate(cands) if c]
        if sum(len(cands[i]) for i in eligible) < 2:
            return None  # nothing to amortize or deduct across
        static = self._refresh_static(snapshot)
        dyn = self._dyn_for(static)
        n_pad = static.node_valid.shape[0]
        host_ok_groups: list[np.ndarray] = []
        request_groups: list[list[KernelRequest]] = []
        for i in eligible:
            ok = np.zeros((len(cands[i]), n_pad), dtype=np.int32)
            for m, (pod, _req, _reqk) in enumerate(cands[i]):
                ok[m] = self._admission_vec(static, snapshot, pod)
            host_ok_groups.append(ok)
            request_groups.append([reqk for _, _, reqk in cands[i]])
        # With the fit gate on and no topology gang among the eligible
        # groups, the per-member fit loop runs on the evaluation's device
        # right after the evaluation (TorchFleetKernel.evaluate_joint_plan:
        # the joint-fit kernel on the card). Topology gangs need the host
        # block planner and take the classic split.
        use_fused = fit_gate and all(
            cands[i][0][1].gang is None or cands[i][0][1].gang.topology is None
            for i in eligible
        )

        def run_joint(kern):
            if use_fused:
                grouped, fits, _picks = kern.evaluate_joint_plan(
                    dyn, host_ok_groups, request_groups, self.batch_requests
                )
                return grouped, fits
            return kern.evaluate_joint(
                dyn, host_ok_groups, request_groups, self.batch_requests
            ), None

        # The span closes after _dispatch returns, and both kernel entry
        # points return host arrays copied back from the device (the
        # pinned copy is synchronized before they return), so [td0, td1]
        # covers the launches and their results on the card.
        td0 = time.monotonic()
        grouped, joint_fits = self._dispatch(static, run_joint)
        if joint_fits is not None:
            self.fused_plan_dispatches += 1
        self.dispatch_count += 1
        if len(eligible) >= 2:
            self.joint_dispatches += 1
        else:
            self.gang_burst_dispatches += 1
        if self.tracer is not None and self.tracer.enabled:
            td1 = time.monotonic()
            kind = "joint-dispatch" if len(eligible) >= 2 else "gang-dispatch"
            rows = sum(len(cands[i]) for i in eligible)
            for i in eligible:
                self.tracer.add(
                    f"gang:{gang_names[i]}", kind,
                    t0=td0, t1=td1,
                    attrs={
                        "gangs": ",".join(gang_names),
                        "rows": rows,
                        "fit_gate": fit_gate,
                    },
                )
        fleet_version = self._fleet_version(snapshot)
        base_reserved = np.asarray(dyn[1]).copy()
        index = {nm: i for i, nm in enumerate(static.names)}
        # ONE ledger across the whole joint group: gang g's serves deduct
        # from what gang g+1's serves (and spot-checks) see.
        shared_consumed: dict[str, int] = {}
        shared_res: dict[str, list[tuple[str, int, int]]] = {}
        sim = np.zeros(len(static.names), dtype=np.int64)
        verdicts: list[str] = []
        fused: list[str] = []
        gi = 0
        for name, cand in zip(gang_names, cands):
            if not cand:
                verdicts.append("solo")
                continue
            rows = grouped[gi]
            if not fit_gate:
                fit_ok = True
            elif joint_fits is not None:
                fit_ok = joint_fits[gi]
            else:
                fit_ok = self._joint_gang_fits(cand, rows, static, snapshot, sim)
            gi += 1
            if not fit_ok:
                verdicts.append("park")
                self.joint_parked += 1
                log.debug(
                    "gang %s: joint plan cannot fit it whole net of %d "
                    "higher-priority gang(s); parking untouched",
                    name, len(fused),
                )
                continue
            self._gang_bursts[name] = _BurstSet(
                fleet_version=fleet_version,
                names=list(static.names),
                index=index,
                base_reserved=base_reserved,
                entries={
                    pod.uid: _BurstEntry(
                        request=reqk,
                        constraints=_pod_constraints(pod),
                        result=rows[m],
                        pref_bonus=self._preference_bonus(static, snapshot, pod),
                    )
                    for m, (pod, _req, reqk) in enumerate(cand)
                },
                consumed=shared_consumed,
                res=shared_res,
            )
            fused.append(name)
            verdicts.append("fused")
        if len(eligible) >= 2:
            # Joint dispatch: count every gang it served rows for, and tag
            # the sets as one group so invalidation drops them together.
            self.joint_gangs += len(fused)
        if len(fused) >= 2:
            group = tuple(fused)
            for name in fused:
                self._gang_bursts[name].group = group
        if len(self._gang_bursts) > 8:
            # Bounded, like the gang plans: evict stale sets, oldest
            # first, never this dispatch's own.
            for stale in [g for g in self._gang_bursts if g not in fused]:
                if len(self._gang_bursts) <= 8:
                    break
                self._drop_gang_burst(stale)
        return verdicts

    def _gang_candidates(
        self, pods: "list[PodSpec]"
    ) -> "list[tuple[PodSpec, object, KernelRequest]] | None":
        """Validate one gathered gang for a fused dispatch: every member
        parses and none carries per-cycle state a cached row cannot track
        (inter-pod terms, spread, hostPorts, PVCs). One ineligible member
        refuses the whole gang. Returns (pod, parsed request, kernel
        request) per member, or None = ineligible (members schedule
        per-cycle)."""
        from yoda_tpu_torch.api.requests import LabelParseError, pod_request

        out: list[tuple[PodSpec, object, KernelRequest]] = []
        for pod in pods:
            try:
                req = pod_request(pod)
            except LabelParseError:
                return None  # the member's own cycle reports the parse error
            if (
                req.gang is None
                or pod_has_inter_pod_terms(pod)
                or pod.topology_spread
                or pod.host_ports
                or pod.pvc_names
            ):
                return None
            out.append((pod, req, KernelRequest.from_request(req)))
        return out

    def _joint_gang_fits(
        self,
        cand: "list[tuple[PodSpec, object, KernelRequest]]",
        rows: "list[KernelResult]",
        static: FleetArrays,
        snapshot: Snapshot,
        sim: np.ndarray,
    ) -> bool:
        """Host-side fit simulation for one gang of a joint dispatch that
        holds a topology gang: can every gathered member place, net of
        ``sim`` (the chips earlier fitting gangs' members would claim)?
        Fitting gangs consume into ``sim``; an unfit gang consumes nothing.
        A PREDICATE, not a placement: the serve path re-validates every
        pick. Topology gangs run the real block planner against the first
        member's row; plain gangs greedily deduct each member's own row's
        claimable in score order (the joint-fit scan's semantics)."""
        from yoda_tpu_torch.plugins.yoda.topology import plan_multislice_placement

        req0 = cand[0][1]
        spec = getattr(req0, "gang", None)
        chips0 = max(cand[0][2].number, 1)
        if spec is not None and spec.topology is not None:
            row0 = rows[0]
            idx = {nm: i for i, nm in enumerate(static.names)}

            def host_ok(ni) -> bool:
                i = idx.get(ni.name)
                return (
                    i is not None
                    and bool(row0.feasible[i])
                    and int(row0.claimable[i]) - int(sim[i]) >= chips0
                )

            plan = plan_multislice_placement(
                snapshot,
                want_dims=spec.topology,
                slices=spec.slices,
                host_ok=host_ok,
            )
            if plan is None:
                return False
            # Gathered members claim one planned host each (partial gangs
            # claim only what they will reserve this turn).
            for host in sorted(plan)[: len(cand)]:
                sim[idx[host]] += chips0
            return True
        tentative = sim.copy()
        for (_pod, _req, reqk), row in zip(cand, rows):
            chips = max(reqk.number, 1)
            avail = row.claimable.astype(np.int64) - tentative
            ok = row.feasible.astype(bool) & (avail >= chips)
            if not ok.any():
                return False
            tentative[int(np.argmax(np.where(ok, row.scores, -1)))] += chips
        sim[:] = tentative
        return True

    def _drop_gang_burst(self, gang: str) -> None:
        b = self._gang_bursts.pop(gang, None)
        if b is None:
            return
        self.gang_burst_invalidated += len(b.entries)
        log.debug("gang %s: fused dispatch rows invalidated", gang)
        # A joint group's sets share one dispatch baseline and ledger:
        # stale for one gang means stale for every sibling gang.
        for sibling in b.group or ():
            s = self._gang_bursts.pop(sibling, None)
            if s is not None:
                self.gang_burst_invalidated += len(s.entries)

    def _serve_joint_burst(
        self,
        state: CycleState,
        pod: PodSpec,
        gang: str,
        snapshot: Snapshot,
        reqk: KernelRequest,
    ) -> tuple[dict[str, Status], dict[str, int]] | None:
        """Serve a gang member's cycle from the gang-fused or joint
        dispatch — its own row, minus what earlier members claimed
        (``consumed``; shared across a joint group's gangs), pinned to the
        gang's planned hosts when the PreFilter wrote them, and
        spot-checked against the live accountant/Node state exactly like a
        burst serve. None = dispatch fresh (a stale row must never park a
        pod)."""
        b = self._gang_bursts.get(gang)
        if b is None:
            return None
        ver = self._fleet_version(snapshot)
        if ver != b.fleet_version and not self._retain_set(b, ver):
            self._drop_gang_burst(gang)  # a referenced node changed
            return None
        entry = b.entries.get(pod.uid)
        if entry is None:
            return None
        if reqk != entry.request or _pod_constraints(pod) != entry.constraints:
            # The pod changed between gather and its cycle (watch update).
            del b.entries[pod.uid]
            self.gang_burst_invalidated += 1
            if not b.entries:
                self._gang_bursts.pop(gang, None)
            return None
        allowed = (
            state.read(ALLOWED_HOSTS_KEY).hosts
            if state.contains(ALLOWED_HOSTS_KEY)
            else None
        )
        chips = max(reqk.number, 1)
        result = entry.result
        statuses: dict[str, Status] = {}
        scores: dict[str, int] = {}
        sibling = Status.unschedulable(
            "chips claimed by a gang sibling (gang-fused pass)"
        )
        outside = Status.unschedulable("host not in gang's planned ICI block")
        for i, name in enumerate(b.names):
            if result.feasible[i]:
                if allowed is not None and name not in allowed:
                    statuses[name] = outside
                    continue
                used = b.consumed.get(name, 0)
                if used and result.claimable[i] - used < chips:
                    statuses[name] = sibling
                    continue
                statuses[name] = Status.ok()
                scores[name] = int(result.scores[i]) + int(entry.pref_bonus[i])
            else:
                reason = REASON_MESSAGES.get(int(result.reasons[i]), "infeasible")
                statuses[name] = Status.unschedulable(reason)
        del b.entries[pod.uid]
        if not b.entries:
            self._gang_bursts.pop(gang, None)
        if not scores:
            # Stale rows (a release between gather and this cycle frees
            # chips without a metrics bump) must fall back to a fresh
            # dispatch, never park the member.
            return None
        best = max(scores, key=lambda nm: (scores[nm], nm))
        if not self._pick_checks(b, pod, best, snapshot):
            self._drop_gang_burst(gang)
            self.gang_burst_invalidated += 1  # this row, beyond the set
            return None
        b.consumed[best] = b.consumed.get(best, 0) + chips
        b.res.setdefault(best, []).append(
            (pod.uid, pod.cpu_milli_request, pod.memory_request)
        )
        self.gang_burst_served += 1
        # Single-choice serving, as for bursts and the gang plan.
        held = Status.unschedulable("chips held for gang siblings (gang-fused pass)")
        statuses = {
            nm: (st if not st.success else (Status.ok() if nm == best else held))
            for nm, st in statuses.items()
        }
        return statuses, {best: scores[best]}

    # --- whole-gang batched placement (the lazy gang plan) ---

    def _build_gang_plan(
        self,
        state: CycleState,
        pod: PodSpec,
        gang: str,
        snapshot: Snapshot,
        reqk: KernelRequest,
        static: FleetArrays,
        result: KernelResult,
        statuses: dict[str, Status],
        scores: dict[str, int],
        pref_bonus: np.ndarray,
    ) -> None:
        """Place every remaining gang member host-side from THIS dispatch's
        result: greedy argmax by (score, name) — identical to the scheduler's
        pick — decrementing per-node ``claimable`` chips between members
        (and, for topology gangs, consuming one planned host per member).
        picks[0] reproduces the scheduler's choice for the dispatching member;
        the rest are served to sibling cycles by :meth:`_serve_gang_plan`."""
        self._gang_plans.pop(gang, None)
        if (
            self.reserved_fn is None
            or result.claimable is None
            or not snapshot.version  # 0 = uncacheable snapshot
        ):
            return
        # Inter-pod terms and spread constraints are evaluated per cycle;
        # a plan built from one dispatch cannot track them.
        if pod_has_inter_pod_terms(pod) or pod.topology_spread:
            return
        k = (
            state.read(GANG_REMAINING_KEY).count
            if state.contains(GANG_REMAINING_KEY)
            else 0
        )
        if k <= 1:
            return
        chips = max(reqk.number, 1)
        names = static.names
        n = len(names)
        one_per_host = False
        eligible = result.feasible[:n].astype(bool).copy()
        if state.contains(ALLOWED_HOSTS_KEY):
            hosts = state.read(ALLOWED_HOSTS_KEY).hosts
            eligible &= np.fromiter(
                (nm in hosts for nm in names), dtype=bool, count=n
            )
            one_per_host = True  # topology plans are one member per host
        avail = result.claimable[:n].astype(np.int64).copy()
        pending_res = get_pending_resources(state)

        def members_cap(name: str) -> int | None:
            """How many ADDITIONAL identical members the node can take by
            cpu/memory/pod-count allocatable (None = unconstrained): chips
            alone are not the only capacity a plan must respect."""
            if pod.host_ports:
                # Identical siblings claiming a hostPort always conflict
                # with each other: one member per node.
                return 1
            if name not in snapshot:
                return None
            ni = snapshot.get(name)
            node = ni.node
            if node is None:
                return None
            p_cpu, p_mem, p_n = (
                pending_res.get(name, (0, 0, 0)) if pending_res else (0, 0, 0)
            )
            cap: int | None = None
            if node.alloc_pods:
                cap = node.alloc_pods - len(ni.pods) - p_n
            if pod.cpu_milli_request and node.alloc_cpu_milli:
                used = sum(p.cpu_milli_request for p in ni.pods) + p_cpu
                c = (node.alloc_cpu_milli - used) // pod.cpu_milli_request
                cap = c if cap is None else min(cap, c)
            if pod.memory_request and node.alloc_memory:
                used = sum(p.memory_request for p in ni.pods) + p_mem
                c = (node.alloc_memory - used) // pod.memory_request
                cap = c if cap is None else min(cap, c)
            return cap

        # One vectorized descending (score, name) ranking, then a walk:
        # scores never change between picks, so the greedy argmax is always
        # the first still-eligible node in this order.
        order = np.lexsort(
            (np.array(names), result.scores[:n] + pref_bonus[:n])
        )[::-1]
        picks: list[str] = []
        for i in order:
            if not eligible[i]:
                continue
            cap = members_cap(names[i])
            taken = 0
            while (
                len(picks) < k
                and avail[i] >= chips
                and (cap is None or taken < cap)
            ):
                picks.append(names[i])
                avail[i] -= chips
                taken += 1
                if one_per_host:
                    break
            if len(picks) >= k:
                break
        if len(picks) < 2:
            return  # nothing to serve beyond the current member
        self._gang_plans[gang] = _GangPlan(
            gang=gang,
            snapshot_version=snapshot.version,
            request=reqk,
            constraints=_pod_constraints(pod),
            picks=picks,
            # Copies: the runtime owns and may mutate the returned dicts.
            base={nm: self.reserved_fn(nm) for nm in set(picks)},
            statuses=dict(statuses),
            scores=dict(scores),
        )
        if len(self._gang_plans) > 16:
            # Bounded: evict the oldest LIVE plan (counted as an
            # invalidation).
            self._invalidate_plan(next(iter(self._gang_plans)))

    def _serve_gang_plan(
        self,
        state: CycleState,
        pod: PodSpec,
        gang: str,
        snapshot: Snapshot,
        reqk: KernelRequest,
    ) -> tuple[dict[str, Status], dict[str, int]] | None:
        """Serve a sibling member its pre-planned node — after validating
        the plan still describes reality. None = dispatch normally."""
        plan = self._gang_plans.get(gang)
        if plan is None:
            return None
        if plan.next_idx >= len(plan.picks) or self.reserved_fn is None:
            # Defensive only — a benign drop, not a validation failure.
            self._gang_plans.pop(gang, None)
            return None
        if (
            snapshot.version != plan.snapshot_version
            or reqk != plan.request  # members must request identically
            or _pod_constraints(pod) != plan.constraints  # and constrain so
        ):
            self._invalidate_plan(gang)
            return None
        node = plan.picks[plan.next_idx]
        # Every previously-served member must have reserved where predicted,
        # and the node about to be served must hold exactly its predicted
        # reservations — a foreign pod reserving onto ANY planned node
        # invalidates the plan.
        chips = max(plan.request.number, 1)
        served = Counter(plan.picks[: plan.next_idx])
        for nm in set(plan.picks[: plan.next_idx]) | {node}:
            if self.reserved_fn(nm) != plan.base[nm] + chips * served[nm]:
                self._invalidate_plan(gang)
                return None
        if state.contains(ALLOWED_HOSTS_KEY) and node not in state.read(
            ALLOWED_HOSTS_KEY
        ).hosts:
            self._invalidate_plan(gang)  # the gang re-planned
            return None
        plan.next_idx += 1
        self.plan_served += 1
        if plan.next_idx >= len(plan.picks):
            # Fully served: release the plan now, so a later gang reusing
            # the same name does not count as an invalidation.
            self._gang_plans.pop(gang, None)
        held = Status.unschedulable(
            "chips held for gang siblings (batched placement)"
        )
        ok = Status.ok()
        statuses = {
            nm: (st if not st.success else (ok if nm == node else held))
            for nm, st in plan.statuses.items()
        }
        return statuses, {node: plan.scores.get(node, 0)}

    def _invalidate_plan(self, gang: str) -> None:
        if self._gang_plans.pop(gang, None) is not None:
            self.plan_invalidated += 1
            log.debug("gang %s: placement plan invalidated", gang)
