"""YodaBatch: the fused-evaluation implementation of Filter+PreScore+Score.

Semantically equivalent to the per-node plugin chain but evaluated for the
whole fleet in one device computation (yoda_tpu_torch/ops/kernel.py).

Transfer discipline: the [9, C, N] chip grids live on the evaluation's
device, uploaded once per metrics version; a scheduling cycle transfers
one packed [4, N] dynamics array, the [K, N] admission rows and the
[K, 5] requests, and fetches one packed [K, 6, N] result
(ops.kernel.TorchFleetKernel). On a CUDA device every evaluation is ONE
call of the hand-written kernel (ops/cuda_kernel.py), for one pod
(K = 1) or a K-pod burst.

Counterpart of ``yoda_tpu/plugins/yoda/batch.py``, ported as far as the
singleton path reaches it: the classic per-metrics-version static refresh
with incremental row refills, the per-pod admission vector, the
preference bonus, ``filter_and_score_batch``, and the multi-pod burst
(``prepare_burst`` / ``_serve_burst`` with its serve-time spot-checks).
Left out until a later slice: gang plans and gang / joint bursts, the
device-resident ``FleetStateCache`` with its delta feeds, the
cross-snapshot admission cache, the mesh-sharded kernel, and the dispatch
fallback chain with its circuit breaker — on a CUDA device an evaluation
runs on the hand kernel or raises. The reference's TPU-measured platform
policy (``_device_for`` / ``_dispatch_floor_ms`` and the
``AUTO_DEVICE_MIN_ELEMS`` / ``AUTO_REMOTE_FLOOR_MS`` cut-offs) is not
carried over: ``kernel_platform`` picks the device outright
(ops.kernel.resolve_device).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from yoda_tpu_torch.api.affinity import pod_has_inter_pod_terms
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
from yoda_tpu_torch.ops.arrays import FleetArrays
from yoda_tpu_torch.ops.kernel import (
    REASON_MESSAGES,
    KernelRequest,
    KernelResult,
    TorchFleetKernel,
    resolve_device,
)
from yoda_tpu_torch.plugins.yoda.filter_plugin import (
    get_request,
    node_fits_host_ports,
    node_fits_resources,
)

log = logging.getLogger("yoda_tpu_torch.batch")


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


def _node_admission_ok(name: str, snapshot: Snapshot, pod: PodSpec) -> bool:
    """ONE node's admission verdict: cordon + taints + nodeSelector +
    required node affinity, resource fit and host ports."""
    if name not in snapshot:
        return True
    ni = snapshot.get(name)
    if not pod_admits_on(ni.node, pod)[0]:
        return False
    if not node_fits_resources(ni, pod)[0]:
        return False
    return not pod.host_ports or node_fits_host_ports(ni, pod)[0]


def _host_admission(
    static: FleetArrays, snapshot: Snapshot, pod: PodSpec
) -> np.ndarray:
    """Per-pod Node-object admission vector (padding rows are masked by
    node_valid in the evaluation, so their value is irrelevant).

    Cached on the snapshot object keyed by (fleet arrays identity,
    constraint tuple): every plain label-only pod of a burst shares one
    key, so a K-pod burst pays the O(N) loop once. The snapshot is rebuilt
    (and the cache with it) on any watch event."""
    key = _admission_key(pod)
    cache = None
    if key is not None:
        cache = getattr(snapshot, "_admission_cache", None)
        if cache is None:
            cache = snapshot._admission_cache = {}
        hit = cache.get(key)
        if hit is not None and hit[0] is static:
            return hit[1]
    vec = np.array(
        [_node_admission_ok(name, snapshot, pod) for name in static.names]
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
        kernel_backend: str = "xla",
        batch_requests: int = 1,
        reserved_map_fn: "Callable[[], dict] | None" = None,
        claimed_map_fn: "Callable[[], dict] | None" = None,
        last_updated_map_fn: "Callable[[], dict] | None" = None,
    ) -> None:
        if batch_requests < 1:
            raise ValueError(f"batch_requests must be >= 1, got {batch_requests}")
        if kernel_backend not in ("xla", "pallas"):
            raise ValueError(
                f"kernel_backend must be xla|pallas, got {kernel_backend!r}"
            )
        if kernel_backend == "pallas" and platform != "auto":
            raise ValueError(
                "kernel_backend='pallas' ignores platform; leave it 'auto'"
            )
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
        self.kernel_backend = kernel_backend
        # The evaluation's device, chosen once: both kernel backends run
        # the hand kernel on a CUDA device and the plain version on the
        # CPU.
        self.device = resolve_device(platform)
        self._kern = TorchFleetKernel(self.weights, device=self.device)
        self._cache_version: int | None = None
        self._static: FleetArrays | None = None
        # Per-row CR object tags for incremental static updates
        # (_incremental_update): row i was built from _row_src[i].
        self._row_src: "list | None" = None
        self.snapshot_reuse = 0   # static refreshes answered from cache
        self.restacks = 0         # full fleet re-stacks + uploads
        self.dispatch_count = 0   # real kernel dispatches
        self.dispatch_errors = 0  # dispatches that raised (none are retried)
        # Multi-pod burst dispatch: prepare_burst evaluates up to
        # batch_requests pending pods in one kernel call; their cycles are
        # then served from _burst.
        self.batch_requests = batch_requests
        self._burst: _BurstSet | None = None
        self.burst_dispatches = 0   # multi-pod kernel dispatches
        self.burst_served = 0       # cycles answered from a burst
        self.burst_invalidated = 0  # burst rows dropped by failed validation
        # (snapshot.version, flag) caches for fleet-wide scans.
        self._fleet_terms: tuple[int, bool] = (0, False)
        self._soft_taints: tuple[int, bool] = (0, False)

    def _dispatch(self, call):
        """Run ``call`` on the kernel. A failure is counted and re-raised:
        there is no demotion to another backend."""
        try:
            return call(self._kern)
        except Exception:
            self.dispatch_errors += 1
            raise

    def _dyn_for(
        self, static: FleetArrays, host_ok: "np.ndarray | None" = None
    ) -> np.ndarray:
        """The per-dispatch [4, N] dynamics array, rebuilt from the live
        sources (the bulk map snapshots when wired)."""
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

    def _refresh_static(self, snapshot: Snapshot) -> FleetArrays:
        version = self._fleet_version(snapshot)
        if version and self._cache_version == version and self._static is not None:
            self.snapshot_reuse += 1
            return self._static
        incremental = self._incremental_update(snapshot)
        static = incremental or FleetArrays.from_snapshot(
            snapshot, max_metrics_age_s=self.max_metrics_age_s
        )
        if incremental is None:
            self.restacks += 1
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
        reqk = KernelRequest.from_request(get_request(state))
        if self._burst is not None:
            served = self._serve_burst(pod, snapshot, reqk)
            if served is not None:
                return served
        static = self._refresh_static(snapshot)
        # Reservations/claims/freshness change cycle-to-cycle without a
        # metrics bump, and Node-object admission is per (pod, cycle): one
        # packed upload.
        dyn = self._dyn_for(static, host_ok=_host_admission(static, snapshot, pod))
        result = self._dispatch(lambda kern: kern.evaluate(dyn, reqk))
        self.dispatch_count += 1
        # Soft steering is a host-side additive term, per (pod, node).
        pref_bonus = self._preference_bonus(static, snapshot, pod)
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
        return statuses, scores

    def _preference_bonus(
        self, static: FleetArrays, snapshot: Snapshot, pod: PodSpec
    ) -> np.ndarray:
        """[n_nodes] int64 soft score per real node row: preferred node
        affinity bonus minus the PreferNoSchedule penalty (100 per
        untolerated soft taint), plus ImageLocality — api.types semantics."""
        n = len(static.names)
        out = np.zeros(n, dtype=np.int64)
        w_pref = self.weights.preferred_affinity
        w_taint = (
            self.weights.taint_prefer
            if self._fleet_has_soft_taints(snapshot)
            else 0
        )
        w_image = self.weights.image_locality
        image_spread = None
        if w_image and pod.container_images:
            from yoda_tpu_torch.plugins.yoda.image_locality import build_image_spread

            image_spread = build_image_spread(snapshot, pod)
        want_pref = w_pref and pod.preferred_node_affinity
        if not want_pref and not w_taint and image_spread is None:
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
            if ni is not None and image_spread is not None:
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
            host_ok_k[i] = _host_admission(static, snapshot, pod)
            requests.append(reqk)
        # Pad to the fixed burst width: all-False host_ok rows are
        # infeasible everywhere and their results are never read.
        pad = KernelRequest(1, 0, 0, 0, 0)
        requests += [pad] * (k - len(requests))
        results = self._dispatch(
            lambda kern: kern.evaluate_burst(dyn, host_ok_k, requests)
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
        if self._fleet_version(snapshot) != b.fleet_version:
            self._drop_burst()  # the fleet changed: rows are stale
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
