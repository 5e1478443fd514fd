"""Speculative placement cache: binds for hot shapes without a fleet
evaluation on the serve path.

Serve traffic is shape-skewed: a handful of (admission constraints, chip
request) shapes account for most arrivals, and between serve cycles the
fleet barely moves. This module exploits that skew:

- Between cycles, the REBALANCER's gated tick
  (rebalance/rebalancer.Rebalancer.run_forever) re-evaluates recently-seen
  shapes against a private mirror of the fleet and parks one validated
  candidate plan per shape, keyed by (admission key, kernel request) and
  stamped with the informer's snapshot epochs.
- At serve time, a hot-shape arrival binds from the cached plan after a
  cheap validity chain — leader fence, per-plan epoch check against BOTH
  informer delta feeds, and an O(1) admission + reserved-chip spot check
  on the single chosen node — skipping the O(fleet) evaluation entirely.

Safety argument (why a stale plan cannot bind):

- Chip capacity: ``SpecPlan.base_reserved`` records the reserved-chip
  reading the speculative evaluation ACTUALLY saw on the chosen node (its
  dyn row, not a post-hoc re-read). Consumption requires the accountant's
  live value to equal it exactly, so any reservation, release, or claim
  landing after the evaluation — including one racing the evaluation
  itself — fails the equality.
- Node-object state (cordon, taints) and pod-set changes: the admission
  delta feed (InformerCache.admission_changes_since) names touched hosts;
  a plan whose node appears invalidates, and consumption additionally
  re-runs the single-node admission check against the serve cycle's own
  snapshot.
- Metrics (chip health, HBM): the metrics delta feed
  (InformerCache.changes_since) covers CR value changes; structural
  deltas or ring eviction invalidate unconditionally.
- Gangs: out of scope entirely (see :func:`speculation_key`), so a
  speculative bind can never split a gang.

Threading and the device: speculation runs on the rebalancer thread with a
PRIVATE :class:`~yoda_tpu_torch.ops.resident.FleetStateCache` over its own
:class:`~yoda_tpu_torch.ops.kernel.TorchFleetKernel` on the stack's device
— no sharing with the serve path's YodaBatch, whose resident state and
reused dynamics buffer are not thread-safe. On a CUDA device every sync
(``put_static`` / ``update_rows``) and evaluation of a pass runs inside
``torch.cuda.stream`` on a stream the cache owns: the hand ``fleet_eval``
kernel (K = 1) and the row update launch there, concurrently with the serve
loop's launches on the default stream, and the result fetch synchronizes
that stream only. Its results equal the plain version's bit for bit (int32
throughout), so the plans are those a CPU cache makes on the same snapshot.
The cache's own lock sits below the informer's: feed calls are legal while
holding it, and nothing here runs under the informer lock (invalidation is
pulled off the delta feeds, never pushed by an informer callback).

Counterpart of ``yoda_tpu/framework/speculation.py``. The reference runs
the mirror on its host-side ``NumpyFleetKernel``; the port has no such
kernel and runs the mirror on the device the caller names instead (see
above). Left out: the ``yoda_spec_*`` metric families (``bind_observe``
stays None without a metrics registry) and the live reconfiguration hook
that calls :meth:`SpeculativeCache.configure` (``apply_reloadable``).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from yoda_tpu_torch.api.affinity import pod_has_inter_pod_terms
from yoda_tpu_torch.api.requests import gang_name_of, pod_request
from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.config import Weights
from yoda_tpu_torch.ops.kernel import KernelRequest, TorchFleetKernel, resolve_device
from yoda_tpu_torch.ops.resident import FleetStateCache

log = logging.getLogger("yoda_tpu_torch.speculation")


@dataclass
class SpecPlan:
    """One validated candidate placement for a shape.

    ``epoch_m``/``epoch_a`` are the informer's snapshot-stamped metrics
    and admission epochs the plan was computed against (stamped under the
    informer lock at snapshot build, so an event between build and plan
    is re-covered by the next epoch check rather than skipped).
    ``base_reserved`` is the reserved-chip dyn row the evaluation saw on
    the chosen node — the consume-time equality anchor."""

    key: tuple
    node: str
    epoch_m: int
    epoch_a: int
    base_reserved: int
    score: int


def speculation_key(pod: PodSpec) -> "tuple | None":
    """The (admission constraints, kernel request) shape key, or None when
    the pod is out of speculation scope.

    Scope is deliberately narrow — single non-gang pods whose admission
    depends only on node-local state: gangs need joint placement,
    inter-pod affinity / topology spread / hostPorts / PVCs need the
    per-cycle AffinityData, cpu/mem requests interact with concurrent
    cycles' pending resources that a between-cycles evaluation cannot
    see, and preferred node affinity perturbs ranking relative to the
    full path's preference bonus. Everything excluded here still serves
    on the full path."""
    from yoda_tpu_torch.plugins.yoda.batch import _admission_key

    if gang_name_of(pod.labels) is not None:
        return None
    if pod_has_inter_pod_terms(pod) or pod.topology_spread:
        return None
    if pod.pvc_names or pod.host_ports or pod.preferred_node_affinity:
        return None
    if pod.cpu_milli_request or pod.memory_request:
        return None
    adm = _admission_key(pod)
    if adm is None:
        return None
    try:
        reqk = KernelRequest.from_request(pod_request(pod))
    except Exception:
        return None
    if reqk.wants_topology:
        return None
    return (adm, reqk)


class SpeculativeCache:
    """Shape-keyed cache of pre-validated placements (module docstring).

    Producer side (:meth:`speculate_once`, :meth:`sweep`) runs on the
    rebalancer thread; consumer side (:meth:`lookup` →
    :meth:`epoch_valid` → :meth:`revalidate` → :meth:`consume_plan`) runs
    on serve cycles. Plans are single-use: a successful Reserve changes
    the node's reserved chips, staling ``base_reserved`` by construction,
    so consumption pops and the next tick re-plans the shape.

    ``device`` is where the private mirror evaluates: a ``torch.device``,
    or a ``kernel_platform`` value ("auto" by default: the CUDA card, and
    raising without one; "cpu" for the plain version on the host).
    """

    def __init__(
        self,
        *,
        snapshot_fn: "Callable | None" = None,
        changes_fn: "Callable | None" = None,
        admission_changes_fn: "Callable | None" = None,
        reserved_fn: "Callable | None" = None,
        reserved_map_fn: "Callable | None" = None,
        claimed_fn: "Callable | None" = None,
        claimed_map_fn: "Callable | None" = None,
        last_updated_map_fn: "Callable | None" = None,
        weights: "Weights | None" = None,
        max_metrics_age_s: float = 0.0,
        enabled: bool = True,
        size: int = 256,
        shapes_max: int = 64,
        device: "torch.device | str" = "auto",
    ) -> None:
        self.enabled = enabled
        self.size = max(1, int(size))
        self.shapes_max = max(1, int(shapes_max))
        self.snapshot_fn = snapshot_fn
        self.changes_fn = changes_fn
        self.admission_changes_fn = admission_changes_fn
        self.reserved_fn = reserved_fn
        self.weights = weights or Weights()
        # Bind latency hook (ms per consumed plan); None outside a stack
        # that wires a metrics registry.
        self.bind_observe: "Callable | None" = None
        # The bottom of the lock order: feed/informer calls are legal while
        # holding it; nothing here may be called from under the informer
        # lock.
        self._lock = threading.Lock()
        self._plans: "dict[tuple, SpecPlan]" = {}
        self._shapes: "dict[tuple, PodSpec]" = {}  # key -> representative
        # Private resident state for the rebalancer-thread evaluations:
        # the serve path's YodaBatch (shared dynamics buffer) is not
        # thread-safe, so the speculator owns its own mirror and kernel —
        # and on the card its own stream.
        if not isinstance(device, torch.device):
            device = resolve_device(device)
        self.device = device
        self._kern = TorchFleetKernel(self.weights, device)
        self._stream = (
            torch.cuda.Stream(device=device) if device.type == "cuda" else None
        )
        self._fleet = FleetStateCache(
            changes_fn=(
                changes_fn if changes_fn is not None else (lambda epoch: None)
            ),
            kern_fn=lambda arrays: self._kern,
            max_metrics_age_s=max_metrics_age_s,
            reserved_map_fn=reserved_map_fn,
            reserved_fn=reserved_fn,
            claimed_map_fn=claimed_map_fn,
            claimed_fn=claimed_fn,
            last_updated_map_fn=last_updated_map_fn,
        )
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.reserve_rejects = 0
        self.speculations = 0  # plans produced, lifetime
        self.ticks = 0

    @property
    def kernel(self) -> TorchFleetKernel:
        """The private mirror's kernel (its per-instance launch counts say
        what speculation ran on the card)."""
        return self._kern

    # --- consumer side (serve cycles) ---

    def lookup(self, pod: PodSpec) -> "SpecPlan | None":
        """The cached plan for this pod's shape, or None — recording the
        shape as a speculation candidate on a miss (bounded by
        ``shapes_max``). Read-only: plans leave only via
        :meth:`consume_plan` or invalidation."""
        if not self.enabled:
            return None
        key = speculation_key(pod)
        if key is None:
            return None
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                return plan
            self.misses += 1
            if key not in self._shapes and len(self._shapes) < self.shapes_max:
                self._shapes[key] = pod
        return None

    def epoch_valid(self, plan: SpecPlan) -> bool:
        """Is the plan's chosen node untouched since the plan's epochs?

        Pulls both informer delta feeds — metrics CR values
        (``changes_fn``) and the admission feed covering Node-object
        events and pod-set changes (``admission_changes_fn``). A
        structural delta or a feed that can no longer answer (ring
        eviction, unwired) invalidates; otherwise only a delta naming the
        plan's node does, and a clean pass re-stamps the plan forward so
        the next check covers only new events. Never called under the
        speculation lock: feed calls take the informer lock."""
        if self.changes_fn is None or self.admission_changes_fn is None:
            self._invalidate(plan.key)
            return False
        mdelta = self.changes_fn(plan.epoch_m)
        acur, achanged = self.admission_changes_fn(plan.epoch_a)
        if mdelta is None or mdelta.structural or achanged is None:
            self._invalidate(plan.key)
            return False
        if plan.node in mdelta.changed or plan.node in achanged:
            self._invalidate(plan.key)
            return False
        # Forward re-stamp is monotone-safe: any event after the feed
        # reads above lands at a later epoch and is covered next check.
        plan.epoch_m = mdelta.epoch
        plan.epoch_a = acur
        return True

    def revalidate(self, plan: SpecPlan, pod: PodSpec, snapshot) -> bool:
        """O(1) consume-time spot check against the SERVE cycle's own
        snapshot: the chosen node must still admit the pod (cordon,
        taints) and the accountant's live reserved chips must equal
        exactly what the speculative evaluation saw."""
        from yoda_tpu_torch.plugins.yoda.batch import _node_admission_ok

        if plan.node not in snapshot:
            self._invalidate(plan.key)
            return False
        fenced = getattr(snapshot, "fenced", None)
        if not _node_admission_ok(plan.node, snapshot, fenced, pod):
            self._invalidate(plan.key)
            return False
        # Fail closed without a reserved-chip source: no equality check
        # means no oversubscription guarantee.
        if self.reserved_fn is None or int(
            self.reserved_fn(plan.node)
        ) != plan.base_reserved:
            self._invalidate(plan.key)
            return False
        return True

    def consume_plan(self, plan: SpecPlan) -> "str | None":
        """Pop-and-return the plan's node. Atomic and single-use: exactly
        one caller wins a given plan object; a loser gets None and takes
        the full path. Every call site must be dominated by the leader
        fence AND :meth:`epoch_valid`."""
        with self._lock:
            if self._plans.get(plan.key) is plan:
                del self._plans[plan.key]
                self.hits += 1
                return plan.node
        return None

    def reserve_rejected(self, plan: SpecPlan) -> None:
        """The consumed plan lost the race between the spot check and
        Reserve (a foreign claim landed in that window). The plan is
        already popped; the serve cycle falls through to the full path —
        never parks off a speculative miss."""
        with self._lock:
            self.reserve_rejects += 1
            self.invalidations += 1

    def record_bound(self, ms: float) -> None:
        """Feed the bind latency hook (when wired)."""
        obs = self.bind_observe
        if obs is not None:
            obs(ms)

    # --- producer side (rebalancer tick) ---

    def speculate_once(self, budget: "int | None" = None) -> int:
        """ONE speculation pass: sweep stale plans off the delta feeds,
        then (re-)evaluate up to ``budget`` tracked shapes against the
        current snapshot on the private resident state — on the cache's
        own CUDA stream when the mirror lives on the card. Driven by the
        rebalancer's gated tick. Returns the number of plans produced."""
        if not self.enabled or self.snapshot_fn is None:
            return 0
        self.ticks += 1
        self.sweep()
        with self._lock:
            shapes = list(self._shapes.items())
        if not shapes:
            return 0
        snapshot = self.snapshot_fn()
        m_epoch = getattr(snapshot, "metrics_version", None)
        a_epoch = getattr(snapshot, "admission_epoch", None)
        if not m_epoch or a_epoch is None:
            return 0  # informer without epoch stamps: nothing cacheable
        if self._stream is None:
            return self._speculate(shapes, snapshot, m_epoch, a_epoch, budget)
        with torch.cuda.stream(self._stream):
            return self._speculate(shapes, snapshot, m_epoch, a_epoch, budget)

    def _speculate(self, shapes, snapshot, m_epoch, a_epoch, budget) -> int:
        try:
            arrays = self._fleet.sync(snapshot)
        except Exception:
            log.exception("speculation fleet sync failed; flushing plans")
            self.flush()
            return 0
        if not arrays.names:
            return 0
        if budget is not None:
            shapes = shapes[:budget]
        produced = 0
        for key, pod in shapes:
            plan = self._plan_for(key, pod, snapshot, arrays, m_epoch, a_epoch)
            with self._lock:
                if plan is None:
                    # No feasible host right now: a cached plan for the
                    # shape is definitionally stale, drop it.
                    if self._plans.pop(key, None) is not None:
                        self.invalidations += 1
                elif len(self._plans) < self.size or key in self._plans:
                    self._plans[key] = plan
                    produced += 1
        self.speculations += produced
        return produced

    def _plan_for(self, key, pod, snapshot, arrays, m_epoch, a_epoch):
        from yoda_tpu_torch.plugins.yoda.batch import _host_admission

        host_ok = _host_admission(arrays, snapshot, pod)
        dyn = self._fleet.dyn_packed(host_ok=host_ok)
        try:
            res = self._fleet.kern.evaluate(dyn, key[1])
        except Exception:
            log.exception("speculative evaluation failed for shape %r", key[1])
            return None
        best = int(res.best_index)
        if best < 0:
            return None
        return SpecPlan(
            key=key,
            node=arrays.names[best],
            epoch_m=m_epoch,
            epoch_a=a_epoch,
            # The dyn row the evaluation saw — NOT a re-read, so a
            # reservation racing the evaluation fails the equality.
            base_reserved=int(np.asarray(dyn[1])[best]),
            score=int(np.asarray(res.scores)[best]),
        )

    def sweep(self) -> None:
        """Pull-based invalidation: run the consumption-path epoch check
        over every cached plan, so hosts touched since a plan's epochs
        evict exactly the plans referencing them (structural churn or
        ring eviction evicts everything, same as at consume time)."""
        with self._lock:
            plans = list(self._plans.values())
        for plan in plans:
            self.epoch_valid(plan)

    # --- lifecycle ---

    def flush(self) -> int:
        """Drop every plan AND tracked shape."""
        with self._lock:
            n = len(self._plans)
            self.invalidations += n
            self._plans.clear()
            self._shapes.clear()
        return n

    def configure(
        self, *, enabled=None, size=None, shapes_max=None
    ) -> None:
        """Apply the cache's knobs (spec_enabled / spec_cache_size /
        spec_shapes_max). Shrinking evicts oldest-inserted first;
        disabling flushes — plans must not outlive the kill switch."""
        with self._lock:
            if size is not None:
                self.size = max(1, int(size))
                while len(self._plans) > self.size:
                    del self._plans[next(iter(self._plans))]
                    self.invalidations += 1
            if shapes_max is not None:
                self.shapes_max = max(1, int(shapes_max))
                while len(self._shapes) > self.shapes_max:
                    del self._shapes[next(iter(self._shapes))]
        if enabled is not None:
            was = self.enabled
            self.enabled = bool(enabled)
            if was and not self.enabled:
                self.flush()

    def _invalidate(self, key) -> None:
        with self._lock:
            if self._plans.pop(key, None) is not None:
                self.invalidations += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "plans": len(self._plans),
                "shapes": len(self._shapes),
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "reserve_rejects": self.reserve_rejects,
                "speculations": self.speculations,
                "ticks": self.ticks,
            }
