"""Crash-safe failover: warm-start state reconciliation + drift repair.

Reservations, gang permit groups and the Permit waitlist are in-memory
only. A crash or lease handover mid-gang therefore leaves a new leader
blind: it could double-place onto chips the dead leader already bound, and
half-bound gangs would be stranded until the permit timeout. This module
closes that gap with two passes over CLUSTER TRUTH:

- :meth:`Reconciler.resync` — the **warm-start pass**. Runs on promotion,
  before the serve loop admits any pod: charges every bound pod's
  reservation that local accounting is missing, releases claims with no
  live pod behind them, and classifies every PARTIALLY-BOUND gang —
  **adopt** (bound members kept, remaining members complete the gang in
  place, bounded by ``failover_adopt_window_s``) or **roll back whole**
  via the existing unbind path. The policy is deterministic: adopt iff
  the window is > 0 and every bound member's host is still present in
  cluster truth.
- :meth:`Reconciler.reconcile` — the **periodic drift pass**
  (``reconcile_period_s``). Repairs what the watch stream dropped: leaked
  reservations (pod deleted, release event lost), ghost bindings (bind
  event lost — cluster truth bound, cache not — and the reverse: cache
  entries for pods the cluster no longer has), Permit waits whose pod was
  deleted (cancelled immediately instead of eating the permit timeout),
  and adopted gangs still partial past their window (rolled back whole).

Both passes are idempotent and run against live scheduling: repairs go
through the SAME watch-event handlers the stream would have driven
(``accountant.handle`` / ``gang.handle`` / ``informer.handle``), in the
same registration order, so incremental bookkeeping stays consistent; and
every "gone" verdict is double-checked against ``cluster.get_pod`` before
acting, so a pod created or deleted between the LIST and the check is
never misclassified.

Counterpart of ``yoda_tpu/framework/reconciler.py``: both passes and
``run_forever``. The port's backend (``FakeCluster``) is its own truth, so
the API re-LIST the reference asks a watch-caching backend for is not
there (``relist`` is accepted and changes nothing). Left out: the journal
warm start (the reference's divergence check against a replayed claim
journal, and its staged-claim resume) and the shard-commit residue repair,
since the journal and shards are not ported; and the counters and
lifecycle trace, since the port has no registry.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from yoda_tpu_torch.api.requests import LabelParseError, gang_name_of, pod_request
from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.cluster.fake import Event

log = logging.getLogger("yoda_tpu_torch.reconciler")


@dataclass
class ResyncReport:
    """What one warm-start resync pass found and did (tests, logs)."""

    adopted_gangs: list[str] = field(default_factory=list)
    rolled_back_gangs: list[str] = field(default_factory=list)
    rebuilt_reservations: int = 0
    released_reservations: int = 0
    duration_ms: float = 0.0
    # True when the pass ran as the reference's divergence check against a
    # replayed claim journal; the port has no journal, so always False.
    warm: bool = False


@dataclass
class DriftReport:
    """What one periodic reconcile round repaired."""

    leaked_reservations: int = 0
    ghost_pods: int = 0
    stranded_waits: int = 0
    expired_adoptions: list[str] = field(default_factory=list)


class Reconciler:
    """Rebuilds and repairs scheduler state from cluster truth.

    One per stack (``standalone.build_stack``). The accountant may be
    shared across profile stacks — its repairs are idempotent, so
    concurrent reconcilers converge; gang classification is restricted to
    this stack's ``scheduler_names`` so two profiles never both adopt or
    roll back the same gang.
    """

    def __init__(
        self,
        *,
        cluster,
        informer,
        accountant,
        gang,
        framework,
        queue,
        scheduler,
        adopt_window_s: float = 60.0,
        scheduler_names: "tuple[str, ...] | None" = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.cluster = cluster
        self.informer = informer
        self.accountant = accountant
        self.gang = gang
        self.framework = framework
        self.queue = queue
        self.scheduler = scheduler
        self.adopt_window_s = adopt_window_s
        self.scheduler_names = frozenset(
            scheduler_names or (informer.scheduler_name,)
        )
        self.clock = clock
        # Set after the first successful resync: the rebalancer's gate
        # waits on it (no rebalancing on un-resynced state).
        self.resynced = threading.Event()
        self._lock = threading.Lock()
        # gang name -> clock deadline by which an ADOPTED partial gang
        # must have completed whole, or the drift pass rolls it back.
        self._adopt_deadlines: dict[str, float] = {}

    # --- shared plumbing ---

    def _repair_event(self, etype: str, pod: PodSpec) -> None:
        """Inject a corrective event through the same handlers the watch
        stream drives, in stack registration order (accountant before
        gang before informer — reservation releases must precede the
        informer's view of the same event)."""
        ev = Event(etype, "Pod", pod)
        self.accountant.handle(ev)
        self.gang.handle(ev)
        self.informer.handle(ev)

    def _pod_truly_gone(self, pod_key: str) -> bool:
        """Double-check a 'gone' verdict against a point read — a pod
        created between the LIST and the diff must not be reaped."""
        try:
            return self.cluster.get_pod(pod_key) is None
        except Exception:  # noqa: BLE001 — unreadable backend: do nothing
            log.exception("point read of %s failed; skipping repair", pod_key)
            return False

    def _rollback_gang(self, name: str, bound: "list[PodSpec]", why: str) -> None:
        """Roll a partial gang back WHOLE through the existing unbind path:
        membership is dropped first (a stale bound entry must not satisfy
        the barrier mid-rollback; on_unbind_failed restores it if the
        unbind cannot land), then each landed bind is unbound, unreserved,
        and requeued (scheduler._rollback_bound)."""
        log.warning(
            "failover: rolling back partial gang %s (%d bound member(s)): %s",
            name, len(bound), why,
        )
        for pod in bound:
            self.gang.drop_membership(pod)
            self.scheduler._rollback_bound(pod, pod.node_name, None, why)

    def _gang_truth(
        self, pods: "list[PodSpec]"
    ) -> "dict[str, tuple[int, list[PodSpec], list[PodSpec]]]":
        """gang name -> (declared size, bound members, unbound members),
        restricted to this stack's scheduler profiles."""
        out: dict[str, tuple[int, list[PodSpec], list[PodSpec]]] = {}
        groups: dict[str, list[PodSpec]] = {}
        for p in pods:
            name = gang_name_of(p.labels)
            if not name or p.scheduler_name not in self.scheduler_names:
                continue
            groups.setdefault(name, []).append(p)
        for name, members in groups.items():
            size = 0
            for p in members:
                try:
                    spec = pod_request(p).gang
                except LabelParseError:
                    continue
                if spec is not None:
                    size = spec.size
                    break
            if size <= 0:
                continue
            bound = [p for p in members if p.node_name]
            unbound = [p for p in members if not p.node_name]
            out[name] = (size, bound, unbound)
        return out

    # --- the warm-start pass ---

    def resync(self) -> ResyncReport:
        """List cluster truth and rebuild this scheduler's load-bearing
        state BEFORE any pod is admitted. Idempotent: a warm standby whose
        caches tracked the whole time resyncs to a no-op."""
        t0 = self.clock()
        report = ResyncReport()
        pods = self.cluster.list_pods()
        live = {p.uid for p in pods}

        # 1. Reservations: every bound pod must be charged. The watch
        # replay normally did this at stack build; this covers binds the
        # dead leader landed that the stream has not delivered yet.
        for p in pods:
            if not p.node_name:
                continue
            missing = not self.accountant.has_claim(p.uid)
            if missing or not self.informer.counts_bound(p.uid):
                self._repair_event("modified", p)
            if missing and self.accountant.has_claim(p.uid):
                report.rebuilt_reservations += 1

        # 2. Claims with no live pod behind them (the dead leader reserved
        # and the pod is gone, or a drop): release.
        for uid in self.accountant.claimed_uids() - live:
            self.accountant.release(uid)
            report.released_reservations += 1

        # 3. Partially-bound gangs: adopt or roll back whole.
        now = self.clock()
        hosts = {t.name for t in self.cluster.list_tpu_metrics()}
        for name, (size, bound, _unbound) in self._gang_truth(pods).items():
            if not bound or len(bound) >= size:
                continue  # nothing placed yet, or already complete
            hosts_alive = all(p.node_name in hosts for p in bound)
            if self.adopt_window_s > 0 and hosts_alive:
                with self._lock:
                    self._adopt_deadlines.setdefault(
                        name, now + self.adopt_window_s
                    )
                report.adopted_gangs.append(name)
                log.info(
                    "failover: adopted partial gang %s (%d/%d bound; "
                    "%.0fs to complete before rollback)",
                    name, len(bound), size, self.adopt_window_s,
                )
            else:
                why = (
                    f"failover resync: gang {name} partially bound "
                    f"({len(bound)}/{size}) and "
                    + (
                        "adoption is disabled"
                        if self.adopt_window_s <= 0
                        else "a bound member's host is gone"
                    )
                )
                self._rollback_gang(name, bound, why)
                report.rolled_back_gangs.append(name)

        report.duration_ms = (self.clock() - t0) * 1e3
        self.resynced.set()
        log.info(
            "warm-start resync: %d reservation(s) rebuilt, %d released, "
            "%d gang(s) adopted, %d rolled back (%.1f ms)",
            report.rebuilt_reservations, report.released_reservations,
            len(report.adopted_gangs), len(report.rolled_back_gangs),
            report.duration_ms,
        )
        return report

    # --- the periodic drift pass ---

    def reconcile(self, *, relist: bool = True) -> DriftReport:
        """One drift-repair round. Safe against live scheduling: every
        repair is either an idempotent re-count or goes through the
        standard rejection/rollback paths. ``relist`` is the reference's
        re-LIST of a watch-caching backend; the port's backend store is its
        own truth, so it changes nothing here."""
        report = DriftReport()
        pods = self.cluster.list_pods()
        truth_uids = {p.uid for p in pods}

        # Ghost bindings: cluster truth says bound, the cache does not —
        # the watch dropped the bind. Re-inject it. The reverse ADD gap
        # too: a pod CREATED while the watch was down exists in truth but
        # never reached the informer, so it was never queued — replay its
        # add so it schedules.
        live_cache = self.informer.live_uid_set()
        for p in pods:
            if p.node_name and not self.informer.counts_bound(p.uid):
                self._repair_event("modified", p)
                report.ghost_pods += 1
            elif p.uid not in live_cache:
                self._repair_event("added", p)
                report.ghost_pods += 1

        # Reverse ghosts: the cache believes a pod alive that cluster
        # truth no longer has — the watch dropped the deletion. Replay it
        # (releases the claim, drops gang membership, cancels its Permit
        # wait via the delete fast path, and prunes its queue entries
        # through the stack's on_change hook).
        for w in self.framework.waiting_pods():
            if w.pod.uid not in truth_uids and self._pod_truly_gone(w.pod.key):
                if self.framework.cancel_waiting(
                    w.pod.key,
                    f"pod {w.pod.key} was deleted while parked at permit "
                    "(reconciler)",
                ):
                    report.stranded_waits += 1
        for uid in self.informer.live_uid_set() - truth_uids:
            pod = self._cached_pod(uid)
            if pod is None or not self._pod_truly_gone(pod.key):
                continue
            self._repair_event("deleted", pod)
            self.queue.remove(uid)
            report.ghost_pods += 1

        # Leaked reservations: a claim with no live pod anywhere.
        for uid in self.accountant.claimed_uids() - truth_uids:
            if uid in self.informer.live_uid_set():
                continue  # the informer will release it through its path
            self.accountant.release(uid)
            report.leaked_reservations += 1

        # Adopted gangs past their window and still partial: roll back.
        now = self.clock()
        gangs = self._gang_truth(pods)
        with self._lock:
            deadlines = dict(self._adopt_deadlines)
        for name, deadline in deadlines.items():
            size, bound, _unbound = gangs.get(name, (0, [], []))
            if not bound or (size and len(bound) >= size):
                with self._lock:
                    self._adopt_deadlines.pop(name, None)
                continue
            if now < deadline:
                continue
            with self._lock:
                self._adopt_deadlines.pop(name, None)
            self._rollback_gang(
                name,
                bound,
                f"adopted gang {name} still partial ({len(bound)}/{size}) "
                f"after the {self.adopt_window_s:.0f}s failover adopt window",
            )
            report.expired_adoptions.append(name)

        if (
            report.leaked_reservations
            or report.ghost_pods
            or report.stranded_waits
            or report.expired_adoptions
        ):
            log.warning(
                "drift reconciler repaired: %d leaked reservation(s), %d "
                "ghost pod record(s), %d stranded wait(s), %d expired "
                "adoption(s)",
                report.leaked_reservations, report.ghost_pods,
                report.stranded_waits, len(report.expired_adoptions),
            )
        return report

    def _cached_pod(self, uid: str) -> "PodSpec | None":
        """The informer has uids, not specs; recover the spec from the
        node-count map or the waitlist so a synthetic delete can carry a
        real object (handlers key on pod.key/labels)."""
        with self.informer._lock:
            for pods in self.informer._pods_by_node.values():
                p = pods.get(uid)
                if p is not None:
                    return p
        for w in self.framework.waiting_pods():
            if w.pod.uid == uid:
                return w.pod
        return self.queue.find(uid)

    def adopted_gangs(self) -> "dict[str, float]":
        """Live adoption deadlines (tests, introspection)."""
        with self._lock:
            return dict(self._adopt_deadlines)

    def run_forever(self, stop: threading.Event, *, period_s: float = 30.0) -> None:
        """The background drift loop (a caller puts this on a thread once
        leadership is held). Exceptions are logged, never fatal — a
        reconciler crash must not take the serving scheduler with it."""
        while not stop.is_set():
            if stop.wait(period_s):
                return
            try:
                self.reconcile()
            except Exception:  # noqa: BLE001 — repair loop must survive
                log.exception("drift reconcile round failed; will retry")
