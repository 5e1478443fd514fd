"""The Federation coordinator: several cluster fronts behind one scheduler.

Design rule (Pollux's separation, PAPERS.md): the expensive control actions
— health probes, remote-cluster resync, spillover migration — run on ONE
background thread (:meth:`Federation.run_forever`), never on any cluster's
serve loop. The serve loops only ever read a per-member fence (three cheap
predicate reads), so a partitioned remote degrades the federation to
local-only placement at full speed instead of serializing placement behind
dead-cluster timeouts.

Per-member invariants:

- **Fencing**: a member's scheduler may bind only while (a) the process
  holds leadership, (b) the member's health state is serving (UP or
  DEGRADED — PARTITIONED/LOST clusters make no API writes), and (c) the
  member's warm-start resync gate is open. The gate CLOSES when a cluster
  falls to PARTITIONED/LOST and re-opens only after its reconciler
  resync completes on rejoin — no post-partition bind can precede the
  reconciliation of what happened during the silence.
- **Spillover** (home = ``members[0]``): a gang the home cluster provably
  cannot fit whole is migrated — all members, exactly one target cluster,
  never split — to the first healthy secondary whose snapshot fits it.
  Fit checks against each candidate reuse the cross-gang consumption-
  ledger discipline of the joint gang pass: gangs spilled toward the same
  target within one pass see each other's simulated claims, so two gangs
  cannot both be promised the same remote chips. The home queue entries
  are held by the migrator for the whole evaluation+migration window
  (``SchedulingQueue.take_gang``), which is what makes "no cross-cluster
  double bind" structural rather than probabilistic.

Counterpart of ``yoda_tpu/federation/federation.py``, whole. Every
member's stack evaluates where its configuration says (on the card unless
``kernel_platform: cpu``): its serve loop launches ``fleet_eval`` for the
member's singletons and gangs, and a target's joint pass over spilled
plain gangs launches ``joint_fit``. ``_gang_fits`` stays a host predicate,
as in the reference.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from yoda_tpu_torch.api.requests import LabelParseError, pod_request
from yoda_tpu_torch.api.types import PodSpec, pod_admits_on
from yoda_tpu_torch.federation.health import ClusterHealthMonitor, ClusterState
from yoda_tpu_torch.framework.queue import QueuedPodInfo

log = logging.getLogger("yoda_tpu_torch.federation")


def _always_leading() -> bool:
    return True


@dataclass
class FederationMember:
    """One cluster front: its API handle, its fully-wired scheduler stack
    (own informer, accountant, gang plugin, reconciler — cluster capacity
    is disjoint, so nothing is shared across members except the metrics
    registry), and its health monitor."""

    name: str
    cluster: object
    stack: object  # standalone.Stack
    health: ClusterHealthMonitor
    # The process-wide leader gate (cli wires the lease elector's
    # is_leader into every member): leadership is per-process, health is
    # per-cluster, and a member binds only under both.
    leader_fn: Callable[[], bool] = field(default=_always_leading)


class Federation:
    def __init__(
        self,
        members: "list[FederationMember]",
        *,
        metrics=None,
        spillover: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if not members:
            raise ValueError("a federation needs at least one member")
        names = [m.name for m in members]
        if len(set(names)) != len(names):
            raise ValueError(f"member names must be distinct: {names}")
        self.members = list(members)
        self.metrics = metrics
        self.spillover = spillover
        self.clock = clock
        self._lock = threading.Lock()
        # (member, pod key) home deletions that failed mid-migration; the
        # pod already lives whole on the target and its home queue entries
        # were consumed, so the lingering home copy is inert — retried
        # every health pass until the delete lands.
        self._retry_deletes: "list[tuple[FederationMember, str]]" = []
        self.spillover_gangs = 0
        for m in self.members:
            m.health.on_transition = self._make_on_transition(m)
            m.stack.scheduler.fence_fn = self._make_fence(m)
            if metrics is not None:
                metrics.cluster_state.set(
                    m.health.state.severity, cluster=m.name
                )

    # --- wiring ---

    @property
    def home(self) -> FederationMember:
        return self.members[0]

    def set_leader_gate(self, fn: Callable[[], bool]) -> None:
        """Wire the process-wide leader gate (cli: elector.is_leader) into
        every member's fence."""
        for m in self.members:
            m.leader_fn = fn

    def _make_fence(self, m: FederationMember) -> Callable[[], bool]:
        reconciler = m.stack.reconciler

        def admitted() -> bool:
            # True = this member may bind. Three cheap predicate reads —
            # the serve loop pays nothing for federation membership.
            return (
                m.leader_fn()
                and m.health.state.serving
                and reconciler.resynced.is_set()
            )

        return admitted

    def _make_on_transition(self, m: FederationMember):
        def on_transition(old: ClusterState, new: ClusterState) -> None:
            if self.metrics is not None:
                self.metrics.cluster_transitions.inc(cluster=m.name)
                self.metrics.cluster_state.set(new.severity, cluster=m.name)
            if old.serving and not new.serving:
                # Close the warm-start gate: whatever happened during the
                # silence (binds that landed, pods that died) must be
                # reconciled through the reconciler's resync before this
                # cluster binds again. The fence reads this, so the
                # member's serve loop parks its queue without blocking.
                m.stack.reconciler.resynced.clear()

        return on_transition

    # --- readiness (the degraded-readiness contract) ---

    def ready(self) -> bool:
        """/readyz in federated mode: ready once the HOME cluster has
        resynced. A remote member must either be resynced too or be
        verifiably out (PARTITIONED/LOST) — a dead remote must never
        wedge the standby's readiness forever, while a reachable remote
        that simply has not resynced yet still holds readiness back (it
        will, within one health pass)."""
        if not self.home.stack.reconciler.resynced.is_set():
            return False
        for m in self.members[1:]:
            if m.stack.reconciler.resynced.is_set():
                continue
            if m.health.state in (ClusterState.PARTITIONED, ClusterState.LOST):
                continue
            return False
        return True

    def states(self) -> "dict[str, ClusterState]":
        return {m.name: m.health.state for m in self.members}

    # --- the background control loop ---

    def health_pass(self) -> "dict[str, ClusterState]":
        """Probe every member, run state transitions, warm-start members
        whose resync gate is closed but whose cluster answers again, and
        retry stale home deletions. All I/O lives here — this is the
        thread the serve loops never wait on."""
        for m in self.members:
            m.health.probe()
        self._drain_retry_deletes()
        for m in self.members:
            if not m.health.state.serving:
                continue
            if m.stack.reconciler.resynced.is_set():
                continue
            # Rejoin (or first boot): warm-start through the reconciler —
            # resync rebuilds reservations from cluster truth and adopts
            # or rolls back partially-bound gangs; the drift pass repairs
            # what the watch stream dropped during the silence. Failure
            # leaves the gate closed; retried next pass.
            try:
                m.stack.reconciler.resync()
                m.stack.reconciler.reconcile(relist=False)
            except Exception:  # noqa: BLE001 — cluster may have dropped again
                log.exception(
                    "cluster %s: rejoin resync failed; member stays fenced",
                    m.name,
                )
                continue
            m.stack.queue.move_all_to_active()
            log.info(
                "cluster %s: resynced and serving (state %s)",
                m.name, m.health.state.value,
            )
        if self.metrics is not None:
            for m in self.members:
                self.metrics.cluster_state.set(
                    m.health.state.severity, cluster=m.name
                )
        return self.states()

    def _drain_retry_deletes(self) -> None:
        with self._lock:
            pending, self._retry_deletes = self._retry_deletes, []
        kept: "list[tuple[FederationMember, str]]" = []
        for member, key in pending:
            # Fence-before-write: no longer leader
            # for this cluster front means no API writes — the lingering
            # home copy is inert (no queue entry), so it keeps until
            # leadership returns or the new leader's drift reconciler
            # retires it.
            if member.stack.scheduler._fenced():
                kept.append((member, key))
                continue
            try:
                member.cluster.delete_pod(key)
            except Exception:  # noqa: BLE001 — keep retrying
                kept.append((member, key))
        if kept:
            with self._lock:
                self._retry_deletes.extend(kept)

    def run_forever(
        self, stop: threading.Event, *, period_s: float = 1.0
    ) -> None:
        """The federation control loop (cli puts this on one thread):
        health probes, rejoin resyncs, spillover migration. Exceptions are
        logged, never fatal — a control-plane hiccup must not take the
        serving schedulers with it."""
        while not stop.is_set():
            try:
                self.health_pass()
                self.spillover_pass()
            except Exception:  # noqa: BLE001 — control loop must survive
                log.exception("federation control pass failed; will retry")
            if stop.wait(period_s):
                return

    # --- spillover routing ---

    def spillover_pass(self) -> int:
        """Migrate gangs the home cluster provably cannot fit whole to the
        first healthy secondary that can. Returns the number of gangs
        migrated. All-or-nothing per gang: a gang is either untouched at
        home or whole on exactly one target — never split, never copied."""
        if not self.spillover or len(self.members) < 2:
            return 0
        home = self.home
        if (
            home.health.state is not ClusterState.UP
            or not home.stack.reconciler.resynced.is_set()
        ):
            # Spillover migrates pods OFF the home API: only meaningful
            # while home is fully healthy and reconciled.
            return 0
        pending = home.stack.queue.pending_gangs()
        if not pending:
            return 0
        migrated = 0
        # Per-target consumption ledgers for THIS pass (the joint-pass
        # dispatch discipline, applied across clusters): gang g+1's fit
        # check against a target sees the chips gang g was just promised.
        sims: "dict[str, dict[str, int]]" = {
            m.name: {} for m in self.members
        }
        for gang in sorted(pending):
            count, min_attempts = pending[gang]
            if min_attempts < 1:
                continue  # has not failed a home cycle yet: not stuck
            status = home.stack.gang.gang_status(gang)
            if status is not None and (status[1] > 0 or status[2] > 0):
                continue  # members waiting at Permit or bound: mid-flight
            qpis = home.stack.queue.take_gang(gang)
            pods = [q.pod for q in qpis]
            size = _gang_size(pods)
            if size is None or len(pods) < size:
                # Not the whole gang in hand (members mid-cycle, or not
                # yet created): migrating a subset would split the gang
                # across clusters — the one thing spillover must never do.
                self._readd(home, qpis)
                continue
            if _gang_fits(home.stack, pods, sims[home.name]):
                # Home can fit it now (capacity freed since it parked):
                # local placement always beats migration.
                self._readd(home, qpis)
                continue
            target = None
            for m in self.members[1:]:
                if m.health.state is not ClusterState.UP:
                    continue  # sick clusters take no NEW work
                if m.stack.scheduler._fenced():
                    continue  # per-cluster leader fence: no split-brain
                if _gang_fits(m.stack, pods, sims[m.name]):
                    target = m
                    break
            if target is None:
                self._readd(home, qpis)
                continue
            if self._migrate(home, target, gang, qpis):
                migrated += 1
        return migrated

    @staticmethod
    def _readd(member: FederationMember, qpis: "list[QueuedPodInfo]") -> None:
        for q in qpis:
            member.stack.queue.readd(q)

    def _migrate(
        self,
        home: FederationMember,
        target: FederationMember,
        gang: str,
        qpis: "list[QueuedPodInfo]",
    ) -> bool:
        """Create the whole gang on ``target``, then retire the home
        copies. Create-first is safe because the home queue entries are in
        hand: even while both copies exist, home cannot bind (entries
        taken) and only target's scheduler can place the gang. A failed
        target create rolls the created copies back and returns the gang
        to the home queue untouched; a failed home delete is retried by
        the health pass (the lingering home copy has no queue entry, so
        it is inert — no double bind either way)."""
        tracer = getattr(self.metrics, "tracer", None)
        if tracer is not None and not tracer.enabled:
            tracer = None
        t0 = time.monotonic()
        pods = [q.pod for q in qpis]
        created: "list[PodSpec]" = []
        for pod in pods:
            clone = copy.deepcopy(pod)
            clone.node_name = None
            clone.phase = "Pending"
            clone.nominated_node_name = None
            try:
                target.cluster.create_pod(clone)
            except Exception:  # noqa: BLE001 — all-or-nothing
                log.exception(
                    "spillover: creating %s on cluster %s failed; rolling "
                    "back the migration of gang %s",
                    pod.key, target.name, gang,
                )
                for c in created:
                    try:
                        target.cluster.delete_pod(c.key)
                    except Exception:  # noqa: BLE001 — best effort
                        log.exception(
                            "spillover rollback: could not delete %s from "
                            "cluster %s", c.key, target.name,
                        )
                self._readd(home, qpis)
                if tracer is not None:
                    tracer.add(
                        f"gang:{gang}", "spillover",
                        t0=t0, t1=time.monotonic(), track="federation",
                        attrs={
                            "home": home.name, "target": target.name,
                            "members": len(pods), "aborted": "create-failed",
                        },
                    )
                return False
            created.append(clone)
        for pod in pods:
            try:
                home.cluster.delete_pod(pod.key)
            except Exception:  # noqa: BLE001 — retried by the health pass
                log.exception(
                    "spillover: deleting home copy %s failed; will retry",
                    pod.key,
                )
                with self._lock:
                    self._retry_deletes.append((home, pod.key))
        with self._lock:
            self.spillover_gangs += 1
        if self.metrics is not None:
            self.metrics.spillover_gangs.inc()
        if tracer is not None:
            # The gang's trace crosses clusters here: the span joins the
            # same trace_id its home-cluster cycles recorded under, so the
            # migrated story stays one connected walk.
            tracer.add(
                f"gang:{gang}", "spillover",
                t0=t0, t1=time.monotonic(), track="federation",
                attrs={
                    "home": home.name, "target": target.name,
                    "members": len(pods), "aborted": "",
                },
            )
        log.info(
            "spillover: migrated gang %s (%d member(s)) %s -> %s",
            gang, len(pods), home.name, target.name,
        )
        return True


def _gang_size(pods: "list[PodSpec]") -> "int | None":
    for pod in pods:
        try:
            spec = pod_request(pod).gang
        except LabelParseError:
            continue
        if spec is not None:
            return spec.size
    return None


def _gang_fits(stack, pods: "list[PodSpec]", sim: "dict[str, int]") -> bool:
    """Host-side whole-gang fit check against one cluster's snapshot, net
    of its accountant's reservations AND ``sim`` (chips already promised
    to earlier gangs this spillover pass — the shared consumption ledger).
    Mirrors the joint fit gate's shape: the real multislice block
    planner for topology gangs, a greedy claimable walk for plain gangs.
    A PREDICATE, not a placement: the target's own scheduling pass
    re-validates everything, so a wrong "fits" degrades to a normal
    admission park on the target (and the gang spills again or returns);
    a wrong "does not fit" just delays migration one pass."""
    from yoda_tpu_torch.plugins.yoda.filter_plugin import (
        available_chips,
        node_fits_resources,
    )

    reqs = []
    for pod in pods:
        try:
            req = pod_request(pod)
        except LabelParseError:
            return False
        if req.gang is None:
            return False
        reqs.append(req)
    if not reqs:
        return False
    snapshot = stack.informer.snapshot()
    reserved = stack.accountant.chips_by_node()
    spec = reqs[0].gang
    if spec.topology is not None:
        from yoda_tpu_torch.plugins.yoda.topology import plan_multislice_placement

        req0 = reqs[0]
        chips = max(req0.effective_chips, 1)

        def host_ok(ni) -> bool:
            if ni.tpu is None:
                return False
            if not pod_admits_on(ni.node, pods[0])[0]:
                return False
            if not node_fits_resources(ni, pods[0], None)[0]:
                return False
            r = reserved.get(ni.name, 0) + sim.get(ni.name, 0)
            return available_chips(ni.tpu, req0, r) >= chips

        plan = plan_multislice_placement(
            snapshot,
            want_dims=spec.topology,
            slices=spec.slices,
            host_ok=host_ok,
        )
        if plan is None:
            return False
        for host in sorted(plan)[: len(pods)]:
            sim[host] = sim.get(host, 0) + chips
        return True
    # Plain gang: greedy claimable walk, one member at a time, each seeing
    # capacity net of the previously-walked members (and earlier gangs).
    tentative = dict(sim)
    for pod, req in zip(pods, reqs):
        chips = max(req.effective_chips, 1)
        best: "str | None" = None
        best_avail = -1
        for ni in snapshot.infos():
            if ni.tpu is None:
                continue
            if not pod_admits_on(ni.node, pod)[0]:
                continue
            if not node_fits_resources(ni, pod, None)[0]:
                continue
            r = reserved.get(ni.name, 0) + tentative.get(ni.name, 0)
            avail = available_chips(ni.tpu, req, r)
            if avail >= chips and avail > best_avail:
                best, best_avail = ni.name, avail
        if best is None:
            return False
        tentative[best] = tentative.get(best, 0) + chips
    sim.clear()
    sim.update(tentative)
    return True
