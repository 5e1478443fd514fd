"""Per-node health ladder + gang-whole repair — the host-death failure domain.

A TPU host dying UNDER a bound gang is invisible to admission alone:
cordon, taints and metric staleness only gate NEW placements, so a dead
host leaves its SPMD gang stalled with its chips still charged. This
module watches already-bound nodes and acts:

Ladder (per node, silence- and condition-driven)::

    HEALTHY    fresh agent publishes, all chips healthy
    DEGRADED   agent reports Unhealthy chip(s) but the host is alive —
               observational only (the kernel already avoids unhealthy
               chips); the host still serves
    SUSPECT    agent silent past node_suspect_after_s — FENCED from new
               placements (the debounce window: a publish returns it to
               HEALTHY, and a flapping heartbeat never triggers repair)
    DRAINING   operator- or upgrade-initiated (:meth:`drain`) — fenced;
               the rebalancer migrates gangs off before the deadline
               (rolling cluster upgrades)
    DOWN       agent silent past node_down_after_s, OR the TPU CR / Node
               object was deleted, OR the Node went NotReady — fenced,
               and every gang with a member on the node is REPAIRED WHOLE

Three signals feed it: agent publish staleness
(``InformerCache.last_updated_map`` — the ``last_updated_unix`` wall
clock the agents stamp), TPU CR / Node deletion and NotReady conditions
through the informer's delta feed (``standalone`` routes every applied
watch batch through :meth:`observe_events`), and per-chip health from the
publishes themselves.

Fencing rides the EXISTING host_ok admission row — no new kernel work:
:meth:`fenced_nodes` is wired as the informer's ``fence_fn``, every
snapshot carries the set (``Snapshot.fenced``), and the admission call
sites (the batch plugin's cached ``_host_admission`` row, which the card's
``fleet_eval`` and ``joint_fit`` read, the gang planner, the rebalancer's
fit checks, the speculative cache's revalidation) veto fenced hosts. Fence
flips invalidate the cached snapshot, so the vetoes are never stale; they
leave ``metrics_version`` alone, so a flip patches the admission rows and
never re-stacks the device-resident fleet.

Repair (``DOWN``) goes through the EXISTING transactional primitives,
the Gandiva discipline of migration as a first-class scheduler action
hidden behind job boundaries (PAPERS.md):

- **patch repair** (preferred): only the LOST members are re-planned.
  Topology gangs re-run ``plan_multislice_placement`` with the healthy
  members' hosts PINNED, so the replacement hosts complete the same ICI
  block and the healthy members never unbind; plain gangs just requeue
  the lost members (the Permit barrier completes around the kept ones).
  Sequence: ``take_gang -> drop_membership(lost) -> unbind lost ->
  install_plan -> readd``.
- **elastic shrink**: an elastic gang whose healthy members still meet
  ``tpu/min-members`` keeps running at the reduced size (Pollux's
  goodput argument: capacity shifted under the job, the job adapts).
- **whole requeue** (fallback): every bound member is unbound through
  ``Scheduler._rollback_bound`` and the gang re-queues untouched —
  never a split gang, never a deleted pod.

All unbind I/O fans out on the bind executor from the monitor's
background thread (leadership-gated like the rebalancer); a crash
mid-repair leaves at most a partially-bound gang — exactly what the
reconciler's warm-start resync classifies adopt-or-rolled-back-whole.

Counterpart of ``yoda_tpu/nodehealth/monitor.py``, whole, with the same
decisions. ``build_stack`` passes its ``metrics``, which the ladder,
the ghost releases and every repair feed (``yoda_node_state``,
``yoda_node_transitions_total``, ``yoda_gang_repairs_total``,
``yoda_repair_duration_ms``, the why-pending records, the trace spans and
the SLO engine's repair rate); a monitor built by hand without one skips
them behind their ``is not None`` guards. Two
clocks: ``now_fn`` is the wall clock of the agents' ``last_updated_unix``
stamps (the ladder reads it), ``clock`` the stack's monotonic clock (drain
deadlines and ``patch_grace_s`` read it).
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from yoda_tpu_torch.api.requests import LabelParseError, gang_name_of, pod_request
from yoda_tpu_torch.api.types import HEALTHY as CHIP_HEALTHY
from yoda_tpu_torch.api.types import PodSpec, pod_admits_on
from yoda_tpu_torch.framework.runtime import unbind_all
from yoda_tpu_torch.plugins.yoda.topology import plan_multislice_placement
from yoda_tpu_torch.rebalance.score import FleetOccupancy

log = logging.getLogger("yoda_tpu_torch.nodehealth")


class NodeState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    SUSPECT = "suspect"
    DRAINING = "draining"
    DOWN = "down"

    @property
    def severity(self) -> int:
        """Gauge encoding (yoda_node_state): 0=healthy 1=degraded
        2=suspect 3=draining 4=down."""
        return _SEVERITY[self]

    @property
    def fenced(self) -> bool:
        """Is the node excluded from NEW placements? DEGRADED still
        serves (the kernel already avoids its unhealthy chips);
        SUSPECT/DRAINING/DOWN are fenced."""
        return self in (NodeState.SUSPECT, NodeState.DRAINING, NodeState.DOWN)


_SEVERITY = {
    NodeState.HEALTHY: 0,
    NodeState.DEGRADED: 1,
    NodeState.SUSPECT: 2,
    NodeState.DRAINING: 3,
    NodeState.DOWN: 4,
}


@dataclass
class _NodeRecord:
    state: NodeState = NodeState.HEALTHY
    unhealthy_chips: int = 0
    # Which object kinds' deletion currently pins DOWN ("TpuNodeMetrics" /
    # "Node"); a kind's re-add clears only its own mark (the gang
    # plugin's dead_hosts discipline).
    deleted_kinds: set[str] = field(default_factory=set)
    not_ready: bool = False
    # DOWN repair owed: set on the DOWN transition, re-armed while any
    # bound pod remains on the node, cleared once the repair pass leaves
    # it empty.
    repair_pending: bool = False
    # DRAINING only: monotonic deadline after which still-bound work is
    # force-evacuated (DOWN-style repair) instead of waiting on the
    # rebalancer's migration.
    drain_deadline: float | None = None


@dataclass
class RepairReport:
    """What one monitor pass did (tests, bench, logs)."""

    patched: list[str] = field(default_factory=list)     # gang names
    shrunk: list[str] = field(default_factory=list)
    requeued: list[str] = field(default_factory=list)
    deferred: list[str] = field(default_factory=list)    # mid-flight gangs
    singles: list[str] = field(default_factory=list)     # pod keys
    durations_ms: dict[str, float] = field(default_factory=dict)

    @property
    def repaired(self) -> int:
        return len(self.patched) + len(self.shrunk) + len(self.requeued)


class NodeHealthMonitor:
    """One per stack (``standalone.build_stack``, ``Stack.nodehealth``);
    state updates ride the watch thread (:meth:`observe_events`, cheap),
    repair I/O runs on the caller's thread (:meth:`run_once`, or
    :meth:`run_forever` on a background thread, gated like the
    rebalancer). ``build_stack`` starts no loop."""

    def __init__(
        self,
        *,
        cluster,
        informer,
        accountant,
        gang,
        framework,
        queue,
        scheduler=None,
        metrics=None,
        bind_executor=None,
        suspect_after_s: float = 15.0,
        down_after_s: float = 60.0,
        drain_deadline_s: float = 300.0,
        repair: bool = True,
        clock: Callable[[], float] = time.monotonic,
        now_fn: Callable[[], float] = time.time,
        gate_fn: "Callable[[], bool] | None" = None,
    ) -> None:
        if not 0 < suspect_after_s <= down_after_s:
            raise ValueError(
                "node health thresholds must satisfy 0 < suspect_after_s "
                f"<= down_after_s, got {suspect_after_s}/{down_after_s}"
            )
        self.cluster = cluster
        self.informer = informer
        self.accountant = accountant
        self.gang = gang
        self.framework = framework
        self.queue = queue
        # Late-wired by build_stack (the scheduler is constructed after
        # the informer this monitor hangs off): _fenced + _rollback_bound.
        self.scheduler = scheduler
        self.metrics = metrics
        self.bind_executor = bind_executor
        self.suspect_after_s = suspect_after_s
        self.down_after_s = down_after_s
        self.drain_deadline_s = drain_deadline_s
        self.repair = repair
        # Prefer patch repair (lost members re-planned, healthy members
        # keep their bindings). False forces the whole-requeue fallback —
        # the bench's comparison knob, not an operator config.
        self.patch_repair = True
        # How long a patch-repaired gang may stay PARTIAL (healthy
        # members bound, replacements queued) before the monitor
        # escalates to a whole requeue — the patch's adopt-window analog:
        # capacity the fit check saw can be raced away by other repairs,
        # and a gang must never sit split forever.
        self.patch_grace_s = 60.0
        # gang name -> clock deadline for the escalation above; owned by
        # the (single) background pass thread.
        self._patched: dict[str, float] = {}
        self.clock = clock
        # Wall-clock domain of the agents' last_updated_unix stamps;
        # inject the simulated clock in virtual-time tests.
        self.now_fn = now_fn
        self.gate_fn = gate_fn
        self.scheduler_name = informer.scheduler_name
        self._lock = threading.Lock()
        self._states: dict[str, _NodeRecord] = {}
        self._fenced: frozenset[str] = frozenset()
        # Deleted nodes whose ladder record (and yoda_node_state series)
        # retires on the NEXT settled pass (bounded gauge cardinality).
        self._retire_armed: set[str] = set()
        self.passes = 0

    # --- readers ---

    def state_of(self, name: str) -> NodeState:
        with self._lock:
            rec = self._states.get(name)
            return rec.state if rec is not None else NodeState.HEALTHY

    def states(self) -> "dict[str, NodeState]":
        with self._lock:
            return {n: r.state for n, r in self._states.items()}

    def fenced_nodes(self) -> frozenset:
        """Nodes excluded from NEW placements (SUSPECT/DRAINING/DOWN) —
        wired as the informer's ``fence_fn``, so every snapshot carries
        it and the existing host_ok admission paths veto these hosts."""
        return self._fenced

    def draining_nodes(self) -> frozenset:
        with self._lock:
            return frozenset(
                n
                for n, r in self._states.items()
                if r.state is NodeState.DRAINING
            )

    # --- operator surface ---

    def drain(self, name: str, *, deadline_s: "float | None" = None) -> None:
        """Begin a graceful drain (rolling-upgrade support): the node is
        fenced from new placements immediately, the rebalancer migrates
        bound gangs off proactively, and work still on the node past the
        deadline is force-evacuated (DOWN-style repair)."""
        window = self.drain_deadline_s if deadline_s is None else deadline_s
        with self._lock:
            rec = self._states.setdefault(name, _NodeRecord())
            rec.drain_deadline = self.clock() + max(window, 0.0)
            changed = self._transition_locked(
                name, rec, NodeState.DRAINING, "drain requested"
            )
        if changed:
            self._fence_changed()

    def cancel_drain(self, name: str) -> None:
        """Abort a drain: the node returns to the ladder (HEALTHY /
        DEGRADED per its live signals on the next tick)."""
        with self._lock:
            rec = self._states.get(name)
            if rec is None or rec.state is not NodeState.DRAINING:
                return
            rec.drain_deadline = None
            target = (
                NodeState.DEGRADED
                if rec.unhealthy_chips
                else NodeState.HEALTHY
            )
            changed = self._transition_locked(
                name, rec, target, "drain cancelled"
            )
        if changed:
            self._fence_changed()

    # --- the watch-thread hook (cheap: state + ghost release only) ---

    def observe_events(self, events) -> None:
        """Condition signals from the informer's applied-batch feed
        (``standalone`` wires this into ``on_change_batch``): TPU CR /
        Node deletions and NotReady conditions pin DOWN at EVENT TIME;
        per-chip health from agent publishes feeds DEGRADED. Also the
        ghost-reservation fix: a deleted node's still-bound pods have
        their claims released NOW (counted in
        ``yoda_node_ghost_releases_total``) instead of waiting for the
        periodic reconcile. No repair I/O runs here — repair is the
        background pass's job (:meth:`run_once`)."""
        ghost_nodes: list[str] = []
        changed = False
        with self._lock:
            for event in events:
                kind = getattr(event, "kind", None)
                if kind not in ("TpuNodeMetrics", "Node"):
                    continue
                name = event.obj.name
                rec = self._states.setdefault(name, _NodeRecord())
                if event.type == "deleted":
                    rec.deleted_kinds.add(kind)
                    changed |= self._transition_locked(
                        name, rec, NodeState.DOWN, f"{kind} deleted"
                    )
                    ghost_nodes.append(name)
                    continue
                rec.deleted_kinds.discard(kind)
                if kind == "Node":
                    rec.not_ready = not getattr(event.obj, "ready", True)
                    if rec.not_ready:
                        changed |= self._transition_locked(
                            name, rec, NodeState.DOWN, "Node NotReady"
                        )
                    continue
                # TpuNodeMetrics publish: chip health + (implicitly) a
                # fresh heartbeat. The silence ladder proper runs in
                # tick(); a SUSPECT node's publish recovers it here so
                # the debounce resolves at event time, not next tick —
                # and a DOWN node whose CR is back and publishing (host
                # rebooted / replaced) rejoins the same way, as long as
                # no condition (deletion, NotReady) still pins it.
                rec.unhealthy_chips = sum(
                    1 for c in event.obj.chips if c.health != CHIP_HEALTHY
                )
                if (
                    not rec.deleted_kinds
                    and not rec.not_ready
                    and rec.state is not NodeState.DRAINING
                ):
                    target = (
                        NodeState.DEGRADED
                        if rec.unhealthy_chips
                        else NodeState.HEALTHY
                    )
                    changed |= self._transition_locked(
                        name, rec, target, "agent published"
                    )
        if ghost_nodes:
            self._release_ghosts(ghost_nodes)
        if changed:
            self._fence_changed()

    def _release_ghosts(self, nodes: "list[str]") -> None:
        """A deleted TPU CR / Node with pods still bound used to leave
        their reservations charged against the ghost row until the
        periodic reconcile; release them at event time. Idempotent (claim
        existence is checked); the pods themselves are the repair pass's
        problem — the unbind path's own unreserve is a no-op after this."""
        try:
            pods = self.cluster.list_pods()
        except Exception:  # noqa: BLE001 — partitioned front: reconcile owns it
            return
        released = 0
        gone = set(nodes)
        for p in pods:
            if p.node_name in gone and self.accountant.has_claim(p.uid):
                self.accountant.release(p.uid)
                released += 1
        if released:
            log.warning(
                "nodehealth: released %d ghost reservation(s) held on "
                "deleted node(s) %s at event time", released, sorted(gone),
            )
            if self.metrics is not None:
                self.metrics.node_ghost_releases.inc(released)

    # --- the silence ladder ---

    def tick(self) -> None:
        """Re-evaluate the ladder from agent-publish staleness. Lock-cheap,
        no I/O: silence past ``suspect_after_s`` fences the node
        (SUSPECT), continuous silence past ``down_after_s`` is DOWN; a
        publish inside the window returns a SUSPECT node to HEALTHY —
        the debounce that keeps a flapping heartbeat from ever triggering
        repair. Condition-pinned DOWN (deletion / NotReady) and DRAINING
        are not overridden by freshness."""
        now = self.now_fn()
        changed = False
        with self._lock:
            for name, ts in self.informer.last_updated_map().items():
                rec = self._states.setdefault(name, _NodeRecord())
                if (
                    rec.deleted_kinds
                    or rec.not_ready
                    or rec.state is NodeState.DRAINING
                ):
                    continue  # condition-pinned / operator-owned
                silence = now - ts
                if silence >= self.down_after_s:
                    changed |= self._transition_locked(
                        name, rec, NodeState.DOWN,
                        f"agent silent {silence:.1f}s",
                    )
                elif silence >= self.suspect_after_s:
                    if rec.state in (NodeState.HEALTHY, NodeState.DEGRADED):
                        changed |= self._transition_locked(
                            name, rec, NodeState.SUSPECT,
                            f"agent silent {silence:.1f}s",
                        )
                else:
                    target = (
                        NodeState.DEGRADED
                        if rec.unhealthy_chips
                        else NodeState.HEALTHY
                    )
                    if rec.state is not target:
                        changed |= self._transition_locked(
                            name, rec, target, "agent publishing again"
                        )
        if changed:
            self._fence_changed()

    def _transition_locked(
        self, name: str, rec: _NodeRecord, new: NodeState, why: str
    ) -> bool:
        """Apply a state change (lock held). Returns whether the FENCE
        membership changed (the caller then invalidates snapshots)."""
        old = rec.state
        if new is old:
            return False
        rec.state = new
        if new is NodeState.DOWN:
            rec.repair_pending = True
        elif old is NodeState.DOWN:
            # Recovered before (or after) repair: nothing owed anymore —
            # bound pods on a live node are simply running.
            rec.repair_pending = False
        log.warning(
            "nodehealth: node %s %s -> %s (%s)", name, old.value, new.value,
            why,
        )
        if self.metrics is not None:
            self.metrics.node_state.set(float(new.severity), node=name)
            self.metrics.node_transitions.inc()
        return old.fenced != new.fenced

    def _fence_changed(self) -> None:
        """Recompute the fence set and invalidate the cached snapshot (the
        admission vetoes read the set off the snapshot, so a flip must
        rebuild it); unfencing also reactivates parked pods — capacity
        returned."""
        with self._lock:
            new = frozenset(
                n for n, r in self._states.items() if r.state.fenced
            )
            opened = bool(self._fenced - new)
            self._fenced = new
        invalidate = getattr(self.informer, "invalidate_snapshot", None)
        if invalidate is not None:
            invalidate()
        if opened:
            self.queue.move_all_to_active()

    # --- the background pass ---

    def run_once(self) -> RepairReport:
        """One monitor pass: ladder tick, drain-deadline escalation, then
        gang-whole repair of every DOWN node owing one. Background thread
        (or a direct test/bench driver) only — repair does unbind I/O."""
        self.tick()
        report = RepairReport()
        now = self.clock()
        with self._lock:
            self.passes += 1
            for name, rec in self._states.items():
                if (
                    rec.state is NodeState.DRAINING
                    and rec.drain_deadline is not None
                    and now >= rec.drain_deadline
                ):
                    # Deadline passed with work still on the node: the
                    # rebalancer's proactive migration did not finish —
                    # force-evacuate (rolling upgrades must complete).
                    rec.repair_pending = True
                    log.warning(
                        "nodehealth: drain deadline passed on %s; "
                        "force-evacuating remaining work", name,
                    )
            targets = sorted(
                n for n, r in self._states.items() if r.repair_pending
            )
        if not self.repair:
            self._retire_deleted()
            return report
        if self.scheduler is not None and self.scheduler._fenced():
            return report  # not leading: the new leader's monitor repairs
        if targets:
            self._repair_nodes(set(targets), report)
        self._check_patches(report)
        self._retire_deleted()
        return report

    def _retire_deleted(self) -> None:
        """Bounded gauge cardinality: drop the ladder record — and its
        ``yoda_node_state{node=...}`` label series — for nodes whose TPU
        CR is deleted once no repair is owed. Without this a long-lived
        process scrapes one series per node that EVER lived; a recreated
        node starts a fresh record from its next watch event. Retirement
        is deferred one pass past settling, so the DOWN transition stays
        scrapeable for at least one monitor period."""
        removed: list[str] = []
        with self._lock:
            for name, rec in list(self._states.items()):
                if "TpuNodeMetrics" not in rec.deleted_kinds or (
                    rec.repair_pending and self.repair
                ):
                    self._retire_armed.discard(name)
                    continue
                if name not in self._retire_armed:
                    self._retire_armed.add(name)  # retire NEXT pass
                    continue
                self._retire_armed.discard(name)
                del self._states[name]
                removed.append(name)
            if removed:
                # Deleted nodes were fenced; they exist in no snapshot, so
                # shrinking the set needs no invalidation/reactivation.
                self._fenced = frozenset(
                    n for n, r in self._states.items() if r.state.fenced
                )
        if removed and self.metrics is not None:
            for name in removed:
                self.metrics.node_state.remove(node=name)

    def _check_patches(self, report: RepairReport) -> None:
        """Escalate patch repairs that never completed: the fit check's
        capacity can be raced away by competing repairs/arrivals, leaving
        the gang partial (healthy members bound, replacements parked).
        Past ``patch_grace_s`` the gang requeues WHOLE — bounded
        time-to-repair, never an indefinitely split gang."""
        if not self._patched:
            return
        now = self.clock()
        for name in list(self._patched):
            status = self.gang.gang_status(name)
            if status is None:
                self._patched.pop(name)
                continue
            size, waiting, bound = status
            eff = self.gang.effective_size(name)
            target = eff if eff is not None else size
            if bound >= target or bound == 0:
                self._patched.pop(name)  # completed (or fully requeued)
                continue
            if waiting > 0 or now < self._patched[name]:
                continue  # mid-flight / still inside the grace window
            try:
                pods = self.cluster.list_pods()
            except Exception:  # noqa: BLE001 — retry next pass
                continue
            members = [
                (p, p.node_name)
                for p in pods
                if gang_name_of(p.labels) == name
                and p.node_name
                and p.scheduler_name == self.scheduler_name
            ]
            why = (
                f"gang {name}: patch repair still partial after "
                f"{self.patch_grace_s:.0f}s; requeueing whole"
            )
            qpis = self.queue.take_gang(name)
            try:
                for pod, _host in members:
                    self.gang.drop_membership(pod)
                self._unbind_all(members, why)
            finally:
                for q in qpis:
                    self.queue.readd(q)
                self.queue.move_all_to_active()
            self._patched.pop(name)
            report.requeued.append(name)
            if self.metrics is not None:
                self.metrics.gang_repairs.inc(mode="requeue")
                self.metrics.slo.observe_repair(now=self.clock())
            log.warning("nodehealth: %s", why)

    def run_forever(
        self, stop: threading.Event, *, period_s: float = 5.0
    ) -> None:
        """The background loop (the caller puts this on a thread). Gate
        checked per tick; exceptions logged, never fatal — a monitor crash
        must not take the scheduler."""
        while not stop.is_set():
            if stop.wait(period_s):
                return
            try:
                if self.gate_fn is not None and not self.gate_fn():
                    continue
                self.run_once()
            except Exception:  # noqa: BLE001 — background loop must survive
                log.exception("node health pass failed; will retry")

    # --- repair ---

    def _tracer(self):
        tr = getattr(self.metrics, "tracer", None)
        return tr if tr is not None and tr.enabled else None

    def _unbind_all(
        self, items: "list[tuple[PodSpec, str]]", why: str
    ) -> None:
        unbind_all(self.scheduler, self.bind_executor, items, why)

    def _bound_on(
        self, pods: "list[PodSpec]", dead: set
    ) -> "tuple[dict[str, list[tuple[PodSpec, str]]], list[tuple[PodSpec, str]]]":
        """This profile's bound TPU pods grouped by gang, restricted to
        gangs/singletons with at least one member on a dead node."""
        gangs: dict[str, list[tuple[PodSpec, str]]] = {}
        singles: list[tuple[PodSpec, str]] = []
        affected: set[str] = set()
        for p in pods:
            if not p.node_name or p.scheduler_name != self.scheduler_name:
                continue
            try:
                req = pod_request(p)
            except LabelParseError:
                continue
            if not req.wants_tpu:
                continue
            name = gang_name_of(p.labels)
            if name:
                gangs.setdefault(name, []).append((p, p.node_name))
                if p.node_name in dead:
                    affected.add(name)
            elif p.node_name in dead:
                singles.append((p, p.node_name))
        return {n: m for n, m in gangs.items() if n in affected}, singles

    @staticmethod
    def _spec_of(pods: "list[PodSpec]"):
        for p in pods:
            try:
                spec = pod_request(p).gang
            except LabelParseError:
                continue
            if spec is not None:
                return spec
        return None

    def _repair_nodes(self, dead: set, report: RepairReport) -> None:
        try:
            pods = self.cluster.list_pods()
        except Exception:  # noqa: BLE001 — unreadable front: retry next pass
            log.exception("nodehealth: cannot list pods; repair deferred")
            return
        snapshot = self.informer.snapshot()
        occ = FleetOccupancy.from_snapshot(
            snapshot, self.accountant.chips_by_node()
        )
        fenced = self.fenced_nodes()
        gangs, singles = self._bound_on(pods, dead)
        for name in sorted(gangs):
            self._repair_gang(
                name, gangs[name], dead, snapshot, occ, fenced, report
            )
        for pod, host in singles:
            why = f"node {host} is down; pod requeued by the health monitor"
            self.scheduler._rollback_bound(pod, host, None, why)
            report.singles.append(pod.key)
            if self.metrics is not None:
                self.metrics.pending.record(
                    pod.key, kind="node-repair", message=why
                )
        if singles:
            # The rollback path parks requeued pods in backoff; promote
            # them now — repair IS the capacity-changing event.
            self.queue.move_all_to_active()
        # Re-arm: any of our pods still bound on a dead node (an unbind
        # was refused, a gang deferred mid-flight) keeps the repair owed;
        # an emptied node is done.
        try:
            left = {
                p.node_name
                for p in self.cluster.list_pods()
                if p.node_name in dead
                and p.scheduler_name == self.scheduler_name
            }
        except Exception:  # noqa: BLE001
            left = dead
        with self._lock:
            for name in dead:
                rec = self._states.get(name)
                if rec is not None:
                    rec.repair_pending = name in left
        if report.repaired or report.singles:
            log.info(
                "nodehealth: repaired %d gang(s) (%d patched, %d shrunk, "
                "%d requeued whole), %d singleton(s) requeued, for dead "
                "node(s) %s",
                report.repaired, len(report.patched), len(report.shrunk),
                len(report.requeued), len(report.singles), sorted(dead),
            )

    def _repair_gang(
        self, name, members, dead, snapshot, occ, fenced, report
    ) -> None:
        """Repair ONE gang whole. Preference order: patch (replace only
        the lost members — healthy bindings survive), elastic shrink
        toward the floor, whole unbind-and-requeue. Traced as one
        ``repair`` span with detect/fence/patch-or-requeue child steps on
        the gang's lifetime trace."""
        status = self.gang.gang_status(name)
        if status is not None and status[1] > 0:
            # Members waiting at Permit (a release may be mid-fan-out):
            # the gang plugin's own host-death cascade owns that window —
            # repair retries once the release settles (repair stays
            # armed via the bound-pods re-check).
            report.deferred.append(name)
            return
        t0 = self.clock()
        lost = [(p, h) for p, h in members if h in dead]
        healthy = [(p, h) for p, h in members if h not in dead]
        pods = [p for p, _ in members]
        spec = self._spec_of(pods)
        tr = self._tracer()
        subj = f"gang:{name}"
        span = tr.new_span_id() if tr is not None else None

        def step(step_name: str, **attrs) -> None:
            if tr is not None:
                tr.add(
                    subj, step_name, parent=span, track="nodehealth",
                    attrs=attrs,
                )

        step(
            "repair-detect",
            nodes=",".join(sorted({h for _, h in lost})),
            lost=len(lost), healthy=len(healthy),
        )
        step("repair-fence", fenced=len(fenced))
        mode = "requeue"
        plan = None
        if spec is not None and self.patch_repair and healthy:
            if spec.topology is not None:
                plan = self._patch_plan(
                    spec, healthy, snapshot, occ, fenced, dead
                )
                if plan is not None:
                    mode = "patch"
            elif self._lost_fit(lost, snapshot, occ, fenced, dead):
                # Plain gang: the kept members satisfy the barrier in
                # place; only the lost ones requeue and re-admit.
                mode = "patch"
        if (
            mode == "requeue"
            and spec is not None
            and spec.elastic
            and len(healthy) >= spec.floor
        ):
            mode = "shrink"
        qpis = self.queue.take_gang(name)
        try:
            why = (
                f"gang {name}: member host(s) "
                f"{sorted({h for _, h in lost})} went down; "
                f"{mode} repair by the node health monitor"
            )
            if mode == "shrink":
                self.gang.set_effective_size(name, len(healthy))
            to_unbind = members if mode == "requeue" else lost
            for pod, _host in to_unbind:
                self.gang.drop_membership(pod)
            self._unbind_all(list(to_unbind), why)
            if mode == "patch" and plan is not None:
                self.gang.install_plan(name, spec, plan)
            if mode == "patch":
                # Arm the escalation: a patch that cannot complete (its
                # capacity raced away) becomes a whole requeue after the
                # grace window — see _check_patches.
                self._patched[name] = self.clock() + self.patch_grace_s
            step(f"repair-{mode}", unbound=len(to_unbind))
            if self.metrics is not None:
                self.metrics.gang_repairs.inc(mode=mode)
                # SLO engine: every gang-whole repair feeds the fleet
                # repair-rate SLI.
                self.metrics.slo.observe_repair(now=self.clock())
                for pod, host in lost:
                    self.metrics.pending.record(
                        pod.key,
                        kind="node-repair",
                        message=(
                            f"host {host} went down; member "
                            f"{'requeued whole with its gang' if mode == 'requeue' else 'replaced (' + mode + ' repair)'}"
                        ),
                        gang=name,
                    )
            getattr(report, {"patch": "patched", "shrink": "shrunk"}.get(
                mode, "requeued"
            )).append(name)
        finally:
            for q in qpis:
                self.queue.readd(q)
            self.queue.move_all_to_active()
            ms = (self.clock() - t0) * 1e3
            report.durations_ms[name] = ms
            if self.metrics is not None:
                self.metrics.repair_duration.observe(ms)
            if tr is not None:
                tr.add(
                    subj, "repair",
                    t0=t0, t1=self.clock(),
                    span_id=span, track="nodehealth",
                    attrs={
                        "mode": mode,
                        "lost": len(lost),
                        "kept": len(healthy) if mode != "requeue" else 0,
                    },
                )
        log.warning(
            "nodehealth: gang %s repaired (%s): %d lost member(s) on %s, "
            "%d healthy member(s) %s",
            name, mode, len(lost), sorted({h for _, h in lost}),
            len(healthy),
            "kept bound" if mode != "requeue" else "requeued too",
        )

    def _patch_plan(self, spec, healthy, snapshot, occ, fenced, dead):
        """A multislice plan that COMPLETES the block around the healthy
        members (pinned) using live in-slice hosts — the patch target. The
        requeued lost members then admit straight onto the installed
        plan's free hosts."""
        pinned = {}
        for _pod, host in healthy:
            if host not in snapshot:
                return None  # a kept host left the snapshot: replan whole
            ni = snapshot.get(host)
            if ni.tpu is None:
                return None
            pinned[host] = ni.tpu.topology_coords
        try:
            chips = max(pod_request(healthy[0][0]).effective_chips, 1)
        except LabelParseError:
            chips = 1
        pod0 = healthy[0][0]
        return plan_multislice_placement(
            snapshot,
            want_dims=spec.topology,
            slices=spec.slices,
            host_ok=lambda ni: (
                ni.name not in dead
                and ni.name not in fenced
                and occ.free_chips(ni.name) >= chips
                and pod_admits_on(ni.node, pod0)[0]
            ),
            pinned=pinned,
        )

    def _lost_fit(self, lost, snapshot, occ, fenced, dead) -> bool:
        """Can the LOST members re-place on live capacity right now? A
        greedy claimable walk on a cloned occupancy (the joint fit gate's
        shape). False = no replacement capacity — whole-requeue instead,
        so the healthy members' chips free up for whoever can use them."""
        sim = occ.clone()
        for pod, _host in lost:
            try:
                chips = max(pod_request(pod).effective_chips, 1)
            except LabelParseError:
                chips = 1
            best, best_free = None, -1
            for ni in snapshot.infos():
                if ni.name in dead or ni.name in fenced:
                    continue
                f = sim.free_chips(ni.name)
                if f >= chips and f > best_free and pod_admits_on(
                    ni.node, pod
                )[0]:
                    best, best_free = ni.name, f
            if best is None:
                return False
            sim.occupy(best, chips)
        return True
