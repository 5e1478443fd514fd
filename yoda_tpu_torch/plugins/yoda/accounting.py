"""Chip accounting: Reserve/Unreserve plus lifecycle tracking.

Net-new vs the reference, which had NO schedule-time accounting (reference
pkg/yoda/scheduler.go has no Reserve hook; SURVEY.md §3.3). Model:

- TPU chips are exclusive: a pod occupies ``effective_chips`` whole chips
  from Reserve until the pod is DELETED (not merely bound — a running pod
  keeps its chips).
- ``chips_in_use(node)`` feeds the evaluation's reservation predicate, so
  in-flight reservations and long-running pods both subtract from
  schedulable capacity immediately, independent of metrics-agent refresh lag.
- State is reconstructible from the API server: the accountant is a watcher;
  on replay it re-counts bound pods.

Counterpart of ``yoda_tpu/plugins/yoda/accounting.py``, ported as far as the
singleton and gang paths reach it: a gang's Permit rejection, cascade and
bind rollback all release through ``unreserve`` (``release``), and an
unbound pod's watch event leaves the claim for that release to drop, as
in the reference; the reservation delta feed
(:meth:`ChipAccountant.reserved_changes_since`) keeps the resident
dynamics row current in O(changed). The durable claim journal is here
(every claim mutation is recorded write-ahead, under the accountant's lock,
through the attached ``CommitLog``), and so are the scheduler lanes'
optimistic commit (a lane's Reserve STAGES its claim; ``commit_staged``
validates first-staged-wins against per-node healthy capacity, which
``track_capacity`` keeps from the TPU CR stream; ``hold_commits`` /
``resume_commits`` quiesce it for a live resize; ``commit_residue``
finalizes a crash's residue) and the warm start (``restore`` from a
journal replay, ``adopt_warm`` from a tailer's mirror, ``replayed`` /
``replayed_gangs`` for the reconciler), and the worker-side
``RemoteAccountant`` of process-mode lanes, whose every claim decision
crosses the commit RPC (``framework/procserve.py``) to the parent's
journal-owning accountant first.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

from yoda_tpu_torch.api.requests import LabelParseError, gang_name_of, pod_request
from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.cluster.fake import Event
from yoda_tpu_torch.cluster.informer import ring_since
from yoda_tpu_torch.framework.cyclestate import SHARD_STATE_KEY, CycleState
from yoda_tpu_torch.framework.interfaces import ReservePlugin, Status
from yoda_tpu_torch.plugins.yoda.filter_plugin import get_request


@dataclass
class _Claim:
    node: str
    chips: int
    # Scheduler shard-out (framework/shards.py): a claim made by a shard's
    # cycle is STAGED — charged into _in_use immediately (its own shard's
    # later cycles must see it) but pending the optimistic commit
    # validation. ``shard`` is None for committed/legacy claims; ``seq``
    # is the global stage order (first-staged wins at validation).
    shard: "str | None" = None
    seq: int = 0
    # Gang name for staged claims (durable-journal records carry it so a
    # promoted standby can resume a mid-gang crash from its staged
    # claims instead of rolling the gang back); "" for singletons.
    gang: str = ""


class ChipAccountant(ReservePlugin):
    name = "yoda-accountant"

    def __init__(
        self,
        *,
        scheduler_name: str = "yoda-tpu",
        scheduler_names: "tuple[str, ...] | None" = None,
    ) -> None:
        # All schedulerNames this process serves (profiles share ONE
        # accountant — separate accountants would let two profiles
        # double-book a node inside the reserve->bind-event window).
        self.scheduler_names = frozenset(scheduler_names or (scheduler_name,))
        self.scheduler_name = scheduler_name
        self._lock = threading.Lock()
        self._claims: dict[str, _Claim] = {}  # pod uid -> claim
        self._in_use: dict[str, int] = {}     # node -> chips
        # Reservation delta feed (dyn row 1 of the device-resident fleet
        # state, ops/resident.py): epoch bumped per node-total change,
        # bounded ring of (epoch, node) so a consumer can apply only the
        # nodes whose reservations moved since its last sync instead of
        # copying the whole map per dispatch.
        self._epoch = 0
        self._changes: deque[tuple[int, str]] = deque(maxlen=65536)
        # Optimistic claim->validate->commit (scheduler shard-out): the
        # shared commit point N parallel serve loops validate
        # their staged claims against. _staged indexes the (few) in-flight
        # staged claims by uid; _stage_seq orders them (the validation's
        # precedence: a later-staged claim loses to an earlier one on an
        # oversubscribed node). track_capacity flips on in sharded
        # assemblies only — it makes handle() maintain per-node healthy
        # chip capacities from the TPU CR stream so commit_staged can
        # validate without touching any other component's lock (the lock
        # DAG forbids informer reads under the accountant lock).
        self._staged: set[str] = set()
        self._stage_seq = 0
        # Live shard resize (ShardSet.resize): the commit QUIESCE
        # barrier. Cleared, commit_staged waits (bounded) before
        # validating, so the resizer gets one instant where no commit is
        # mid-validation while it swaps the rendezvous map and reroutes
        # queues. Staged claims themselves stay valid across the swap —
        # validation is partition-agnostic — which is how in-flight
        # gangs complete on their staged claims through a resize.
        self._commit_gate = threading.Event()
        self._commit_gate.set()
        self.track_capacity = False
        self._capacity: dict[str, int] = {}   # node -> healthy chips
        self.commit_commits = 0               # committed stage groups
        self.commit_conflicts = 0             # commits refused (validation)
        # Durable claim journal (journal/): the
        # CommitLog this accountant reports every state mutation to,
        # WRITE-AHEAD (record durable before the in-memory mutation
        # applies). None = journal off (`journal_path` unset): the guard
        # below is one attribute test, zero new hot-path work.
        self.journal = None
        # True once restore() seeded state from a journal replay — the
        # reconciler's warm resync diverges on this instead of
        # rebuilding from scratch.
        self.replayed = False
        # gang name -> staged-claim uids from the replay (the mid-gang
        # crash residue the warm resync adopts).
        self.replayed_gangs: dict[str, set[str]] = {}

    # --- ReservePlugin ---

    def reserve(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        req = get_request(state)
        shard = None
        if state.contains(SHARD_STATE_KEY):
            shard = state.read(SHARD_STATE_KEY).shard
        self._claim(
            pod.uid, node_name, req.effective_chips, shard=shard,
            gang=gang_name_of(pod.labels) or "",
        )
        return Status.ok()

    def unreserve(self, state: CycleState, pod: PodSpec, node_name: str) -> None:
        self.release(pod.uid)

    # --- lifecycle (watch events) ---

    def handle(self, event: Event) -> None:
        if event.kind == "TpuNodeMetrics" and self.track_capacity:
            # Sharded mode only: per-node healthy chip capacity, the
            # commit validator's denominator. Maintained here (the
            # accountant is already a watcher) instead of reading the
            # informer at commit time — the lock-ordering DAG forbids an
            # informer acquisition under the accountant lock.
            tpu = event.obj
            with self._lock:
                if event.type == "deleted":
                    self._capacity.pop(tpu.name, None)
                else:
                    self._capacity[tpu.name] = len(tpu.healthy_chips())
        if event.kind != "Pod":
            return
        pod: PodSpec = event.obj  # type: ignore[assignment]
        if event.type == "deleted":
            self.release(pod.uid)
        elif pod.node_name:
            # Bound pod (new bind, or replay after restart): ensure counted —
            # but only pods that occupy chips: ours (we reserve a chip even
            # for label-less pods, filter.go:14-15 semantics) or any pod that
            # expresses a TPU request. Foreign non-TPU pods (daemonsets etc.)
            # hold no chips.
            try:
                req = pod_request(pod)
            except LabelParseError:
                # Malformed tpu/* labels: still account what is knowable.
                # A google.com/tpu resource limit attaches real chips no
                # matter what the labels say — dropping the claim would turn
                # this pod's usage into stale-freed credit
                # (filter_plugin.stale_freed_chips) and double-book it.
                if pod.tpu_resource_limit > 0:
                    self._claim(
                        pod.uid, pod.node_name, pod.tpu_resource_limit
                    )
                    return
                if pod.scheduler_name not in self.scheduler_names:
                    return
                req = None
            if req is not None and not req.wants_tpu and (
                pod.scheduler_name not in self.scheduler_names
            ):
                return
            chips = req.effective_chips if req is not None else 1
            self._claim(pod.uid, pod.node_name, chips)

    # --- internals / readers ---

    def _note(self, node: str) -> None:
        """Record a node-total change on the delta feed (lock held)."""
        self._epoch += 1
        self._changes.append((self._epoch, node))

    def _claim(
        self,
        uid: str,
        node: str,
        chips: int,
        *,
        shard: "str | None" = None,
        gang: str = "",
        seq: "int | None" = None,
    ) -> None:
        with self._lock:
            existing = self._claims.get(uid)
            if existing is not None and existing.node == node:
                # reserve->bind transition: single claim. A STAGED
                # claim stays staged through its own bind's watch
                # event — only commit_staged (validation) or the
                # reconciler's residue pass finalizes it.
                return
            if seq is None:
                seq = self._stage_seq + 1 if shard is not None else 0
            if self.journal is not None:
                # Write-ahead: the record is durable before the state
                # moves; a crash between the two is repaired by the
                # standby's replay + divergence resync.
                self.journal.record_stage(uid, node, chips, shard, seq, gang)
            if existing is not None:
                self._in_use[existing.node] -= existing.chips
                self._note(existing.node)
                self._staged.discard(uid)
            if shard is not None:
                # max(), not assignment: a RemoteAccountant mirror
                # applies PARENT-assigned seqs, which may arrive after a
                # later local observation (another worker staged in
                # between at the parent).
                self._stage_seq = max(self._stage_seq, seq)
                self._staged.add(uid)
            self._claims[uid] = _Claim(
                node, chips, shard=shard, seq=seq, gang=gang
            )
            self._in_use[node] = self._in_use.get(node, 0) + chips
            self._note(node)

    def release(self, uid: str) -> None:
        with self._lock:
            claim = self._claims.get(uid)
            if claim is not None:
                if self.journal is not None:
                    # A staged claim's release is a ROLLBACK record, a
                    # committed claim's a RELEASE — replay treats both
                    # as claim removal; the split is operator forensics.
                    if claim.shard is not None:
                        self.journal.record_rollback(uid)
                    else:
                        self.journal.record_release(uid)
                del self._claims[uid]
                self._staged.discard(uid)
                self._in_use[claim.node] = max(
                    self._in_use.get(claim.node, 0) - claim.chips, 0
                )
                self._note(claim.node)

    # --- optimistic claim -> validate -> commit (scheduler shard-out) ---

    def stage(
        self,
        uid: str,
        node: str,
        chips: int,
        shard: str,
        gang: str = "",
    ) -> int:
        """Stage one claim on behalf of a REMOTE shard worker — the
        commit RPC server's entry point (framework/procserve.py;
        multi-process shard serve). Identical semantics to a sharded
        Reserve landing in-process: journaled write-ahead, charged into
        ``_in_use`` immediately, ordered by the global stage seq.
        Returns the assigned seq so the worker's local mirror orders
        its claims exactly as the commit validator will."""
        self._claim(uid, node, chips, shard=shard, gang=gang)
        with self._lock:
            c = self._claims.get(uid)
            return c.seq if c is not None else 0

    def commit_staged(self, uids) -> "tuple[bool, str]":
        """Atomically validate-and-commit the STAGED claims of ``uids``
        (one pod, or a whole gang's release cohort) — the shared commit
        point of the sharded serve loops. Validation is first-staged-wins
        under per-node capacity: a claim is valid when its node's total
        usage, counting committed claims and staged claims staged NO
        LATER than it, fits the node's healthy-chip capacity; a later
        claim racing the same chips fails its own commit instead. All
        claims commit or none do (the caller rolls a refused gang back
        whole through the transactional unbind path). Claims already
        committed — or uids with no claim at all — validate vacuously, so
        unsharded stacks (nothing ever staged) pay one dict probe per
        uid and the branch below never runs."""
        self.await_commit_gate()
        return self.commit_staged_now(uids)

    def commit_staged_now(self, uids) -> "tuple[bool, str]":
        """:meth:`commit_staged` without the resize barrier's wait, for a
        caller that waited it out (:meth:`await_commit_gate`) before
        taking a lock of its own. A commit that still meets the barrier
        proceeds, which is correct as after the wait's timeout."""
        with self._lock:
            mine = [
                (u, self._claims[u])
                for u in uids
                if u in self._claims and self._claims[u].shard is not None
            ]
            if not mine:
                return True, ""
            staged = [self._claims[u] for u in self._staged]
            for _u, c in mine:
                cap = self._capacity.get(c.node)
                if cap is None:
                    continue  # capacity unknown (node gone): repair owns it
                later = sum(
                    s.chips
                    for s in staged
                    if s.node == c.node and s.seq > c.seq
                )
                if self._in_use.get(c.node, 0) - later > cap:
                    self.commit_conflicts += 1
                    return False, (
                        f"node {c.node}: {self._in_use.get(c.node, 0)} "
                        f"chips claimed (net of later stages: "
                        f"{self._in_use.get(c.node, 0) - later}) > capacity "
                        f"{cap}; an earlier-staged claim owns the chips"
                    )
            if self.journal is not None:
                self.journal.record_commit([u for u, _c in mine])
            for u, c in mine:
                c.shard = None
                c.seq = 0
                self._staged.discard(u)
            self.commit_commits += 1
            return True, ""

    def await_commit_gate(self) -> None:
        """Resize quiesce: wait (never under any lock) while the barrier
        is held. Bounded — a wedged resizer must not wedge commits
        forever; after the timeout the commit proceeds, still correct
        (validation does not read the shard map). A caller that holds a
        lock of its own across ``commit_staged`` waits here first."""
        if not self._commit_gate.is_set():
            self._commit_gate.wait(timeout=10.0)

    def hold_commits(self) -> None:
        """Close the resize quiesce barrier: commit_staged callers wait
        (bounded) until :meth:`resume_commits`."""
        self._commit_gate.clear()

    def resume_commits(self) -> None:
        self._commit_gate.set()

    def staged_count(self) -> int:
        with self._lock:
            return len(self._staged)

    def staged_uids(self) -> "dict[str, str]":
        """uid -> staging shard for every claim still pending commit —
        the drift reconciler's residue surface: a staged claim whose pod
        cluster truth shows BOUND is committed (the shard died between
        the bind landing and its commit), one with no live pod releases
        through the standard leaked-claim path."""
        with self._lock:
            return {
                u: self._claims[u].shard
                for u in self._staged
                if u in self._claims
            }

    def commit_residue(self, uid: str) -> bool:
        """Commit ONE staged claim without validation — cluster truth
        already shows its pod bound (the reconciler's crash-recovery
        path; truth outranks the optimistic protocol). Returns whether a
        staged claim was found."""
        with self._lock:
            c = self._claims.get(uid)
            if c is None or c.shard is None:
                return False
            if self.journal is not None:
                self.journal.record_commit([uid])
            c.shard = None
            c.seq = 0
            self._staged.discard(uid)
            return True

    def restore(self, state) -> int:
        """Seed accounting from a journal replay (a promoted standby,
        BEFORE any watcher registers — the list-then-watch replay then
        layers idempotently over this via handle's re-count no-op path).
        Nothing here is journaled: the journal already holds these
        records, and its mirror was rebuilt by the same replay. Returns
        the number of claims restored."""
        with self._lock:
            in_use = self._in_use
            # Replayed claims are the journal's wire-format 5-lists
            # [node, chips, shard, seq, gang] (see journal/journal.py).
            for uid, c in state.claims.items():
                node, chips, shard_s, seq, gang = c
                shard = shard_s or None
                self._claims[uid] = _Claim(
                    node, chips, shard=shard, seq=seq, gang=gang
                )
                in_use[node] = in_use.get(node, 0) + chips
                if shard is not None:
                    self._staged.add(uid)
            # One delta-feed note per touched NODE, not per claim: the
            # feed carries node granularity, and restore sits on the
            # promotion blackout (100k claims = 100k appends otherwise).
            for node in {c[0] for c in state.claims.values()}:
                self._note(node)
            self._stage_seq = max(self._stage_seq, state.stage_seq)
            self.replayed = True
            self.replayed_gangs = state.staged_gangs()
            return len(state.claims)

    def adopt_warm(
        self, claims, in_use, staged, stage_seq, *, gangs=None
    ) -> int:
        """Seed accounting from a journal TAILER's warm mirror (standby
        promotion, journal/tail.py) — the O(1)-handover sibling of
        :meth:`restore`: the tailer built accountant-ready ``_Claim``
        records incrementally while frames streamed in, so promotion
        installs the dicts wholesale instead of constructing 100k claim
        objects on the blackout path. Nothing here is journaled — the
        promoted journal adopted the same mirror via
        ``FileJournal.promote`` (write-ahead: term durable first).
        Returns the number of claims adopted."""
        with self._lock:
            self._claims = claims
            self._in_use = dict(in_use)
            self._staged = set(staged)
            self._stage_seq = max(self._stage_seq, int(stage_seq))
            # One delta-feed note per node (restore()'s discipline).
            for node in self._in_use:
                self._note(node)
            self.replayed = True
            self.replayed_gangs = gangs if gangs is not None else {}
            return len(claims)

    def claims_snapshot(self) -> "dict[str, tuple[str, int]]":
        """uid -> (node, chips) for every claim, one lock acquisition —
        the warm resync's divergence check diffs cluster truth against
        this instead of N locked per-pod probes."""
        with self._lock:
            return {u: (c.node, c.chips) for u, c in self._claims.items()}

    def chips_in_use(self, node_name: str) -> int:
        with self._lock:
            return self._in_use.get(node_name, 0)

    def has_claim(self, uid: str) -> bool:
        with self._lock:
            return uid in self._claims

    def claimed_uids(self) -> set[str]:
        """Every pod uid currently holding a reservation — the failover
        reconciler diffs this against cluster truth to find LEAKED claims
        (reservations whose pod deletion the watch stream dropped)."""
        with self._lock:
            return set(self._claims)

    def chips_by_node(self) -> dict[str, int]:
        """One consistent copy of the whole reservation map under a single
        lock acquisition — the fleet-kernel dynamics build reads every
        node per dispatch, and N locked ``chips_in_use`` calls would cost
        more than the kernel itself at large fleets."""
        with self._lock:
            return dict(self._in_use)

    @property
    def reservation_epoch(self) -> int:
        with self._lock:
            return self._epoch

    def reserved_changes_since(
        self, epoch: int
    ) -> "tuple[int, dict[str, int] | None]":
        """Delta feed over the per-node reservation totals: ``(current
        epoch, {node: chips})`` for nodes whose total changed in epochs
        ``(epoch, current]``, or ``(current epoch, None)`` when the ring no
        longer reaches back (or the consumer is ahead): the consumer then
        rebuilds from :meth:`chips_by_node`."""
        with self._lock:
            cur = self._epoch
            nodes = ring_since(self._changes, epoch, cur)
            if nodes is None:
                return cur, None
            return cur, {n: self._in_use.get(n, 0) for n in nodes}


class RemoteAccountant(ChipAccountant):
    """Worker-side accountant for multi-process shard serve
    (``shard_mode=process``, framework/procserve.py).

    The worker keeps a FULL local mirror (this class is a real
    ChipAccountant: filters, depth functions, snapshot builds and the
    worker's own cycles read it lock-locally — the read path pays zero
    RPCs), but every claim-state DECISION crosses the commit RPC to the
    parent's journal-owning accountant first:

    - **stage** (a sharded Reserve): RPC to the parent — which journals
      write-ahead and assigns the global stage seq — then the local
      mirror applies with that parent seq, so first-staged-wins ordering
      is identical on both sides.
    - **commit** (``commit_staged``): the parent validates against its
      capacity view and journals the C record; the mirror finalizes only
      on an ok verdict. An RPC failure reports as a refused commit — the
      scheduler requeues, exactly a conflict's path — never a crash.
    - **release / rollback**: best-effort forward (the parent picks
      rollback-vs-release from its OWN authoritative claim state), then
      local. A dead parent cannot block local teardown: its journal
      replay + reconciler own recovery of anything this worker held.

    ``journal`` stays ``None`` here BY CONSTRUCTION — the parent is the
    CommitLog's single writer (yodalint journal-discipline pass). The
    ``rpc`` collaborator is duck-typed (``stage`` / ``commit`` /
    ``release`` / ``residue``) to keep this module import-free of the
    transport.
    """

    name = "yoda-accountant"

    def __init__(
        self,
        rpc,
        *,
        scheduler_name: str = "yoda-tpu",
        scheduler_names: "tuple[str, ...] | None" = None,
    ) -> None:
        super().__init__(
            scheduler_name=scheduler_name, scheduler_names=scheduler_names
        )
        self._rpc = rpc

    def _claim(
        self,
        uid: str,
        node: str,
        chips: int,
        *,
        shard: "str | None" = None,
        gang: str = "",
        seq: "int | None" = None,
    ) -> None:
        if shard is None or seq is not None:
            # Committed/legacy claims (bound-pod watch layering) and
            # already-sequenced applies stay local — the parent's own
            # informer tracks bound pods independently.
            super()._claim(uid, node, chips, shard=shard, gang=gang, seq=seq)
            return
        with self._lock:
            existing = self._claims.get(uid)
            if existing is not None and existing.node == node:
                return  # reserve->bind duplicate: skip the RPC too
        # The RPC runs OUTSIDE the accountant lock (lock-ordering DAG:
        # no I/O under the commit-point lock); the serve loop is the
        # only staging writer per worker, so the check-then-apply pair
        # cannot interleave with another stage of the same uid.
        parent_seq = self._rpc.stage(uid, node, chips, shard, gang)
        super()._claim(
            uid, node, chips, shard=shard, gang=gang, seq=parent_seq
        )

    def release(self, uid: str) -> None:
        with self._lock:
            known = uid in self._claims
        if known:
            try:
                self._rpc.release(uid)
            except Exception:
                # Parent unreachable: the worker is (or is about to be)
                # fenced; parent-side replay + reconciliation recover
                # the claim. Local teardown must still proceed.
                pass
        super().release(uid)

    def commit_staged(self, uids) -> "tuple[bool, str]":
        with self._lock:
            mine = [
                u for u in uids
                if u in self._claims and self._claims[u].shard is not None
            ]
        if not mine:
            return True, ""
        try:
            ok, why = self._rpc.commit(mine)
        except Exception as e:
            # Indistinguishable from a lost-in-flight commit: refuse, let
            # the scheduler roll back + requeue. If the parent DID land
            # it, the journal holds the C record and the reconciler's
            # residue pass converges the mirror after respawn.
            return False, f"commit rpc failed: {e}"
        if ok:
            with self._lock:
                for u in mine:
                    c = self._claims.get(u)
                    if c is not None:
                        c.shard = None
                        c.seq = 0
                    self._staged.discard(u)
                self.commit_commits += 1
        else:
            self.commit_conflicts += 1
        return ok, why

    def commit_residue(self, uid: str) -> bool:
        try:
            found = self._rpc.residue(uid)
        except Exception:
            found = False
        with self._lock:
            c = self._claims.get(uid)
            if c is not None and c.shard is not None:
                c.shard = None
                c.seq = 0
                self._staged.discard(uid)
                return True
        return found

    # --- partition-residue proof (multi-host control plane) ---

    def staged_intents(self) -> "list[dict]":
        """The worker's local staged-intent log in wire form — every
        claim still STAGED in the mirror. Shipped to a newly promoted
        parent (``residue_sync``) on reconnect under a higher term, so
        the parent reconciles this worker's partition residue at once
        instead of waiting for the reconciler's warm path."""
        with self._lock:
            return [
                {"uid": u, "node": c.node, "chips": c.chips, "gang": c.gang}
                for u, c in self._claims.items()
                if c.shard is not None
            ]

    def apply_residue_verdicts(self, verdicts: "dict[str, str]") -> None:
        """Apply a promoted parent's ``residue_sync`` verdicts to the
        local mirror: ``committed`` finalizes the claim locally (the
        parent already holds — or replayed — the C record); ``staged``
        keeps it staged for the normal commit path to finish."""
        with self._lock:
            for uid, verdict in verdicts.items():
                if verdict != "committed":
                    continue
                c = self._claims.get(uid)
                if c is not None and c.shard is not None:
                    c.shard = None
                    c.seq = 0
                    self._staged.discard(uid)
