"""Journal-tailing hot standby — the follower half of the multi-host
control plane.

A standby process streams committed journal frames from the live parent
over the commit transport (the ``tail`` RPC, served straight from the
journal's in-memory ship ring) into TWO warm mirrors at once:

- the journal-form :class:`ReplayedState` (uid -> claim 5-list) the
  promoted FileJournal adopts as its own mirror, and
- accountant-ready ``_Claim`` records plus per-node usage totals,
  built INCREMENTALLY as frames arrive, so promotion installs them
  O(1) via ``ChipAccountant.adopt_warm`` instead of constructing 100k
  claim objects on the blackout path.

Catch-up: a fresh follower (or one that fell past the ship ring) gets a
full mirror snapshot from ``FileJournal.ship_state`` and rebuilds both
mirrors once, OFF the promotion critical path. After that each poll
applies only the delta frames; ``lag_frames`` (the
``yoda_standby_lag_frames`` gauge) is how far the tail is behind.

Promotion (:meth:`JournalTailer.promote_into`): a divergence check
(recomputed per-node usage must match the incrementally-maintained
totals; any frame-seq gap already forced a snapshot re-sync), then the
term bump — written as the promoted journal's FIRST frame — then the
O(1) accountant handover. A failed check raises :class:`TailDiverged`
and the caller falls back to cold replay rather than serving on a bad
mirror.

Counterpart of ``yoda_tpu/journal/tail.py``, whole: it reads the port
journal's ``frames_since`` / ``ship_state`` through the commit RPC's
``tail`` op and promotes through ``FileJournal.promote`` and
``ChipAccountant.adopt_warm``, so a port standby tails a parent of either
package.
"""

from __future__ import annotations

import json
import threading

from yoda_tpu_torch.framework.procserve import CommitRPCError
from yoda_tpu_torch.journal.journal import (
    _SEP,
    CLAIM_SEQ,
    CLAIM_SHARD,
    ReplayedState,
)
from yoda_tpu_torch.plugins.yoda.accounting import _Claim


class TailDiverged(RuntimeError):
    """The tailed mirror cannot be trusted (seq gap, unknown record,
    or a failed promotion consistency check): the caller re-syncs from
    a snapshot or falls back to cold replay."""


class JournalTailer:
    """Stream the live parent's journal into a warm promotable mirror.

    ``client`` is a :class:`CommitRPCClient` (or anything with its
    ``call`` shape) pointed at the live parent's commit endpoint —
    journal shipping rides the SAME transport as commits, so there is
    no second listener to operate or firewall.
    """

    def __init__(
        self,
        client,
        *,
        poll_s: float = 0.05,
        metrics=None,
    ) -> None:
        self.client = client
        self.poll_s = poll_s
        self.metrics = metrics
        self.state = ReplayedState()
        # Accountant-ready mirror, maintained frame-by-frame.
        self.claims: dict[str, _Claim] = {}
        self.in_use: dict[str, int] = {}
        self.staged: set[str] = set()
        self.term = 0               # highest parent term observed
        self.synced = False         # ever completed a tail round-trip
        self.lag_frames = 0
        self.frames_applied = 0
        self.snapshots = 0          # full catch-ups paid
        self.polls = 0
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    # --- polling ---

    def poll_once(self) -> int:
        """One tail round-trip; returns claims/frames applied. Raises
        ``CommitRPCError`` when the parent is unreachable (the run loop
        keeps the warm state and retries) and :class:`TailDiverged` on
        a seq gap (local state was reset; the next poll re-snapshots)."""
        self.polls += 1
        resp = self.client.call("tail", since=self.state.tail_seq)
        self.synced = True
        term = int(resp.get("term", 0) or 0)
        if term > self.term:
            self.term = term
        snap = resp.get("snapshot")
        if snap is not None:
            self._load_snapshot(snap)
            applied = len(self.state.claims)
        else:
            applied = 0
            for payload in resp.get("frames", ()):
                self._apply(payload)
                applied += 1
            self.frames_applied += applied
        tail = int(resp.get("tail_seq", self.state.tail_seq))
        self.lag_frames = max(tail - self.state.tail_seq, 0)
        if self.metrics is not None:
            self.metrics.standby_lag_frames.set(float(self.lag_frames))
        return applied

    def _load_snapshot(self, snap: dict) -> None:
        """Full catch-up: rebuild BOTH mirrors from a shipped snapshot.
        The expensive pass (one ``_Claim`` per uid) runs here, while the
        old parent is alive — never on the promotion blackout."""
        claims = {u: list(c) for u, c in snap["claims"].items()}
        self.state = ReplayedState(
            claims=claims,
            stage_seq=int(snap["stage_seq"]),
            tail_seq=int(snap["tail_seq"]),
            term=int(snap.get("term", 0)),
        )
        acc: dict[str, _Claim] = {}
        in_use: dict[str, int] = {}
        staged: set[str] = set()
        for uid, c in claims.items():
            node, chips, shard_s, seq, gang = c
            chips = int(chips)
            acc[uid] = _Claim(
                node, chips, shard=shard_s or None, seq=int(seq), gang=gang
            )
            in_use[node] = in_use.get(node, 0) + chips
            if shard_s:
                staged.add(uid)
        self.claims, self.in_use, self.staged = acc, in_use, staged
        if self.state.term > self.term:
            self.term = self.state.term
        self.snapshots += 1

    def _apply(self, payload: str) -> None:
        """Apply one shipped frame to both mirrors — the streaming twin
        of ``FileJournal._replay_segment``'s per-kind inline apply."""
        fields = payload.split(_SEP)
        kind = fields[0]
        seq = int(fields[1])
        tail = self.state.tail_seq
        if seq <= tail:
            return  # duplicate ship (overlapping poll): already applied
        if tail and seq != tail + 1 and kind != "P":
            # A skipped seq means frames were lost in transit: the warm
            # state is no longer provably complete. Drop it and rebuild
            # from scratch on the next poll (since=0 -> snapshot or the
            # full ring).
            self.state = ReplayedState()
            self.claims, self.in_use, self.staged = {}, {}, set()
            raise TailDiverged(f"frame seq {seq} arrived after tail {tail}")
        mirror = self.state.claims
        if kind == "S":
            _k, _s, uid, node, chips_s, shard, sseq_s, gang = fields
            chips = int(chips_s)
            sseq = int(sseq_s)
            old = self.claims.pop(uid, None)
            if old is not None:
                self.in_use[old.node] = max(
                    self.in_use.get(old.node, 0) - old.chips, 0
                )
                self.staged.discard(uid)
            mirror[uid] = [node, chips, shard, sseq, gang]
            self.claims[uid] = _Claim(
                node, chips, shard=shard or None, seq=sseq, gang=gang
            )
            self.in_use[node] = self.in_use.get(node, 0) + chips
            if shard:
                self.staged.add(uid)
            if sseq > self.state.stage_seq:
                self.state.stage_seq = sseq
        elif kind == "C":
            for uid in fields[2].split(","):
                m = mirror.get(uid)
                if m is not None:
                    m[CLAIM_SHARD] = ""
                    m[CLAIM_SEQ] = 0
                c = self.claims.get(uid)
                if c is not None:
                    c.shard = None
                    c.seq = 0
                self.staged.discard(uid)
        elif kind in ("R", "B"):
            uid = fields[2]
            mirror.pop(uid, None)
            c = self.claims.pop(uid, None)
            if c is not None:
                self.in_use[c.node] = max(
                    self.in_use.get(c.node, 0) - c.chips, 0
                )
            self.staged.discard(uid)
        elif kind == "P":
            # A rotation snapshot shipped inline: authoritative full
            # state, so rebuild from it (also how a follower re-syncs
            # mid-stream without a gap).
            snap = json.loads(fields[2])
            snap["tail_seq"] = seq
            self._load_snapshot(snap)
        elif kind == "T":
            t = int(fields[2])
            self.state.term = t
            if t > self.term:
                self.term = t
        else:
            self.state = ReplayedState()
            self.claims, self.in_use, self.staged = {}, {}, set()
            raise TailDiverged(f"unknown shipped record kind {kind!r}")
        self.state.tail_seq = seq

    # --- run loop ---

    def run(self, stop: "threading.Event | None" = None) -> None:
        stop = stop or self._stop
        while not stop.is_set():
            try:
                self.poll_once()
            except TailDiverged:
                continue  # state was reset; re-snapshot immediately
            except CommitRPCError:
                # Parent unreachable (it may be dead — which is exactly
                # when promotion happens): keep the warm state, retry.
                pass
            if stop.wait(self.poll_s):
                return

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, name="journal-tailer", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # --- promotion ---

    def divergence(self) -> "str | None":
        """The promotion-gate consistency check: per-node usage
        recomputed from the accountant-ready claims must equal the
        incrementally-maintained totals, and the two mirrors must hold
        the same uids. O(claims) dict walks — ~10 ms at 100k — a cheap
        proof the mirrors never drifted while frames streamed."""
        recomputed: dict[str, int] = {}
        for c in self.claims.values():
            recomputed[c.node] = recomputed.get(c.node, 0) + c.chips
        live = {n: v for n, v in self.in_use.items() if v}
        if recomputed != live:
            bad = sorted(
                n
                for n in set(recomputed) | set(live)
                if recomputed.get(n, 0) != live.get(n, 0)
            )
            return f"per-node usage mismatch on {bad[:8]}"
        if len(self.claims) != len(self.state.claims):
            return (
                f"mirror claim count mismatch: {len(self.claims)} != "
                f"{len(self.state.claims)}"
            )
        return None

    def promote_into(
        self, accountant, journal=None, *, snapshot: str = "defer"
    ) -> int:
        """Hand the warm mirrors to the promoting parent: divergence
        check, term bump (durable as the promoted journal's first
        frame, BEFORE the accountant serves anything), then the O(1)
        state handover. Returns the NEW term. Raises
        :class:`TailDiverged` when the check fails — the caller falls
        back to cold replay instead of serving on a bad mirror."""
        why = self.divergence()
        if why is not None:
            raise TailDiverged(why)
        new_term = self.term + 1
        self.state.term = new_term
        if journal is not None:
            journal.promote(self.state, new_term, snapshot=snapshot)
        accountant.adopt_warm(
            self.claims,
            self.in_use,
            self.staged,
            self.state.stage_seq,
            gangs=self.state.staged_gangs(),
        )
        self.term = new_term
        return new_term
