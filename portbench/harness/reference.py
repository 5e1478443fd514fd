"""The plain reference that decides ``correct``: NumPy, importing nothing of
the program.

It works every decision out again from the benchmark's own inputs (the
fleet, the metric values it published, the pods it made and their
requests) and the run's log of binds and deletions, as the cluster's watch
delivered them, and judges the program's answers by it:

- the fleet evaluation, a frozen copy of its arithmetic: feasibility (node
  valid, admitted, fresh, generation, chips, HBM, clock, reservations with
  their two corrections), the six cluster maxima over the feasible nodes'
  qualifying chips, the weighted raw score, min-max normalization with the
  all-equal guard, the slice-protect tier, and the pick: the highest score,
  ties to the later node name, for a seeded sample of the pods;
- the accounting: no host over its healthy chips at any bind, every bind
  feasible, and, once the run is over, the program's claims equal to the
  pods still bound.

The harness logs when the program evaluated and for which pods; the
reference takes nothing else from it (see :class:`Replay`).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

MIB = 1 << 20
GIB = 1 << 30
SLICE_PROTECT_TIER = 1000
INT32_MAX = 2**31 - 1

# Maxima keys, in the order of the score terms.
_MAX_KEYS = ("bw", "clock", "tflops", "power", "hbm_free", "hbm_total")


def score_weights(settings: dict) -> dict:
    """The weights the score runs with: the configured ones, with the
    free-leaning terms negated under the most-allocated strategy."""
    w = dict(
        hbm_bandwidth=1, clock=1, tflops=1, power=1, hbm_free=2, hbm_total=1,
        actual=2, allocate=2, slice_protect=1,
    )
    for k, v in settings.get("weights", {}).items():
        if k in w:
            w[k] = int(v)
    if settings.get("scoring_strategy") == "most-allocated":
        for k in ("hbm_free", "actual", "allocate"):
            w[k] = -w[k]
    return w


@dataclass
class Static:
    """The fleet as the reference holds it: one row per host, in name order."""

    names: list
    index: dict
    chip_valid: np.ndarray
    hbm_free: np.ndarray      # MiB, floored
    hbm_total: np.ndarray
    used: np.ndarray          # free < total
    clock: np.ndarray
    bw: np.ndarray
    tflops: np.ndarray
    power: np.ndarray
    gen_rank: np.ndarray
    in_slice: np.ndarray
    zone: np.ndarray
    healthy_count: np.ndarray
    apparently_used: np.ndarray
    slice_of: list
    n_zones: int

    @classmethod
    def build(cls, fleet, used_bytes: dict) -> "Static":
        hosts = sorted(fleet.hosts, key=lambda h: h.name)
        n = len(hosts)
        c = max(h.chips for h in hosts)
        z = np.zeros((n, c), dtype=np.int64)
        valid = np.zeros((n, c), dtype=bool)
        free, total, clock, bw, tfl, pw = (z.copy() for _ in range(6))
        used = np.zeros((n, c), dtype=bool)
        for i, h in enumerate(hosts):
            s = fleet.spec[h.generation]
            held = used_bytes.get(h.name, [])
            for j in range(h.chips):
                tot = s["hbm_gib"] * GIB
                fr = tot - held[j] if j < len(held) else tot
                valid[i, j] = True
                free[i, j] = max(fr, 0) // MIB
                total[i, j] = tot // MIB
                used[i, j] = fr < tot
                clock[i, j] = s["clock_mhz"]
                bw[i, j] = s["hbm_bandwidth_gbps"]
                tfl[i, j] = s["tflops_bf16"]
                pw[i, j] = s["power_w"]
        return cls(
            names=[h.name for h in hosts],
            index={h.name: i for i, h in enumerate(hosts)},
            chip_valid=valid, hbm_free=free, hbm_total=total, used=used,
            clock=clock, bw=bw, tflops=tfl, power=pw,
            gen_rank=np.array([fleet.generation_rank[h.generation] for h in hosts]),
            in_slice=np.array([bool(h.slice_id) for h in hosts]),
            zone=np.array([h.zone for h in hosts]),
            healthy_count=valid.sum(axis=1),
            apparently_used=(valid & used).sum(axis=1),
            slice_of=[h.slice_id for h in hosts],
            n_zones=len(fleet.zones),
        )


@dataclass
class Request:
    number: int
    hbm_mib: int
    clock: int
    gen_rank: int
    topology: bool

    @classmethod
    def of(cls, req, generation_rank: dict) -> "Request":
        return cls(
            number=max(req.chips, 1),
            hbm_mib=req.hbm_gib * GIB // MIB,
            clock=req.clock_mhz,
            gen_rank=generation_rank.get(req.generation, 0) if req.generation else 0,
            topology=req.gang_kind in ("topology", "multislice"),
        )


class Evaluator:
    """The fleet evaluation of one request, with what does not depend on
    the reservations computed once."""

    def __init__(self, st: Static, r: Request, w: dict) -> None:
        self.st, self.r, self.w = st, r, w
        healthy = st.chip_valid
        hbm_ok = healthy & (st.hbm_free >= r.hbm_mib)
        clock_ok = healthy & (st.clock >= r.clock)
        self.qual = hbm_ok & clock_ok
        self.count_hbm = hbm_ok.sum(axis=1)
        self.count_clock = clock_ok.sum(axis=1)
        fc = (healthy & st.used & (st.clock >= r.clock)
              & (st.hbm_total >= r.hbm_mib)).sum(axis=1)
        self.freed_candidates = np.maximum(fc, 0)  # no external chips here
        self.count_avail = (self.qual & ~st.used).sum(axis=1)
        self.fits_static = (
            (st.gen_rank >= r.gen_rank)
            & (st.healthy_count >= r.number)
            & ((r.clock == 0) | (self.count_clock >= r.number))
        )
        self.chip_terms = [
            np.where(self.qual, getattr(st, key), 0) for key in _MAX_KEYS
        ]
        free_sum = np.where(st.chip_valid, st.hbm_free, 0).sum(axis=1)
        self.total_sum = np.where(st.chip_valid, st.hbm_total, 0).sum(axis=1)
        safe = np.maximum(self.total_sum, 1)
        self.actual = np.where(self.total_sum > 0, free_sum * 100 // safe, 0) * w["actual"]
        self.safe_total = safe
        self.protect = np.where(
            (not r.topology) & ~st.in_slice, SLICE_PROTECT_TIER * w["slice_protect"], 0
        )

    def feasible(self, reserved, fresh, host_ok):
        """(feasible [N], claimable [N]) under these reservations."""
        st, r = self.st, self.r
        absorbable = np.maximum(st.apparently_used, 0)
        invisible = np.maximum(reserved - absorbable, 0)
        stale_freed = np.maximum(absorbable - reserved, 0)
        freed = np.minimum(stale_freed, np.maximum(self.freed_candidates - reserved, 0))
        fits_hbm = (r.hbm_mib == 0) | ((self.count_hbm + freed) >= r.number)
        room = self.count_avail + freed - invisible
        feas = self.fits_static & fits_hbm & (room >= r.number) & fresh & host_ok
        return feas, np.maximum(room, 0)

    def scores(self, feas, claimed):
        """Final scores [N] (0 where infeasible)."""
        w = self.w
        terms = []
        for key, term in zip(_MAX_KEYS, self.chip_terms):
            m = term[feas].max() if feas.any() else 0
            terms.append((term, max(int(m), 1)))
        wk = (w["hbm_bandwidth"], w["clock"], w["tflops"], w["power"],
              w["hbm_free"], w["hbm_total"])
        chip = sum(
            (getattr(self.st, key) * 100 // m) * wt
            for (key, (_t, m), wt) in zip(_MAX_KEYS, terms, wk)
        )
        basic = np.where(self.qual, chip, 0).sum(axis=1)
        headroom = np.maximum(self.total_sum - claimed, 0)
        allocate = np.where(
            self.total_sum > 0, headroom * 100 // self.safe_total, 0
        ) * w["allocate"]
        raw = np.where(feas, basic + self.actual + allocate, 0)
        if feas.any():
            lo, hi = int(raw[feas].min()), int(raw[feas].max())
        else:
            lo, hi = INT32_MAX, -INT32_MAX
        if hi == lo:
            lo -= 1
        span = max(hi - lo, 1)
        norm = np.where(feas, (raw - lo) * 100 // span, 0)
        return np.where(feas, norm + self.protect, 0)


def pick(final, feas, name_rank) -> int:
    """Row of the highest score, ties to the later name; -1 if none."""
    if not feas.any():
        return -1
    key = np.where(feas, final.astype(np.int64) * (1 << 20) + name_rank, -1)
    return int(np.argmax(key))


def node_feasible(st: Static, r: Request, i: int, reserved: int) -> bool:
    """One node's feasibility, the scalar form of Evaluator.feasible."""
    valid = st.chip_valid[i]
    hbm_ok = valid & (st.hbm_free[i] >= r.hbm_mib)
    clock_ok = valid & (st.clock[i] >= r.clock)
    qual = hbm_ok & clock_ok
    absorbable = int(st.apparently_used[i])
    invisible = max(reserved - absorbable, 0)
    stale = max(absorbable - reserved, 0)
    fc = int((valid & st.used[i] & (st.clock[i] >= r.clock)
              & (st.hbm_total[i] >= r.hbm_mib)).sum())
    freed = min(stale, max(fc - reserved, 0))
    return bool(
        st.gen_rank[i] >= r.gen_rank
        and st.healthy_count[i] >= r.number
        and (r.hbm_mib == 0 or int(hbm_ok.sum()) + freed >= r.number)
        and (r.clock == 0 or int(clock_ok.sum()) >= r.number)
        and int((qual & ~st.used[i]).sum()) + freed - invisible >= r.number
    )


@dataclass
class Verdict:
    numbers: dict = field(default_factory=dict)   # name -> (value, limit)
    notes: list = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.numbers.values())


@dataclass
class LogEvent:
    t: float          # monotonic seconds
    unix: float
    kind: str         # add | bind | delete
    key: str
    node: str = ""


@dataclass
class Evaluation:
    """One evaluation round trip of the program as the harness saw it: when
    it was made, when the program began to read the state it evaluates
    (the start of the burst's preparation or of the pod's filter pass),
    and the pods whose cycles it serves, in serving order (one group for a
    burst; none for a pod's own fresh dispatch)."""

    t: float
    t_read: "float | None" = None
    groups: list = field(default_factory=list)

    @property
    def read_from(self) -> float:
        return self.t if self.t_read is None else min(self.t_read, self.t)


@dataclass
class Batch:
    """One batch of watch events as the program's ingest applied it: when
    it began (the reservations, event by event), when the informer took it
    (the claims, at once) and when that ended, and the pods it carried."""

    t_start: float
    t_informer: float
    t_end: float
    keys: frozenset


@dataclass
class _Applied:
    t: float
    kind: str         # bind | delete
    row: int
    chips: int
    mib: int
    key: str
    # The batch that folded it in: (start, informer start, end); the log's
    # own time where no batch carried it (a watch delivered event by event).
    folds: tuple = ()


class Replay:
    """Walks the run's log in order, holding the reference state, and
    counts every departure from what the reference says.

    A pick is judged against the one evaluation it can have been served
    from: the last evaluation before its bind that covered the pod (its
    burst, net of what the siblings served before it took), or a fresh
    dispatch made in its own cycle, after the bind before it. The state an
    evaluation ran on is the one the program read at some moment between
    the start of its preparation and its call (``Evaluation.read_from`` to
    ``t``), as the ingest's batches (``batches``) had applied the watch's
    events by then. A bind not yet folded in counts only by the reservation
    the program made itself."""

    def __init__(self, st: Static, reqs: dict, settings: dict, generation_rank: dict,
                 publishes: list, evaluations: list, *, sample: set,
                 batches: list) -> None:
        self.st = st
        self.reqs = reqs
        self.w = score_weights(settings)
        self.rank = generation_rank
        self.max_age = float(settings.get("max_metrics_age_s", 0))
        self.publishes = sorted(publishes)
        self.evals = sorted(evaluations, key=lambda e: e.t)
        self.eval_t = [e.t for e in self.evals]
        self.covering: dict[str, list] = {}        # key -> [(eval index, group index)]
        for i, e in enumerate(self.evals):
            for g, keys in enumerate(e.groups):
                for k in keys:
                    self.covering.setdefault(k, []).append((i, g))
        self.sample = sample
        self._batches: dict[str, list] = {}      # key -> [(start, informer, end)]
        for b in sorted(batches, key=lambda b: b.t_start):
            for k in b.keys:
                self._batches.setdefault(k, []).append((b.t_start, b.t_informer, b.t_end))
        n = len(st.names)
        self.reserved = np.zeros(n, dtype=np.int64)
        self.claimed = np.zeros(n, dtype=np.int64)
        self.node_of: dict[str, int] = {}
        self.log: list[_Applied] = []
        self.name_rank = np.argsort(np.argsort(np.array(st.names)))
        self.counts = dict(wrong_node=0, infeasible_bind=0, over_chips=0)
        self.checked = self.sampled_bound = self.unjudged = 0
        self.fold_depth: list[int] = []
        self._evaluators: dict = {}

    # --- state ---

    def _apply(self, row: int, req, sign: int) -> None:
        self.reserved[row] += sign * max(req.chips, 1)
        self.claimed[row] += sign * _mib(req)

    def prefill(self, pods) -> None:
        for req, node in pods:
            row = self.st.index[node]
            self.node_of[req.key] = row
            self._apply(row, req, +1)

    def _fresh(self, unix: float) -> np.ndarray:
        n = len(self.st.names)
        if self.max_age <= 0:
            return np.ones(n, dtype=bool)
        i = bisect.bisect_right(self.publishes, unix) - 1
        return np.full(n, i >= 0 and unix - self.publishes[i] <= self.max_age)

    def _evaluator(self, req) -> Evaluator:
        r = Request.of(req, self.rank)
        key = (r.number, r.hbm_mib, r.clock, r.gen_rank, r.topology)
        ev = self._evaluators.get(key)
        if ev is None:
            ev = self._evaluators[key] = Evaluator(self.st, r, self.w)
        return ev

    def _folds(self, key: str, t: float) -> tuple:
        """(start, informer start, end) of the first batch after ``t`` that
        carried ``key``."""
        lst = self._batches.get(key, ())
        i = bisect.bisect_left(lst, (t,))
        return lst[i] if i < len(lst) else (t, t, t)

    def _states(self, e: Evaluation):
        """(reserved, claimed) under each state the program may have
        evaluated with in ``e``, seen from the walk's position, the most
        folded first. A batch releases its deletions' reservations event by
        event from its start, then the informer folds its claims in event
        by event until its end; the program read the state at one moment
        between the start of its read and its call."""
        r0, r1 = e.read_from, e.t
        res, cl = self.reserved.copy(), self.claimed.copy()
        i = len(self.log)
        while i > 0 and self.log[i - 1].t >= r1:
            i -= 1
            a = self.log[i]
            sign = -1 if a.kind == "bind" else 1
            res[a.row] += sign * a.chips
            cl[a.row] += sign * a.mib
        j = i
        while j > 0 and self.log[j - 1].folds[2] > r0:
            j -= 1
        # The ingest's actions on these events, in the order it took them:
        # (window start, window end, event, releases a reservation).
        actions: list = []
        k = j
        while k < i:
            m = k
            while m < i and self.log[m].folds == self.log[k].folds:
                m += 1
            start, mid, end = self.log[k].folds
            actions += [(start, mid, a, True) for a in self.log[k:m] if a.kind == "delete"]
            actions += [(mid, end, a, False) for a in self.log[k:m]]
            k = m
        p_max = sum(1 for act in actions if act[0] <= r1)
        p_min = sum(1 for act in actions if act[1] <= r0)
        for act in reversed(actions[p_max:]):
            _undo(res, cl, act)
        yield res, cl
        for act in reversed(actions[p_min:p_max]):
            res, cl = res.copy(), cl.copy()
            _undo(res, cl, act)
            yield res, cl

    def _binds_since(self, t: float, keys) -> dict:
        """Chips per row of the binds of ``keys`` at or after ``t``."""
        out: dict[int, int] = {}
        for a in reversed(self.log):
            if a.t < t:
                break
            if a.kind == "bind" and a.key in keys:
                out[a.row] = out.get(a.row, 0) + a.chips
        return out

    def _candidates(self, key: str, t_bind: float):
        """(evaluation, chips per row taken by siblings served before it)
        of each evaluation the pick can have been served from."""
        out = []
        i = bisect.bisect_left(self.eval_t, t_bind) - 1
        cover = [(e, g) for e, g in self.covering.get(key, []) if e <= i]
        if cover:
            e, g = cover[-1]
            out.append((self.evals[e], self._binds_since(
                self.evals[e].t, set(self.evals[e].groups[g]) - {key})))
        last_bind = next((a.t for a in reversed(self.log) if a.kind == "bind"), -1e18)
        if i >= 0 and not self.evals[i].groups and self.evals[i].t > last_bind:
            out.append((self.evals[i], {}))
        return out

    @staticmethod
    def _net(feas, claimable, taken: dict, number: int):
        if taken:
            feas = feas.copy()
            for row, used in taken.items():
                if claimable[row] - used < number:
                    feas[row] = False
        return feas

    def _judge_pick(self, req, row: int, t_bind: float, unix: float) -> "bool | None":
        """Whether ``row`` is the reference's pick under some state the
        pick can have been served from; None when no evaluation served it."""
        cands = self._candidates(req.key, t_bind)
        if not cands:
            return None
        ev = self._evaluator(req)
        fresh = self._fresh(unix)
        ok = np.ones(len(self.st.names), dtype=bool)
        for e, taken in cands:
            for depth, (res, cl) in enumerate(self._states(e)):
                feas, claimable = ev.feasible(res, fresh, ok)
                # A burst row keeps the scores of its evaluation: what the
                # siblings took only rules nodes out.
                final = ev.scores(feas, cl)
                feas = self._net(feas, claimable, taken, ev.r.number)
                if pick(final, feas, self.name_rank) == row:
                    self.fold_depth.append(depth)
                    return True
        return False

    # --- the walk ---

    def on_event(self, e: LogEvent) -> None:
        if e.kind == "add":
            return
        if e.kind == "delete":
            row = self.node_of.pop(e.key, None)
            if row is not None:
                req = self.reqs[e.key]
                self._apply(row, req, -1)
                self.log.append(_Applied(e.t, "delete", row, max(req.chips, 1),
                                         _mib(req), e.key, self._folds(e.key, e.t)))
            return
        req = self.reqs[e.key]
        row = self.st.index[e.node]
        r = Request.of(req, self.rank)
        if not node_feasible(self.st, r, row, int(self.reserved[row])):
            self.counts["infeasible_bind"] += 1
        if self.reserved[row] + r.number > self.st.healthy_count[row]:
            self.counts["over_chips"] += 1
        if e.key in self.sample:
            self.sampled_bound += 1
            verdict = self._judge_pick(req, row, e.t, e.unix)
            if verdict is None:
                self.unjudged += 1
            else:
                self.checked += 1
                if not verdict:
                    self.counts["wrong_node"] += 1
        self.node_of[e.key] = row
        self._apply(row, req, +1)
        self.log.append(_Applied(e.t, "bind", row, r.number, _mib(req), e.key,
                                 self._folds(e.key, e.t)))


def _undo(res, cl, action) -> None:
    """Take one of the ingest's actions back: a deletion's release of its
    reservation, or an event's claims folded in."""
    _lo, _hi, a, release = action
    if release:
        res[a.row] += a.chips
    else:
        cl[a.row] += -a.mib if a.kind == "bind" else a.mib


def _mib(req) -> int:
    return req.hbm_gib * GIB // MIB * max(req.chips, 1)


