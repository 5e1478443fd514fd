"""A cycle served from its burst row (``YodaBatch._serve_burst``): the pick
made with array operations over the row, and the per-node verdicts handed
to the framework as a view read off the row (``RowVerdicts``), not as a
map of every node.

The oracle is the per-node loop the row was served with before: it builds
the whole map, takes ``max`` over the scores (ties to the later name) and
steers every other open row to the single-choice status. The view must
hold exactly its map, entry by entry and in the same order, and the pick
must be its pick; the framework must hand PostFilter, the failure summary
and the pending record what it handed them when the plugin returned that
map.
"""

from __future__ import annotations

import random
import string

import numpy as np
import pytest

import yoda_tpu.agent as ref_agent
import yoda_tpu.api.types as ref_types
import yoda_tpu.config as ref_config
import yoda_tpu.standalone as ref_standalone
import yoda_tpu_torch.agent as port_agent
import yoda_tpu_torch.api.types as port_types
import yoda_tpu_torch.config as port_config
import yoda_tpu_torch.standalone as port_standalone
from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import (
    BatchFilterScorePlugin,
    FilterPlugin,
    NodeInfo,
    PostFilterPlugin,
    RowVerdicts,
    Snapshot,
    Status,
    summarize_failure,
)
from yoda_tpu_torch.framework.runtime import Framework
from yoda_tpu_torch.ops.kernel import REASON_MESSAGES, KernelRequest, KernelResult
from yoda_tpu_torch.plugins.yoda.batch import (
    YodaBatch,
    _BurstEntry,
    _BurstSet,
    _pod_constraints,
)

VERSION = 7
HELD = Status.unschedulable(
    "feasible, but a burst sibling was steered here first "
    "(single-choice serving)"
)


def oracle(b: _BurstSet, entry: _BurstEntry, chips: int):
    """The row served by the per-node loop: (statuses, {best: score}) or
    None when no row is open to the pod. Reads ``b``, changes nothing."""
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
    if not scores:
        return None
    best = max(scores, key=lambda nm: (scores[nm], nm))
    statuses = {
        nm: (st if not st.success else (Status.ok() if nm == best else HELD))
        for nm, st in statuses.items()
    }
    return statuses, {best: scores[best]}


def _pod(i: int, chips: int) -> PodSpec:
    return PodSpec(f"p{i}", labels={"tpu/chips": str(chips)})


def _request(chips: int) -> KernelRequest:
    return KernelRequest(chips, 0, 0, 0, 0)


def _entry(pod: PodSpec, chips: int, feasible, scores, reasons, claimable,
           bonus) -> _BurstEntry:
    n = len(feasible)
    return _BurstEntry(
        request=_request(chips),
        constraints=_pod_constraints(pod),
        result=KernelResult(
            feasible=np.asarray(feasible, dtype=bool),
            reasons=np.asarray(reasons, dtype=np.int32),
            raw_scores=np.zeros(n, dtype=np.int32),
            scores=np.asarray(scores, dtype=np.int32),
            best_index=-1,
            claimable=np.asarray(claimable, dtype=np.int32),
        ),
        pref_bonus=np.asarray(bonus, dtype=np.int64),
    )


def _plugin(names: list[str], entries: dict, monkeypatch,
            checks: bool = True) -> YodaBatch:
    """A plugin holding one burst set over ``names``; the set's version
    matches every snapshot, and the live spot-check answers ``checks``."""
    yb = YodaBatch(platform="cpu")
    yb._burst = _BurstSet(
        fleet_version=VERSION,
        names=names,
        index={nm: i for i, nm in enumerate(names)},
        base_reserved=np.zeros(len(names), dtype=np.int32),
        entries=entries,
        rank=yb._name_rank(names),
    )
    monkeypatch.setattr(yb, "_fleet_version", lambda snapshot: VERSION)
    monkeypatch.setattr(yb, "_pick_checks", lambda *a: checks)
    return yb


def _names(rng: random.Random, n: int) -> list[str]:
    """Unique node names in no sorted order, so a row's index and its
    name's rank differ."""
    names: set[str] = set()
    while len(names) < n:
        names.add("".join(rng.choices(string.ascii_lowercase, k=6)))
    out = sorted(names)
    rng.shuffle(out)
    return out


def _seeded_set(seed: int, n: int = 2000, k: int = 16):
    """``k`` pods and their rows over ``n`` nodes: about 60% feasible,
    scores from a narrow range so several names tie at the top, every
    reason code and one the messages lack, and claimable chips near the
    pods' asks so siblings run rows out."""
    rng = random.Random(seed)
    names = _names(rng, n)
    pods, entries = [], {}
    for j in range(k):
        chips = rng.choice((1, 1, 2, 4))
        pod = _pod(j, chips)
        feasible = [rng.random() < 0.6 for _ in range(n)]
        entries[pod.uid] = _entry(
            pod, chips, feasible,
            scores=[rng.randint(90, 100) for _ in range(n)],
            reasons=[0 if f else rng.randint(1, 9) for f in feasible],
            claimable=[rng.randint(chips, 8) for _ in range(n)],
            bonus=[rng.choice((0, 0, 0, 1, -100)) for _ in range(n)],
        )
        pods.append((pod, chips))
    return names, pods, entries


def _snapshot(names) -> Snapshot:
    return Snapshot({nm: NodeInfo(nm) for nm in names}, version=VERSION)


def _same_as_oracle(view, want: dict[str, Status]) -> None:
    """Entry by entry (code and message) through the lazy reads, then the
    whole map in order and length."""
    assert len(view) == len(want)
    for nm, st in want.items():
        got = view[nm]
        assert (got.code, got.message) == (st.code, st.message), nm
    assert [(nm, st.code, st.message) for nm, st in view.items()] == [
        (nm, st.code, st.message) for nm, st in want.items()
    ]


class TestServedRow:
    @pytest.mark.parametrize("seed", range(5))
    def test_view_and_pick_equal_the_oracle(self, seed, monkeypatch):
        names, pods, entries = _seeded_set(seed)
        yb = _plugin(names, entries, monkeypatch)
        snap = _snapshot(names)
        served = 0
        for pod, chips in pods:
            b = yb._burst
            want = oracle(b, b.entries[pod.uid], chips)
            got = yb._serve_burst(pod, snap, _request(chips))
            if want is None:
                assert got is None
                continue
            served += 1
            view, scores = got
            assert isinstance(view, RowVerdicts)
            assert scores == want[1]
            assert view.feasible() == list(want[1])
            assert yb.burst_row_walks == served - 1  # the pick read alone
            _same_as_oracle(view, want[0])
            assert yb.burst_row_walks == served
        assert served and yb.burst_served == served
        assert yb._burst is None

    def test_ties_go_to_the_later_name(self, monkeypatch):
        # "c" sits first in the row, "a" last: the index order and the
        # names' order disagree, and the names decide.
        names = ["c", "b", "a", "d"]
        pod = _pod(0, 1)
        entry = _entry(
            pod, 1, feasible=[True, True, True, False],
            scores=[50, 40, 45, 99], reasons=[0, 0, 0, 4],
            claimable=[4, 4, 4, 0], bonus=[0, 10, 5, 0],
        )
        yb = _plugin(names, {pod.uid: entry}, monkeypatch)
        want = oracle(yb._burst, entry, 1)
        view, scores = yb._serve_burst(pod, _snapshot(names), _request(1))
        assert scores == want[1] == {"c": 50}
        _same_as_oracle(view, want[0])

    def test_sibling_consumption_at_the_claimable_limit(self, monkeypatch):
        # Row "x" holds 4 chips: two pods of 2 fill it exactly, and the
        # third pod finds it consumed; "y" scores lower throughout.
        names = ["x", "y"]
        entries, pods = {}, []
        for j, chips in enumerate((2, 2, 1)):
            pod = _pod(j, chips)
            entries[pod.uid] = _entry(
                pod, chips, feasible=[True, True], scores=[90, 80],
                reasons=[0, 0], claimable=[4, 4], bonus=[0, 0],
            )
            pods.append((pod, chips))
        yb = _plugin(names, entries, monkeypatch)
        snap = _snapshot(names)
        picks = []
        for pod, chips in pods:
            want = oracle(yb._burst, yb._burst.entries[pod.uid], chips)
            view, scores = yb._serve_burst(pod, snap, _request(chips))
            assert scores == want[1]
            _same_as_oracle(view, want[0])
            picks.append(next(iter(scores)))
        assert picks == ["x", "x", "y"]
        assert view["x"].message == "chips consumed by a burst sibling"

    @pytest.mark.parametrize("why", ["infeasible", "consumed"])
    def test_no_open_row_drops_the_entry(self, why, monkeypatch):
        names = ["m", "n", "o"]
        first, last = _pod(0, 2), _pod(1, 2)
        feasible = [why == "consumed", False, False]
        entries = {
            p.uid: _entry(p, 2, feasible=feasible, scores=[70, 0, 0],
                          reasons=[0 if f else 4 for f in feasible],
                          claimable=[2, 0, 0], bonus=[0, 0, 0])
            for p in (first, last)
        }
        yb = _plugin(names, entries, monkeypatch)
        snap = _snapshot(names)
        if why == "consumed":
            assert yb._serve_burst(first, snap, _request(2)) is not None
        else:
            assert yb._serve_burst(first, snap, _request(2)) is None
            assert first.uid not in yb._burst.entries
        b = yb._burst
        assert oracle(b, b.entries[last.uid], 2) is None
        assert yb._serve_burst(last, snap, _request(2)) is None
        assert yb._burst is None  # the set's last entry went
        assert yb.burst_invalidated == 0

    def test_failed_spot_check_drops_the_set(self, monkeypatch):
        names, pods, entries = _seeded_set(11, n=200, k=5)
        yb = _plugin(names, entries, monkeypatch, checks=False)
        pod, chips = pods[0]
        assert yb._serve_burst(pod, _snapshot(names), _request(chips)) is None
        assert yb._burst is None
        # The four siblings' rows with the set, and this pod's row.
        assert yb.burst_invalidated == 5
        assert yb.burst_served == 0


class _RejectOn(FilterPlugin):
    name = "reject-on"

    def __init__(self, node: str) -> None:
        self.node = node

    def filter(self, state, pod, node):
        if node.name == self.node:
            return Status.unschedulable("refused by the test's filter")
        return Status.ok()


class _Recorder(PostFilterPlugin):
    name = "recorder"

    def __init__(self) -> None:
        self.seen: list[dict] = []

    def post_filter(self, state, pod, snapshot, filtered_statuses):
        self.seen.append(dict(filtered_statuses))
        return None, Status.unschedulable("nothing to preempt")


class _RowServing(BatchFilterScorePlugin):
    """A batch plugin that serves every cycle from ``yb``'s burst set."""

    name = "row-serving"

    def __init__(self, yb: YodaBatch, chips: int) -> None:
        self.yb = yb
        self.chips = chips

    def filter_and_score_batch(self, state, pod, snapshot):
        return self.yb._serve_burst(pod, snapshot, _request(self.chips))


def _today(want: dict, filters, pod, snapshot, state):
    """The framework's single-plugin branch over a plain map, as it ran
    on the plugin's dict: every snapshot node filled, then the filter
    plugins over the feasible ones."""
    statuses = dict(want[0])
    totals = dict(want[1])
    for n in snapshot.names():
        if n not in statuses:
            statuses[n] = Status.ok()
            totals.setdefault(n, 0)
    for n, st in statuses.items():
        if not st.success:
            continue
        for p in filters:
            st2 = p.filter(state, pod, snapshot.get(n))
            if not st2.success:
                statuses[n] = st2
                break
    return statuses, {n: totals.get(n, 0) for n, st in statuses.items()
                      if st.success}


class TestFramework:
    def _served(self, monkeypatch, snapshot_names, reject_pick: bool = False):
        """One cycle through ``run_batch_filter_score`` over a seeded row:
        (plugin, framework, recorder, what today's branch gives, what the
        framework gave, snapshot, state, pod)."""
        names, pods, entries = _seeded_set(3, n=300, k=2)
        yb = _plugin(names, entries, monkeypatch)
        pod, chips = pods[0]
        want = oracle(yb._burst, yb._burst.entries[pod.uid], chips)
        filters = [_RejectOn(next(iter(want[1])) if reject_pick else "")]
        recorder = _Recorder()
        fw = Framework([_RowServing(yb, chips), *filters, recorder])
        snap = _snapshot(snapshot_names(names))
        state = CycleState()
        today = _today(want, filters, pod, snap, state)
        got = fw.run_batch_filter_score(state, pod, snap)
        return yb, fw, recorder, today, got, snap, state, pod

    def test_filter_rejecting_the_pick(self, monkeypatch):
        yb, fw, recorder, today, got, snap, state, pod = self._served(
            monkeypatch, lambda names: names, reject_pick=True
        )
        statuses, feasible = got
        assert isinstance(statuses, RowVerdicts)
        assert feasible == today[1] == {}
        assert statuses.feasible() == []
        assert summarize_failure(statuses) == summarize_failure(today[0])
        fw.run_post_filter(state, pod, snap, statuses)
        assert recorder.seen == [today[0]]
        assert list(recorder.seen[0]) == list(today[0])
        assert yb.burst_row_walks == 2  # the summary and PostFilter

    def test_bound_pick_walks_nothing(self, monkeypatch):
        yb, _fw, _rec, today, got, *_ = self._served(
            monkeypatch, lambda names: list(names)
        )
        statuses, feasible = got
        assert isinstance(statuses, RowVerdicts)
        assert feasible == today[1] and len(feasible) == 1
        assert yb.burst_row_walks == 0
        assert dict(statuses) == today[0]

    def test_node_the_row_lacks_stays_ok_with_score_zero(self, monkeypatch):
        yb, _fw, _rec, today, got, *_ = self._served(
            monkeypatch, lambda names: sorted([*names, "zz-new-node"])
        )
        statuses, feasible = got
        assert not isinstance(statuses, RowVerdicts)
        assert statuses["zz-new-node"] == Status.ok()
        assert feasible == today[1]
        assert feasible["zz-new-node"] == 0 and len(feasible) == 2
        assert statuses == today[0]
        assert list(statuses) == list(today[0])
        assert yb.burst_row_walks == 1  # built once for the fill


SIDES = {
    "yoda_tpu": (ref_standalone, ref_config, ref_agent, ref_types),
    "yoda_tpu_torch": (port_standalone, port_config, port_agent, port_types),
}


def _burst_drive(pkg: str, hosts: int = 1000, k: int = 16, bursts: int = 3):
    """``hosts`` hosts of mixed generations and sizes, then ``bursts``
    waves of ``k`` singletons of 1-4 chips: where each pod binds."""
    standalone, config, agent_mod, types = SIDES[pkg]
    stack = standalone.build_stack(config=config.SchedulerConfig(
        kernel_platform="cpu", enable_preemption=False, batch_requests=k,
    ))
    agent = agent_mod.FakeTpuAgent(stack.cluster)
    rng = random.Random(2024)
    for i in range(hosts):
        gen = rng.choice(("v5e", "v5e", "v4", "v5p"))
        agent.add_host(f"h{i:04d}", generation=gen,
                       chips=rng.choice((4, 8)) if gen == "v5e" else 4)
    agent.publish_all()
    for w in range(bursts):
        for j in range(k):
            stack.cluster.create_pod(types.PodSpec(
                f"w{w}-{j:02d}",
                labels={"tpu/chips": str(rng.choice((1, 1, 2, 4)))},
            ))
        if stack.ingestor is not None:
            stack.ingestor.flush()
        stack.scheduler.run_until_idle(max_wall_s=60)
    bound = {p.key: p.node_name for p in stack.cluster.list_pods()}
    if pkg == "yoda_tpu_torch":
        stack.close()
        return bound, stack.batch
    return bound, None


def test_burst_on_a_stack_binds_where_the_reference_does():
    want, _ = _burst_drive("yoda_tpu")
    got, batch = _burst_drive("yoda_tpu_torch")
    assert got == want
    assert len(got) == 48 and all(got.values())
    assert batch.burst_served == len(got)
    assert batch.burst_row_walks == 0
