"""``correct`` comes out true on the program as it is and false on the
control and on each fault a cell can have, at a small size on the CPU.

The control, ``int16``, uploads each evaluation's per-node reservations
and claims in int16 (the configuration states exact int32 arithmetic).
The faults: the accountant returns its state unchanged (no claim is
recorded); half of a burst left out (its second half answered with the
first half's rows); an answer altered where it is produced (every bind
lands on the next host by name). A run on one card has no exchange
between chips to leave out."""

import pytest

from small import run_small



def _state_unchanged(stack, cluster):
    stack.accountant._claim = lambda *a, **kw: None


def _half_burst(stack, cluster):
    kern = stack.batch._kern
    inner = kern.evaluate_burst

    def evaluate_burst(dyn, host_ok_k, requests):
        results = inner(dyn, host_ok_k, requests)
        half = len(results) // 2
        return results[:half] + results[: len(results) - half] if half else results

    kern.evaluate_burst = evaluate_burst


def _altered_answer(stack, cluster):
    names = sorted(t.name for t in cluster.list_tpu_metrics())
    nxt = {a: b for a, b in zip(names, names[1:] + names[:1])}
    inner = cluster.bind_pod
    cluster.bind_pod = lambda key, node: inner(key, nxt[node])


CELL = "batch5k.singles-backlog"


def test_sound_runs_are_correct():
    out = run_small(CELL)
    assert out["verdict"].correct, out["verdict"].numbers
    assert out["verdict"].numbers["wrong_node"][0] == 0


def test_the_control_is_not_correct():
    v = run_small(CELL, control="int16")["verdict"]
    assert not v.correct
    assert v.numbers["wrong_node"][0] > 0, v.numbers


@pytest.mark.parametrize(
    "fault,caught_by",
    [
        (_state_unchanged, ("over_chips", "leaked_claims")),
        (_half_burst, ("wrong_node", "infeasible_bind")),
        (_altered_answer, ("wrong_node", "infeasible_bind")),
    ],
    ids=["unchanged", "half", "altered"],
)
def test_each_fault_makes_the_run_not_correct(fault, caught_by):
    v = run_small(CELL, fault=fault)["verdict"]
    assert not v.correct
    assert any(v.numbers[n][0] > 0 for n in caught_by), v.numbers
