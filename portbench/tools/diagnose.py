"""Run a cell and explain every pick the reference calls wrong: for each
evaluation that can have served it and each state the ingest allows,
the reference's pick, and how many rows of the program's dynamics
(reservations, claims) and of its result row (scores, feasibility,
claimable chips) differ from the reference's; with the time from the
program's read of its state to the evaluation, and the watch batches the
program applied about then.

    python3 portbench/tools/diagnose.py --workload batch5k.singles-backlog \\
        --seeds 11,12 --seconds 50 [--trace 1]

A state with no difference whose pick still departs points at the
reference's serving rule; differing dynamics at the model of the ingest
or the program's feeds; differing result rows at the evaluation. This tool is not
run by the benchmark."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from portbench.harness import fleet as fleet_mod  # noqa: E402
from portbench.harness import reference, runner  # noqa: E402


def _rows(result) -> tuple:
    return tuple(np.array(x, dtype=np.int64)
                 for x in (result.scores, result.feasible, result.claimable))


class Probe:
    """The program's view of each evaluation of a sampled pod: its
    dynamics and result row. Installed as a run's ``fault`` hook, it
    changes nothing."""

    def __init__(self, sample: set) -> None:
        self.sample = sample
        self.views: list = []       # dict(t, key, burst, names, dyn, row)
        self._pods = None

    def install(self, stack, cluster) -> None:
        batch, kern = stack.batch, stack.batch._kern
        inner_eval = kern.evaluate_burst
        inner_prep, inner_fs = batch.prepare_burst, batch.filter_and_score_batch

        def evaluate_burst(dyn, *a, **kw):
            results = inner_eval(dyn, *a, **kw)
            pods, self._pods = self._pods, None
            for key, result in zip(pods or (), results):
                if key in self.sample:
                    self.views.append(dict(
                        t=time.monotonic(), key=key, burst=len(pods) > 1,
                        names=list(kern._names), dyn=np.array(dyn[1:3], dtype=np.int64),
                        row=_rows(result)))
            return results

        def prepare_burst(pods, snapshot):
            self._pods = [p.key for p in pods]
            try:
                return inner_prep(pods, snapshot)
            finally:
                self._pods = None

        def filter_and_score_batch(state, pod, snapshot):
            self._pods = [pod.key]
            try:
                return inner_fs(state, pod, snapshot)
            finally:
                self._pods = None

        kern.evaluate_burst = evaluate_burst
        batch.prepare_burst = prepare_burst
        batch.filter_and_score_batch = filter_and_score_batch


def diagnose(out: dict, probe: Probe) -> list:
    """One record per wrong pick."""
    cfg, settings, fleet, prefill, reqs, sample, _held = out["inputs"]
    run = out["run"]
    st = reference.Static.build(fleet, prefill.used)
    found = []

    class Explain(reference.Replay):
        def _judge_pick(self, req, row, t_bind, unix):
            verdict = super()._judge_pick(req, row, t_bind, unix)
            if verdict is not False:
                return verdict
            rec = dict(key=req.key, chips=req.chips, node=st.names[row],
                       window=(run.t_start - t_bind, run.t_end - t_bind), candidates=[])
            ev = self._evaluator(req)
            fresh = self._fresh(unix)
            ok = np.ones(len(st.names), dtype=bool)
            for e, taken in self._candidates(req.key, t_bind):
                views = [v for v in probe.views if v["key"] == req.key
                         and v["burst"] == bool(e.groups) and v["t"] >= e.t][:1]
                states = []
                for res, cl in self._states(e):
                    feas, claimable = ev.feasible(res, fresh, ok)
                    final = ev.scores(feas, cl)
                    p = reference.pick(final, self._net(feas, claimable, taken, ev.r.number),
                                       self.name_rank)
                    state = dict(pick=st.names[p] if p >= 0 else None)
                    for v in views:
                        sc, fe, cla = v["row"]
                        at = [(i, st.index[nm]) for i, nm in enumerate(v["names"])]
                        diff = [(st.names[j], int(v["dyn"][0][i]), int(res[j]),
                                 int(v["dyn"][1][i]), int(cl[j])) for i, j in at
                                if v["dyn"][0][i] != res[j] or v["dyn"][1][i] != cl[j]]
                        state.update(dyn_diff=len(diff), diff_rows=diff[:6], row_diff=sum(
                            1 for i, j in at if bool(fe[i]) != bool(feas[j])
                            or (fe[i] and (sc[i] != final[j] or cla[i] != claimable[j]))))
                    states.append(state)
                rec["candidates"].append(dict(
                    dt=e.t - t_bind, burst=bool(e.groups), read_s=e.t - e.read_from,
                    taken_rows=len(taken), program_view=bool(views),
                    batches=[(b.t_start - e.t, b.t_informer - e.t, b.t_end - e.t, len(b.keys))
                             for b in run.batches
                             if b.t_end >= e.read_from - 0.05 and b.t_start <= e.t],
                    states=states))
            found.append(rec)
            return verdict

    replay = Explain(st, reqs, settings, cfg["fleet"]["generation_rank"], run.publishes,
                     run.evaluations, sample=sample, batches=run.batches)
    replay.prefill(prefill.pods)
    for e in run.events:
        if not (e.kind == "add" and e.node):
            replay.on_event(e)
    return found


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=50)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = runner.find_cell(ROOT, bench, args.workload)
    fleet = fleet_mod.build_fleet(cell.config)
    for seed in [int(s) for s in args.seeds.split(",")]:
        sample = cell.generator.Traffic(cell.mix, fleet, seed, {}, cell.config["settings"],
                                        args.seconds).sample()
        probe = Probe(sample)
        out = runner.run_cell(ROOT, bench, args.workload, seed, args.seconds,
                              bool(args.trace), t_process=time.monotonic(),
                              fault=probe.install)
        v = out["verdict"]
        print(json.dumps(dict(seed=seed, trace=args.trace, correct=v.correct,
                              numbers={k: n[0] for k, n in v.numbers.items()},
                              notes=v.notes)), flush=True)
        for rec in diagnose(out, probe):
            print("wrong " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
