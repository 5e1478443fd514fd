"""Backlog: the pending queue is topped up with singletons of the mix
whenever it falls below ``pending_min``, so the scheduler never waits for
work: the metric is the rate of binds. The traffic deletes its own oldest bound pods once the fleet passes its fill
mark."""

from __future__ import annotations

import time

from portbench.harness.traffic import Churn, singles_pool, sampled


class Traffic:
    def __init__(self, mix: dict, fleet, seed: int, reqs: dict, settings: dict,
                 window_s: float) -> None:
        self.mix = mix
        self.pods = singles_pool(mix, int(mix["pool"]), seed, "s")
        self.warm = singles_pool(mix, int(mix["warmup_pods"]), seed + 1, "warm")
        self.churn = Churn(mix)
        self.next = 0
        self._sample = sampled([p.key for p in self.pods[: int(mix["sample_from"])]],
                               seed, int(mix["sample"]))

    def warmup(self, ctx) -> None:
        # One burst of the cell's width: K pods pending together.
        for req in self.warm:
            ctx.create(req)
        ctx.flush()
        ctx.run_until_idle()
        for req in self.warm:
            ctx.delete(req.key)
        ctx.flush()

    def _top_up(self, ctx) -> None:
        rec = ctx.recorder
        with rec.cond:
            pending = len(rec.pending)
        want = int(self.mix["pending_target"]) - pending
        for _ in range(max(want, 0)):
            if self.next >= len(self.pods):
                raise RuntimeError("the traffic's pool of pods ran out")
            req = self.pods[self.next]
            self.next += 1
            ctx.create(req)
            self.churn.add(req.key, [req.key])

    def drive(self, ctx, t_start: float, t_end: float) -> None:
        rec = ctx.recorder
        low = int(self.mix["pending_min"])
        self._top_up(ctx)
        while time.monotonic() < t_end:
            with rec.cond:
                rec.cond.wait_for(lambda: len(rec.pending) < low,
                                  timeout=max(t_end - time.monotonic(), 0))
            if time.monotonic() >= t_end:
                break
            self.churn.step(ctx)
            self._top_up(ctx)

    def sample(self) -> set:
        return self._sample
