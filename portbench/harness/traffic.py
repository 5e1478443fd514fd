"""What every traffic generator shares: the context it drives the cluster
through, seeded pools of requests, and the churn that keeps the fleet
below its fill limit.

A generator module (``portbench/generators/<kind>.py``) defines
``Traffic(mix, fleet, seed, reqs, settings, window_s)`` with
``warmup(ctx)``, ``drive(ctx, t_start, t_end)`` and ``sample()`` (the pods
whose nodes the reference judges). Its pods' sizes come from the mix's
``sizes_seed``, the same for every run; the run's seed only orders them,
so every seed gives the same work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.harness.fleet import PodReq, draw_singleton
from portbench.harness.port import pod_spec


@dataclass
class Ctx:
    """The cluster API as a generator sees it."""

    cluster: object
    recorder: object       # port.Recorder: the live log
    reqs: dict             # every PodReq of the run, by key
    fleet: object
    run_until_idle: object  # drain the queue in the calling thread (set-up only)
    flush: object           # apply the ingest batcher's residue now

    def create(self, req: PodReq) -> None:
        self.reqs[req.key] = req
        self.cluster.create_pod(pod_spec(req))

    def delete(self, key: str) -> None:
        self.cluster.delete_pod(key)

    @property
    def chips_total(self) -> int:
        return self.fleet.chips_total


def singles_pool(mix: dict, n: int, seed: int, prefix: str) -> list:
    """``n`` singletons of the mix, in blocks of ``mix["block"]``: one block
    of sizes drawn from the mix's own seed, repeated, each copy in an order
    of the run's seed. Every run, whatever its seed, binds the same sizes
    in any whole number of blocks."""
    block = int(mix.get("block", 256))
    sizes = np.random.default_rng(mix["sizes_seed"])
    drawn = [draw_singleton(sizes, mix) for _ in range(block)]
    rng = np.random.default_rng([seed, 11])
    order = np.concatenate([rng.permutation(block) for _ in range(-(-n // block))])
    return [
        PodReq(f"bench/{prefix}-{i:05d}", **drawn[j]) for i, j in enumerate(order[:n])
    ]


def sampled(keys: list, seed: int, n: int) -> set:
    """A seeded sample of ``n`` keys (all of them when fewer)."""
    if len(keys) <= n:
        return set(keys)
    idx = np.random.default_rng([seed, 13]).choice(len(keys), size=n, replace=False)
    return {keys[int(i)] for i in idx}


class Churn:
    """Deletes the traffic's own oldest bound units (pods, gangs or apps)
    whole once the chips held pass ``high`` of the fleet's, down to
    ``low``: the completions of a running fleet, in bursts, so most binds
    lie in a quiet stretch the reference can judge exactly."""

    def __init__(self, mix: dict) -> None:
        self.high = mix["churn"]["high"]
        self.low = mix["churn"]["low"]
        self.units: list = []      # (unit id, [keys]) in submission order

    def add(self, unit: str, keys: list) -> None:
        self.units.append((unit, keys))

    def bound_units(self, rec) -> list:
        with rec.cond:
            return [(u, ks) for u, ks in self.units
                    if all(k in rec.node_of for k in ks)]

    def step(self, ctx: Ctx, need: int = 0) -> None:
        """Delete whole units, oldest first, once the chips held plus
        ``need`` pass the high mark, until they are under the low mark."""
        rec = ctx.recorder
        limit_hi = self.high * ctx.chips_total
        limit_lo = self.low * ctx.chips_total
        with rec.cond:
            held = rec.held_total
        if held + need <= limit_hi:
            return
        for unit, keys in self.bound_units(rec):
            if held + need <= limit_lo:
                break
            for k in keys:
                held -= max(ctx.reqs[k].chips, 1)
                ctx.delete(k)
            self.units.remove((unit, keys))

