"""Overload brownout ladder + config hot-reload.

Every failure domain so far assumed the *cluster* breaks while the
scheduler stays comfortable; this module covers the scheduler itself
under overload, and reconfiguration without a restart:

- :class:`OverloadMonitor` — a strict four-level brownout ladder
  (NOMINAL -> ELEVATED -> BROWNOUT -> SHED) driven by direct pressure
  gauges (queue depth, ingest batch backlog, serve-cycle p99 wall) plus
  the SLO engine's multi-window burn-rate alert. Degradation is ordered
  features-before-correctness:

  * ELEVATED pauses the rebalancer / node-health repair passes (their
    gates read :meth:`repairs_paused`) and drops lifecycle-trace
    sampling to 0 — observability and optimization yield first;
  * BROWNOUT additionally caps per-tenant admission through the DRF
    queue's quota path (:meth:`quota_verdict`, a token bucket per
    tenant on the monitor clock);
  * SHED additionally parks new non-prod-tier arrivals at pop time with
    an ``overload-shed`` why-pending verdict (:meth:`shed_verdict` via
    ``SchedulingQueue.shed_fn``). Bound gangs are never touched and no
    watch event is ever dropped; shed pods sit in the unresolvable pool
    and requeue the moment the ladder steps down.

  Step-up climbs ONE level per evaluation (strict order); step-down is
  debounced — pressure must stay below the current level's entry
  threshold for ``step_down_hold_s`` — so flapping load cannot thrash
  features. One monitor is shared across every serve loop that shares a
  metrics registry (profile stacks, shard lanes), exactly like the
  tracer and the SLO engine.

- :class:`ConfigReloader` + :class:`LiveConfig` — the hot-reload surface
  behind SIGHUP and the ConfigMap-watch (the CLI): a candidate config is
  diffed against the running one (``SchedulerConfig.diff``), each
  changed knob classified reloadable-live / resize / requires-drain /
  immutable; reloadable knobs apply atomically through
  ``standalone.apply_reloadable`` (each consumer re-reads its live
  attribute), ``shard_count`` goes through ``ShardSet.resize``, and
  everything else is reported with its old value kept — a reload can
  never half-apply.

Lock discipline: the verdict hooks (:meth:`shed_verdict`,
:meth:`quota_verdict`) run under the scheduling-queue lock — they touch
only the monitor's own state. Signal collection (:meth:`evaluate`)
runs on the monitor's background thread and takes component locks one
at a time, never while holding its own.

Counterpart of ``yoda_tpu/overload.py``, whole. ``build_stack``
registers its ``EventBatcher`` (batched ingest on) as an ingestor, so the
``ingest`` signal reads the batchers' coalesced ``backlog()`` against
``ingest_high``; BROWNOUT's token bucket is per tenant when the queue is
(``tenant_fairness``), else the one tenant ``""``. The CLI installs SIGHUP
and the ConfigMap watch and gives a sharded assembly's reloader
``ShardSet.resize`` as its ``resize_fn``; without one ``shard_count``
reports as requires-drain.

Two repairs over the reference, both for a loop left with nothing to
run (every draw parked, no bind in flight): the cycle signal reads 0
when no cycle completed since the previous evaluation, so a stale p99
cannot hold the ladder up; and draws the BROWNOUT cap parked re-enter
the active queue at each evaluation, as their buckets refill. Without
them such a queue waited for a cluster event that never came.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import replace as _dc_replace
from typing import Callable

from yoda_tpu_torch.api.requests import LabelParseError, pod_request
from yoda_tpu_torch.config import SchedulerConfig

log = logging.getLogger("yoda_tpu_torch.overload")

#: The ladder, strict order. Indexes are the yoda_overload_level gauge.
LEVELS = ("NOMINAL", "ELEVATED", "BROWNOUT", "SHED")
NOMINAL, ELEVATED, BROWNOUT, SHED = range(4)

#: Pressure thresholds for entering each level (pressure is the max of
#: the normalized signals; 1.0 = a signal at its configured high-water
#: mark). Module constants, not knobs: the knobs scale the signals.
ENTER_AT = (0.0, 1.0, 2.0, 4.0)


def _priority_of(pod) -> int:
    try:
        return pod_request(pod).priority
    except LabelParseError:
        # Malformed labels park through the normal unresolvable path
        # anyway; under SHED they are non-prod by definition.
        return 0


class OverloadMonitor:
    """The brownout ladder. Built once per shared metrics registry
    (standalone._metrics_from_config) and wired by build_stack: queues
    and ingestors register as pressure sources, the tracer / latency
    histogram / SLO engine attach for the feature-pause and burn
    signals, and the repair-loop gates compose :meth:`repairs_paused`.
    """

    def __init__(
        self,
        *,
        queue_high: int = 10000,
        ingest_high: int = 50000,
        cycle_ms_high: float = 250.0,
        step_down_hold_s: float = 15.0,
        brownout_admit_per_s: float = 10.0,
        shed_priority_floor: int = 10,
        period_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.queue_high = int(queue_high)
        self.ingest_high = int(ingest_high)
        self.cycle_ms_high = float(cycle_ms_high)
        self.step_down_hold_s = float(step_down_hold_s)
        self.brownout_admit_per_s = float(brownout_admit_per_s)
        self.shed_priority_floor = int(shed_priority_floor)
        self.period_s = float(period_s)
        self.clock = clock
        # Current ladder position: a bare int read lock-free by the
        # verdict hooks (CPython attribute reads are atomic; a stale
        # read costs one extra pop-time verdict, never correctness).
        self.level_idx = NOMINAL
        self.transitions = 0
        self.shed_total = 0          # bumped by the queue's on_shed hook
        self.evaluations = 0
        self.last_pressure = 0.0
        self._below_since: float | None = None
        self._lock = threading.Lock()
        # Pressure sources / feature handles (build_stack wiring).
        self._queues: list = []
        self._ingestors: list = []
        self.tracer = None
        self.latency = None          # yoda_scheduling_latency histogram
        self.slo = None
        self._base_sample_rate: float | None = None
        # BROWNOUT token buckets: tenant -> [tokens, last_refill].
        self._buckets: dict[str, list] = {}
        # A draw capped since the previous evaluation (re-admitted there
        # to retake the cap), and the cycle count the previous evaluation
        # saw (the cycle signal reads only newer cycles).
        self._capped = False
        self._cycle_mark = 0

    # --- wiring -------------------------------------------------------

    def add_queue(self, queue) -> None:
        with self._lock:
            if queue not in self._queues:
                self._queues.append(queue)

    def remove_queue(self, queue) -> None:
        with self._lock:
            if queue in self._queues:
                self._queues.remove(queue)

    def add_ingestor(self, batcher) -> None:
        with self._lock:
            if batcher not in self._ingestors:
                self._ingestors.append(batcher)

    def remove_ingestor(self, batcher) -> None:
        with self._lock:
            if batcher in self._ingestors:
                self._ingestors.remove(batcher)

    def attach(self, *, tracer=None, latency=None, slo=None) -> None:
        if tracer is not None:
            self.tracer = tracer
        if latency is not None:
            self.latency = latency
        if slo is not None:
            self.slo = slo

    # --- the feature gates (read by other components) -----------------

    @property
    def level(self) -> str:
        return LEVELS[self.level_idx]

    def repairs_paused(self) -> bool:
        """True at ELEVATED and above: the rebalancer and node-health
        repair passes yield their cycles to the serve loops (their
        gate_fn composes this). Event-time signals (deletions, ghost
        releases) stay live — only the background passes pause."""
        return self.level_idx >= ELEVATED

    def shed_verdict(self, pod) -> "str | None":
        """SHED only: the why-pending message for a NON-prod-tier pod
        that must park instead of scheduling, else None. Called by the
        queue under its lock per popped entry — own-state reads only.
        Deterministic in (labels, level): every member of a
        (tier-homogeneous) gang gets the same answer, so gangs shed
        whole; the mid-Permit guard lives in the standalone wiring."""
        if self.level_idx < SHED:
            return None
        if _priority_of(pod) >= self.shed_priority_floor:
            return None
        return (
            "overload shed: scheduler at SHED "
            f"(pressure {self.last_pressure:.2f}); non-prod arrival "
            "parked until the ladder steps down"
        )

    def note_shed(self) -> None:
        """One draw shed (the queue's on_shed hook, under its lock)."""
        with self._lock:
            self.shed_total += 1

    def quota_verdict(self, tenant: str) -> "str | None":
        """BROWNOUT and above: per-tenant admission cap through the DRF
        quota path. A scheduling draw consumes one token from the
        tenant's bucket (refilled at ``brownout_admit_per_s`` on the
        monitor clock, burst = one second's worth); an empty bucket
        parks the draw with a quota verdict until it refills or the
        ladder steps down. Called under the queue lock — dict math on
        the monitor's own state only."""
        if self.level_idx < BROWNOUT:
            return None
        now = self.clock()
        rate = self.brownout_admit_per_s
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = [rate, now]
            tokens = min(b[0] + (now - b[1]) * rate, rate)
            b[1] = now
            if tokens >= 1.0:
                b[0] = tokens - 1.0
                return None
            b[0] = tokens
            self._capped = True
        return (
            f"overload brownout: tenant {tenant or '(default)'} admission "
            f"capped at {rate:g}/s until pressure subsides"
        )

    # --- signals ------------------------------------------------------

    def pressure(self) -> "dict[str, float]":
        """The normalized pressure signals (1.0 = at the high-water
        mark) and their max. Takes component locks one at a time; never
        called with the monitor lock held."""
        with self._lock:
            queues = list(self._queues)
            ingestors = list(self._ingestors)
        signals: dict[str, float] = {}
        if self.queue_high > 0 and queues:
            depth = 0
            for q in queues:
                fn = getattr(q, "overload_depth", None)
                depth += fn() if fn is not None else len(q)
            signals["queue"] = depth / self.queue_high
        if self.ingest_high > 0 and ingestors:
            backlog = sum(b.backlog() for b in ingestors)
            signals["ingest"] = backlog / self.ingest_high
        if self.cycle_ms_high > 0 and self.latency is not None:
            # Only a loop that completed a cycle since the previous
            # evaluation is under cycle pressure: the ring keeps its p99
            # while nothing runs, and a slow cycle before a parked queue
            # would otherwise hold the ladder up (and the queue parked)
            # for good.
            signals["cycle"] = 0.0
            if self.latency.count(phase="total") != self._cycle_mark:
                p99_ms = self.latency.quantile(0.99, phase="total") * 1e3
                signals["cycle"] = p99_ms / self.cycle_ms_high
        if self.slo is not None and getattr(self.slo, "enabled", False):
            try:
                fast, slow = self.slo.burn_snapshot()
                threshold = getattr(self.slo, "burn_threshold", 0.0)
                if threshold > 0 and fast >= threshold and slow >= threshold:
                    # A firing burn alert is BROWNOUT-grade pressure on
                    # its own: the error budget is being spent now.
                    signals["burn"] = ENTER_AT[BROWNOUT]
            except Exception:  # noqa: BLE001 — a sick engine must not wedge the ladder
                pass
        signals["max"] = max(
            (v for k, v in signals.items() if k != "max"), default=0.0
        )
        return signals

    # --- the ladder ---------------------------------------------------

    def evaluate(self, now: "float | None" = None) -> str:
        """One ladder tick: read the signals, step up at most one level
        (strict order), step down one level only after
        ``step_down_hold_s`` of sustained calm. Returns the level."""
        now = self.clock() if now is None else now
        mark = self.latency.count(phase="total") if self.latency is not None else 0
        p = self.pressure()["max"]
        self._cycle_mark = mark
        self.last_pressure = p
        self.evaluations += 1
        step_down_to = None
        with self._lock:
            capped, self._capped = self._capped, False
            idx = self.level_idx
            target = NOMINAL
            for lvl in (ELEVATED, BROWNOUT, SHED):
                if p >= ENTER_AT[lvl]:
                    target = lvl
            if target > idx:
                self._transition_locked(idx + 1)
                self._below_since = None
            elif idx > NOMINAL and p < ENTER_AT[idx]:
                if self._below_since is None:
                    self._below_since = now
                elif now - self._below_since >= self.step_down_hold_s:
                    self._transition_locked(idx - 1)
                    step_down_to = self.level_idx
                    # The hold restarts per step: dropping from SHED to
                    # NOMINAL takes three sustained-calm windows.
                    self._below_since = now
            else:
                self._below_since = None
            queues = list(self._queues)
        if step_down_to is not None or (capped and self.level_idx >= BROWNOUT):
            # Shed/brownout-parked entries re-enter the active queue NOW
            # (not at the next cluster event): the ladder stepping down
            # IS the capacity event they were waiting for. Capped draws
            # re-enter at every evaluation while the cap holds: their
            # buckets have refilled since, and when no bind is left in
            # flight nothing else would wake them.
            for q in queues:
                try:
                    q.move_all_to_active()
                except Exception:  # noqa: BLE001 — one sick queue must not wedge the rest
                    log.exception("overload step-down reactivation failed")
        return self.level

    def _transition_locked(self, new_idx: int) -> None:
        old = self.level_idx
        self.level_idx = new_idx
        self.transitions += 1
        if old < ELEVATED <= new_idx and self.tracer is not None:
            # Feature pause, step 1: tracing yields first. The base rate
            # is restored (or a reloaded value applied) on the way down.
            self._base_sample_rate = self.tracer.sample_rate
            self.tracer.sample_rate = 0.0
        elif new_idx < ELEVATED <= old and self.tracer is not None:
            if self._base_sample_rate is not None:
                self.tracer.sample_rate = self._base_sample_rate
                self._base_sample_rate = None
        if new_idx < BROWNOUT <= old:
            self._buckets.clear()
        log.warning(
            "overload ladder: %s -> %s (pressure %.2f)",
            LEVELS[old], LEVELS[new_idx], self.last_pressure,
        )

    def set_base_sample_rate(self, rate: float) -> None:
        """Hot-reload entry for ``trace_sample_rate``: applied to the
        tracer now, or remembered for the step-down restore while the
        ladder has sampling paused."""
        with self._lock:
            if self.level_idx >= ELEVATED and self.tracer is not None:
                self._base_sample_rate = rate
            elif self.tracer is not None:
                self.tracer.sample_rate = rate

    def run_forever(self, stop: threading.Event) -> None:
        """The background evaluation loop (a thread of its own). ``period_s`` is
        re-read per tick — it is a reloadable knob."""
        while not stop.is_set():
            period = self.period_s
            if period <= 0:
                if stop.wait(1.0):
                    return
                continue
            if stop.wait(period):
                return
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 — the ladder must survive its own bugs
                log.exception("overload evaluation failed; will retry")


# --- config hot-reload ------------------------------------------------------


class LiveConfig:
    """The swap-atomic holder for the running SchedulerConfig: readers
    take ``current`` (one attribute read — CPython reference reads are
    atomic), the reloader swaps it under the lock and bumps
    ``generation``."""

    def __init__(self, config: SchedulerConfig) -> None:
        self._lock = threading.Lock()
        self._config = config
        self.generation = 0

    @property
    def current(self) -> SchedulerConfig:
        return self._config

    def replace(self, config: SchedulerConfig) -> None:
        with self._lock:
            self._config = config
            self.generation += 1


class ConfigReloader:
    """The SIGHUP / ConfigMap-watch reload (the CLI owns the triggers).

    ``load_fn`` produces the candidate SchedulerConfig (raises on a bad
    file — the running config is kept and the error reported, never a
    half-parsed apply). ``apply_fn`` is ``standalone.apply_reloadable``
    bound to the live stacks; ``resize_fn`` (sharded mode only) is
    ``ShardSet.resize``. Each reload returns a report dict naming what
    was applied, what needs a drain, what was refused as immutable."""

    def __init__(
        self,
        load_fn: Callable[[], SchedulerConfig],
        live: LiveConfig,
        apply_fn: Callable[[SchedulerConfig], None],
        *,
        resize_fn: "Callable[[int], dict] | None" = None,
    ) -> None:
        self.load_fn = load_fn
        self.live = live
        self.apply_fn = apply_fn
        self.resize_fn = resize_fn
        self._lock = threading.Lock()
        self.reloads = 0

    def reload(self) -> dict:
        with self._lock:
            try:
                candidate = self.load_fn()
            except Exception as e:  # noqa: BLE001 — keep serving on the old config
                log.error("config reload failed to load: %s", e)
                return {"error": str(e), "applied": [], "requires_drain": [],
                        "immutable": [], "resized": None}
            current = self.live.current
            diff = current.diff(candidate)
            applied = sorted(k for k, c in diff.items() if c == "reloadable")
            drain = sorted(
                k for k, c in diff.items() if c == "requires-drain"
            )
            immutable = sorted(k for k, c in diff.items() if c == "immutable")
            resized = None
            effective = current
            if applied:
                effective = _dc_replace(
                    effective,
                    **{k: getattr(candidate, k) for k in applied},
                )
            if diff.get("shard_count") == "resize":
                if self.resize_fn is not None:
                    try:
                        resized = self.resize_fn(candidate.shard_count)
                        effective = _dc_replace(
                            effective, shard_count=candidate.shard_count
                        )
                    except Exception as e:  # noqa: BLE001 — a failed resize keeps the old topology
                        log.exception("live shard resize failed")
                        return {
                            "error": f"resize failed: {e}",
                            "applied": [], "requires_drain": drain,
                            "immutable": immutable, "resized": None,
                        }
                else:
                    drain = sorted({*drain, "shard_count"})
            self.live.replace(effective)
            if applied:
                # Atomic in the operator-visible sense: every consumer
                # reads its knob live, and the apply runs before the
                # report returns — no window serves a mix of files.
                self.apply_fn(effective)
            self.reloads += 1
            report = {
                "applied": applied,
                "requires_drain": drain,
                "immutable": immutable,
                "resized": resized,
                "error": None,
            }
            if applied or drain or immutable or resized:
                log.info(
                    "config reload: applied=%s requires-drain=%s "
                    "immutable(kept)=%s resized=%s",
                    applied, drain, immutable,
                    (resized or {}).get("shards") if resized else None,
                )
            return report
