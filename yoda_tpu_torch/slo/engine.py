"""Sliding-window SLI engine + declarative SLO evaluation.

Counterpart of ``yoda_tpu/slo/engine.py``, whole: ``SloTargets`` (the
config's ``slo_targets`` knob) and ``SloEngine``.

- **SLIs** are computed from events the scheduler already emits, at the
  cost of one lock + a deque append per event (the serve path never
  evaluates anything):

  * *admission wait* — the enqueue→bound edge per pod, per tenant
    (``observe_enqueue`` fired by the informer's pending hook,
    ``observe_bound`` by both bind completion paths), windowed quantiles;
  * *starvation windows* — a tenant with queued work and ZERO admissions
    across a full ``starvation_window_s`` has been starved for that
    window (the queue's ``tenant_wait_stats`` feeds the pending side);
  * *preemption / repair rates* — timestamps from the preemption plugin,
    the rebalancer's priority preemptions, and nodehealth gang repairs;
  * *chip-utilization goodput* — the accountant-backed bin-packing
    efficiency gauge, sampled at evaluation time.

- **SLO targets** are declarative (:class:`SloTargets`, config
  ``slo_targets``) and evaluated with the multi-window burn-rate
  discipline: the admission SLI's error budget (fraction of admissions
  slower than the target p99, against an ``admission_wait_slo`` goal) is
  burned over a FAST and a SLOW window; an alert fires only when BOTH
  windows burn past ``burn_threshold``.

The engine rides :class:`~yoda_tpu_torch.observability.SchedulingMetrics`
like the tracer and the why-pending index, and is served at
``GET /debug/slo`` and as the ``yoda_slo_*`` Prometheus series. Tenants
come from ``framework.tenancy.tenant_of``; the pending side reads the
queues' ``tenant_wait_stats``, which report per tenant with
``tenant_fairness`` on and everything under the ``""`` tenant with it
off. Left out: nothing of this module; the CLI's ``slo`` command waits
for the CLI.

Everything is stdlib-only; evaluation is on-demand (scrape / HTTP) and
cached for ``cache_ttl_s`` on the engine clock so one scrape's eight
series see one consistent evaluation.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, fields
from typing import Callable

from yoda_tpu_torch.framework.tenancy import tenant_of as _tenant_of

# Bound on distinct pod keys awaiting their bound edge: an LRU so a
# million-pod churn stream of never-bound foreign/parked pods cannot grow
# the join map without bound (same discipline as the tracer's subjects).
MAX_ENQUEUED = 65536

# Per-tenant admission-sample ring bound (exact quantiles up to this many
# samples inside the slow window).
MAX_SAMPLES = 4096

# Bound on event-timestamp rings (preemptions / repairs / goodput).
MAX_EVENTS = 8192


def _quantile(sorted_vals: "list[float]", q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(int(len(sorted_vals) * q), len(sorted_vals) - 1)]


@dataclass(frozen=True)
class SloTargets:
    """Declarative per-tenant service-level objectives (config
    ``slo_targets``). 0 disables the corresponding target entirely —
    the SLI is still computed and exported, just never alerted on."""

    # Admission wait: p99 of enqueue->bound per tenant must stay under
    # this many seconds; the burn-rate SLI counts an admission slower
    # than this as error-budget spend against the admission_wait_slo goal.
    admission_wait_p99_s: float = 60.0
    # Fraction of admissions that must land under the target (the error
    # budget is 1 - this; burn rate = bad fraction / budget).
    admission_wait_slo: float = 0.99
    # Tolerated starved windows per tenant (a window is
    # slo_starvation_window_s of queued work with zero admissions).
    # The bench matrix asserts 0.
    starved_windows: int = 0
    # Fleet preemption / repair rates (per minute over the fast window)
    # above these alert; 0 = no target.
    preemption_rate_per_min: float = 0.0
    repair_rate_per_min: float = 0.0
    # Minimum chip-utilization goodput (bin-packing efficiency in [0,1])
    # the fleet must hold while loaded; 0 = no target.
    goodput_min: float = 0.0

    @classmethod
    def from_dict(cls, d: dict) -> "SloTargets":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown slo_targets keys: {sorted(unknown)}")
        bad = {
            k: v
            for k, v in d.items()
            if isinstance(v, bool) or not isinstance(v, (int, float)) or v < 0
        }
        if bad:
            raise ValueError(
                f"slo_targets values must be non-negative numbers: {bad}"
            )
        cfg = cls(**d)
        if not 0 < cfg.admission_wait_slo < 1:
            raise ValueError(
                "slo_targets.admission_wait_slo must be in (0, 1), got "
                f"{cfg.admission_wait_slo!r}"
            )
        if cfg.goodput_min > 1:
            raise ValueError(
                "slo_targets.goodput_min must be in [0, 1], got "
                f"{cfg.goodput_min!r}"
            )
        if int(cfg.starved_windows) != cfg.starved_windows:
            raise ValueError(
                "slo_targets.starved_windows must be an integer, got "
                f"{cfg.starved_windows!r}"
            )
        return cfg

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


class SloEngine:
    """Event-fed SLI accumulators + on-demand SLO evaluation.

    Record paths (``observe_*``) are serve-path-cheap: one attribute read
    when disabled, one lock + a dict/deque op when enabled — the < 2%
    pods/s overhead contract the bench pair proves. ``evaluate`` walks
    the windows, updates starvation accounting, and returns the full
    per-tenant + fleet summary; it runs only on scrape/HTTP/CLI/bench
    demand, never on a serve loop."""

    def __init__(
        self,
        *,
        targets: "SloTargets | None" = None,
        enabled: bool = True,
        starvation_window_s: float = 60.0,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        burn_threshold: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        cache_ttl_s: float = 1.0,
    ) -> None:
        self.targets = targets if targets is not None else SloTargets()
        self.enabled = bool(enabled)
        self.starvation_window_s = max(float(starvation_window_s), 1e-9)
        self.fast_window_s = max(float(fast_window_s), 1e-9)
        self.slow_window_s = max(float(slow_window_s), self.fast_window_s)
        self.burn_threshold = float(burn_threshold)
        self.clock = clock
        self.cache_ttl_s = max(float(cache_ttl_s), 0.0)
        # Chip-utilization goodput source (standalone wires the
        # accountant-backed bin-packing-efficiency gauge); sampled at
        # evaluation time only.
        self.goodput_fn: "Callable[[], float] | None" = None
        self.evaluations = 0
        self._lock = threading.Lock()
        # pod key -> (tenant, enqueue time): the enqueue->bound join.
        self._enqueued: "OrderedDict[str, tuple[str, float]]" = OrderedDict()
        # tenant -> ring of (bound time, wait seconds).
        self._admissions: "dict[str, deque[tuple[float, float]]]" = {}
        self._admission_total: "dict[str, int]" = {}
        self._last_admission: "dict[str, float]" = {}
        self._preemptions: "deque[float]" = deque(maxlen=MAX_EVENTS)
        self._repairs: "deque[float]" = deque(maxlen=MAX_EVENTS)
        # tenant -> cumulative starved windows / the window-accounting mark.
        self._starved: "dict[str, int]" = {}
        self._starve_mark: "dict[str, float]" = {}
        # SchedulingQueue providers of tenant_wait_stats() — one per stack
        # sharing this engine (profiles, federation members).
        self._queues: list = []
        self._cache: "dict | None" = None
        self._cache_at = float("-inf")

    # --- wiring (standalone.build_stack) ---

    def add_queue(self, queue) -> None:
        """Register a stack's scheduling queue as a pending-work source
        (``tenant_wait_stats``). Idempotent per queue object."""
        with self._lock:
            if queue not in self._queues:
                self._queues.append(queue)

    def remove_queue(self, queue) -> None:
        """Retire a queue (a shard lane dissolved by a live resize): its
        pending work no longer feeds the starvation SLIs."""
        with self._lock:
            if queue in self._queues:
                self._queues.remove(queue)

    # --- the record paths (serve-path cheap) ---

    def observe_enqueue(self, pod, *, now: "float | None" = None) -> None:
        """A pod became pending (the informer's enqueue edge). First
        sight wins: requeues and watch re-deliveries do not reset the
        admission clock — the SLI is time-to-FIRST-bind."""
        if not self.enabled:
            return
        now = self.clock() if now is None else now
        tenant = _tenant_of(pod)
        key = pod.key
        with self._lock:
            if key in self._enqueued:
                return
            self._enqueued[key] = (tenant, now)
            while len(self._enqueued) > MAX_ENQUEUED:
                self._enqueued.popitem(last=False)

    def observe_bound(self, pod, *, now: "float | None" = None) -> None:
        """The pod bound: close its enqueue->bound edge. Pods with no
        recorded enqueue (adopted at resync, LRU-evicted) are skipped —
        a fabricated zero wait would flatter the quantiles."""
        if not self.enabled:
            return
        now = self.clock() if now is None else now
        with self._lock:
            ent = self._enqueued.pop(pod.key, None)
            if ent is None:
                return
            tenant, t0 = ent
            ring = self._admissions.get(tenant)
            if ring is None:
                ring = self._admissions[tenant] = deque(maxlen=MAX_SAMPLES)
            ring.append((now, max(now - t0, 0.0)))
            self._admission_total[tenant] = (
                self._admission_total.get(tenant, 0) + 1
            )
            self._last_admission[tenant] = now

    def observe_retired(self, pod) -> None:
        """The pod left the system without binding (deleted while
        pending): drop its enqueue record so the join map reflects live
        pods only. No SLI sample — a cancelled ask is not an admission."""
        if not self.enabled:
            return
        with self._lock:
            self._enqueued.pop(pod.key, None)

    def observe_preemption(
        self, n: int = 1, *, now: "float | None" = None
    ) -> None:
        """``n`` pods were preempted (PostFilter eviction or rebalancer
        priority preemption)."""
        if not self.enabled or n <= 0:
            return
        now = self.clock() if now is None else now
        with self._lock:
            for _ in range(min(int(n), MAX_EVENTS)):
                self._preemptions.append(now)

    def observe_repair(self, *, now: "float | None" = None) -> None:
        """One gang-whole repair landed (nodehealth patch/shrink/requeue
        or a rebalancer drain migration)."""
        if not self.enabled:
            return
        now = self.clock() if now is None else now
        with self._lock:
            self._repairs.append(now)

    # --- evaluation ---

    def _rate_per_min(
        self, ring: "deque[float]", now: float
    ) -> float:
        cutoff = now - self.fast_window_s
        n = sum(1 for t in ring if t > cutoff)
        return n / (self.fast_window_s / 60.0)

    def _burn(
        self, samples: "list[tuple[float, float]]", now: float, window: float
    ) -> "tuple[float, int]":
        """(burn rate, samples in window) for the admission SLI over one
        window: bad fraction / error budget."""
        target = self.targets.admission_wait_p99_s
        budget = 1.0 - self.targets.admission_wait_slo
        cutoff = now - window
        n = bad = 0
        for t, wait in samples:
            if t <= cutoff:
                continue
            n += 1
            if target > 0 and wait > target:
                bad += 1
        if n == 0 or target <= 0 or budget <= 0:
            return 0.0, n
        return (bad / n) / budget, n

    def evaluate(self, now: "float | None" = None) -> dict:
        """Compute every SLI over the sliding windows, advance the
        starvation-window accounting, and judge the targets. Returns the
        summary dict ``/debug/slo`` serves. Deterministic for a given
        event history and ``now`` (the seeded-replay contract)."""
        now = self.clock() if now is None else now
        # Goodput is sampled OUTSIDE the engine lock: the hook reads the
        # informer snapshot + accountant, each with locks of their own.
        goodput = None
        if self.enabled and self.goodput_fn is not None:
            try:
                goodput = float(self.goodput_fn())
            except Exception:  # noqa: BLE001 — a sick gauge must not kill /debug/slo
                goodput = None
        with self._lock:
            self.evaluations += 1
            if not self.enabled:
                out = {
                    "now": round(now, 6),
                    "enabled": False,
                    "targets": self.targets.to_dict(),
                    "tenants": {},
                    "fleet": {},
                    "alerts": [],
                }
                self._cache, self._cache_at = out, now
                return out
            horizon = now - self.slow_window_s
            for tenant, ring in list(self._admissions.items()):
                while ring and ring[0][0] <= horizon:
                    ring.popleft()
                if not ring:
                    del self._admissions[tenant]
            while self._preemptions and self._preemptions[0] <= horizon:
                self._preemptions.popleft()
            while self._repairs and self._repairs[0] <= horizon:
                self._repairs.popleft()

            # Pending work, merged across every registered queue.
            pending: "dict[str, tuple[int, float | None]]" = {}
            for q in self._queues:
                try:
                    stats = q.tenant_wait_stats()
                except Exception:  # noqa: BLE001 — one sick queue must not kill SLIs
                    continue
                for tenant, (depth, oldest) in stats.items():
                    pn, po = pending.get(tenant, (0, None))
                    if oldest is not None and (po is None or oldest < po):
                        po = oldest
                    pending[tenant] = (pn + depth, po)

            # Starvation-window accounting: a tenant with queued work and
            # no admission across a whole window is starved for it. The
            # per-tenant mark makes repeated evaluations idempotent.
            W = self.starvation_window_s
            for tenant, (depth, oldest) in pending.items():
                if depth <= 0 or oldest is None:
                    continue
                start = max(self._last_admission.get(tenant, oldest), oldest)
                mark = max(self._starve_mark.get(tenant, start), start)
                windows = int((now - mark) // W)
                if windows > 0:
                    self._starved[tenant] = (
                        self._starved.get(tenant, 0) + windows
                    )
                    mark += windows * W
                self._starve_mark[tenant] = mark
            for tenant in list(self._starve_mark):
                got = pending.get(tenant)
                if got is None or got[0] <= 0:
                    # Queue drained: the starvation clock restarts at the
                    # next enqueue, not from stale history.
                    del self._starve_mark[tenant]

            tenants = sorted(
                set(self._admissions)
                | set(pending)
                | set(self._starved)
                | set(self._admission_total)
            )
            per_tenant: "dict[str, dict]" = {}
            alerts: "list[dict]" = []
            all_samples: "list[tuple[float, float]]" = []
            t_target = self.targets.admission_wait_p99_s
            for tenant in tenants:
                samples = list(self._admissions.get(tenant, ()))
                all_samples.extend(samples)
                waits = sorted(w for _, w in samples)
                depth, oldest = pending.get(tenant, (0, None))
                burn_fast, n_fast = self._burn(
                    samples, now, self.fast_window_s
                )
                burn_slow, n_slow = self._burn(
                    samples, now, self.slow_window_s
                )
                starved = self._starved.get(tenant, 0)
                burning = (
                    t_target > 0
                    and n_fast > 0
                    and burn_fast >= self.burn_threshold
                    and burn_slow >= self.burn_threshold
                )
                row = {
                    "admission_wait_p99_s": round(_quantile(waits, 0.99), 6),
                    "admission_wait_p50_s": round(_quantile(waits, 0.50), 6),
                    "admissions_window": len(samples),
                    "admissions_total": self._admission_total.get(tenant, 0),
                    "pending": depth,
                    "oldest_wait_s": (
                        round(max(now - oldest, 0.0), 6)
                        if (depth > 0 and oldest is not None)
                        else 0.0
                    ),
                    "starved_windows": starved,
                    "burn_fast": round(burn_fast, 4),
                    "burn_slow": round(burn_slow, 4),
                    "alert": "burning" if burning else "ok",
                }
                per_tenant[tenant] = row
                if burning:
                    alerts.append(
                        {
                            "sli": "admission_wait",
                            "tenant": tenant,
                            "burn_fast": row["burn_fast"],
                            "burn_slow": row["burn_slow"],
                        }
                    )
                if starved > self.targets.starved_windows:
                    alerts.append(
                        {
                            "sli": "starvation",
                            "tenant": tenant,
                            "starved_windows": starved,
                        }
                    )

            fleet_waits = sorted(w for _, w in all_samples)
            preempt_rate = self._rate_per_min(self._preemptions, now)
            repair_rate = self._rate_per_min(self._repairs, now)
            fleet_burn_fast, _ = self._burn(
                all_samples, now, self.fast_window_s
            )
            fleet_burn_slow, _ = self._burn(
                all_samples, now, self.slow_window_s
            )
            fleet = {
                "admission_wait_p99_s": round(
                    _quantile(fleet_waits, 0.99), 6
                ),
                "admissions_window": len(all_samples),
                "starved_windows": sum(self._starved.values()),
                "preemption_rate_per_min": round(preempt_rate, 4),
                "repair_rate_per_min": round(repair_rate, 4),
                "goodput": round(goodput, 6) if goodput is not None else None,
                "burn_fast": round(fleet_burn_fast, 4),
                "burn_slow": round(fleet_burn_slow, 4),
            }
            t = self.targets
            if (
                t.preemption_rate_per_min > 0
                and preempt_rate > t.preemption_rate_per_min
            ):
                alerts.append(
                    {
                        "sli": "preemption_rate",
                        "tenant": "",
                        "rate_per_min": fleet["preemption_rate_per_min"],
                    }
                )
            if t.repair_rate_per_min > 0 and repair_rate > t.repair_rate_per_min:
                alerts.append(
                    {
                        "sli": "repair_rate",
                        "tenant": "",
                        "rate_per_min": fleet["repair_rate_per_min"],
                    }
                )
            if (
                t.goodput_min > 0
                and goodput is not None
                and goodput < t.goodput_min
                and (all_samples or any(d for d, _ in pending.values()))
            ):
                # Only judged while the fleet sees traffic: an idle fleet's
                # 0.0 efficiency is not an SLO violation.
                alerts.append(
                    {
                        "sli": "goodput",
                        "tenant": "",
                        "goodput": fleet["goodput"],
                    }
                )
            out = {
                "now": round(now, 6),
                "enabled": True,
                "targets": t.to_dict(),
                "windows": {
                    "starvation_s": self.starvation_window_s,
                    "burn_fast_s": self.fast_window_s,
                    "burn_slow_s": self.slow_window_s,
                    "burn_threshold": self.burn_threshold,
                },
                "tenants": per_tenant,
                "fleet": fleet,
                "alerts": alerts,
            }
            self._cache, self._cache_at = out, now
            return out

    def summary(self) -> dict:
        """A FRESH evaluation (the /debug/slo and CLI surface)."""
        return self.evaluate()

    def _cached(self) -> dict:
        """At-most-once-per-``cache_ttl_s`` evaluation: one scrape's
        eight ``yoda_slo_*`` series read one consistent summary instead
        of re-walking the windows per series."""
        now = self.clock()
        with self._lock:
            cache, at = self._cache, self._cache_at
        if cache is not None and now - at < self.cache_ttl_s:
            return cache
        return self.evaluate(now)

    def burn_snapshot(self) -> "tuple[float, float]":
        """(fast, slow) fleet burn rates from the cached evaluation —
        the overload monitor's burn-pressure signal (cheap: at most one
        window walk per cache_ttl_s across every consumer)."""
        fleet = self._cached().get("fleet", {})
        return (
            float(fleet.get("burn_fast", 0.0) or 0.0),
            float(fleet.get("burn_slow", 0.0) or 0.0),
        )

    # --- Prometheus views (lazy collect_fns, observability.py) ---

    def prom_admission_p99(self) -> dict:
        return {
            (("tenant", t),): row["admission_wait_p99_s"]
            for t, row in self._cached()["tenants"].items()
        }

    def prom_starved_windows(self) -> dict:
        return {
            (("tenant", t),): float(row["starved_windows"])
            for t, row in self._cached()["tenants"].items()
        }

    def prom_burn(self) -> dict:
        fleet = self._cached()["fleet"]
        return {
            (("window", "fast"),): fleet.get("burn_fast", 0.0),
            (("window", "slow"),): fleet.get("burn_slow", 0.0),
        }

    def prom_preemption_rate(self) -> float:
        return self._cached()["fleet"].get("preemption_rate_per_min", 0.0)

    def prom_repair_rate(self) -> float:
        return self._cached()["fleet"].get("repair_rate_per_min", 0.0)

    def prom_goodput(self) -> float:
        got = self._cached()["fleet"].get("goodput")
        return got if got is not None else 0.0

    def prom_alerts_firing(self) -> float:
        return float(len(self._cached()["alerts"]))
