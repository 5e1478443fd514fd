"""Declarative SLO targets: the part of the SLO engine the config needs.

Counterpart of ``yoda_tpu/slo/engine.py``. ``SchedulerConfig`` carries a
``slo_targets`` knob, so the port keeps its own copy of ``SloTargets`` to
load and validate it. The SLI engine itself (``SloEngine``) waits for the
port of the observability layer.
"""

from __future__ import annotations

from dataclasses import dataclass, fields


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
