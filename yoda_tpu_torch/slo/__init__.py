"""Fleet SLO engine (counterpart of yoda_tpu/slo): sliding-window SLIs
and declarative targets. See yoda_tpu_torch/slo/engine.py."""

from yoda_tpu_torch.slo.engine import SloEngine, SloTargets

__all__ = ["SloEngine", "SloTargets"]
