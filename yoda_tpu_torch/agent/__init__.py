"""The fake TPU node agent (counterpart of yoda_tpu/agent): ``FakeTpuAgent``
publishes synthetic TpuNodeMetrics CRs for tests and the chip smoke run."""

from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent

__all__ = ["FakeTpuAgent"]
