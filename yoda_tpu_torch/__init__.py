"""yoda-tpu on PyTorch and CUDA: the port of ``yoda_tpu`` to one NVIDIA H100.

The same ``tpu/*`` label API, ``SchedulerConfig`` knobs and scheduling
decisions as the JAX package beside it, with the fleet evaluation running
in a hand-written CUDA kernel (``ops/cuda_kernel.py``,
``csrc/fleet_eval.cu``) on the card, or in its plain PyTorch version
(``ops/kernel.py``) when the caller asks for the CPU. The port keeps the
reference's module layout (``yoda_tpu_torch/X`` is the counterpart of
``yoda_tpu/X``) and imports nothing of ``yoda_tpu`` or JAX.

This slice ports the singleton path: ``standalone.build_stack`` with
``mode="batch"``, ``agent.fake_publisher.FakeTpuAgent`` and
``cluster.fake.FakeCluster``. Each module's docstring names what it
leaves out; ROADMAP.md lists the modules still to port.
"""

__version__ = "0.1.0"
