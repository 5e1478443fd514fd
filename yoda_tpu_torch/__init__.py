"""yoda-tpu on PyTorch and CUDA: the port of ``yoda_tpu`` to one NVIDIA H100.

The same ``tpu/*`` label API, ``SchedulerConfig`` knobs and scheduling
decisions as the JAX package beside it, with the fleet evaluation and the
gang path's joint fit scan running in hand-written CUDA kernels
(``ops/cuda_kernel.py``, ``csrc/fleet_eval.cu``, ``csrc/joint_fit.cu``) on
the card, or in their plain PyTorch versions (``ops/kernel.py``) when the
caller asks for the CPU. The port keeps the reference's module layout
(``yoda_tpu_torch/X`` is the counterpart of ``yoda_tpu/X``) and imports
nothing of ``yoda_tpu`` or JAX.

The port runs the singleton and gang paths, preemption, inter-pod
affinity, spread, volumes and budgets, and the background path (the
speculative placement cache, the rebalancer and the reconciler):
``standalone.build_stack``, ``agent.fake_publisher.FakeTpuAgent`` and
``cluster.fake.FakeCluster``.
Each module's docstring names what it leaves out; ROADMAP.md lists the
modules still to port.
"""

__version__ = "0.1.0"
