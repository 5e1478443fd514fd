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
affinity, spread, volumes and budgets, the background path (the
speculative placement cache, the rebalancer and the reconciler), the node
health monitor, observability (the metrics registry, lifecycle tracing
and why-pending, the SLO engine, the overload ladder and the metrics
endpoint), and every way the reference evaluates a pod: the fused
evaluation on one card, row-sharded over several (``parallel/``, the
shard entry of ``csrc/fleet_eval.cu``), or loop mode's per-node plugins
on the host; and the durable claim journal (``journal/``), scheduler
lanes in one process (``standalone.build_sharded_stacks``, every lane
evaluating its partition on the card on a stream of its own) or as worker
processes (``standalone.build_proc_parent`` and
``framework/procserve.py``, each worker on the card in a CUDA context of
its own, behind the commit RPC; ``journal/tail.py``'s tailing standby)
and profiles (``standalone.build_profile_stacks``): ``standalone.build_stack``,
``agent.FakeTpuAgent``, ``cluster.fake.FakeCluster`` and
``metrics_server.MetricsServer``.
Each module's docstring names what it leaves out; ROADMAP.md lists the
modules still to port.
"""

__version__ = "0.1.0"
