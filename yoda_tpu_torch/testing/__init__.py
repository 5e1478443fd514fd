"""Test infrastructure shipped with the framework.

The reference has no tests and its multi-node behavior is exercised only in
production (SURVEY.md §4). Here the e2e story is explicit: a real in-process
HTTP server speaking the subset of the Kubernetes API the scheduler uses
(`FakeKubeApiServer`), so the full KubeCluster list/watch/bind path is
driven without a cluster — the single-process analog of the "kind cluster +
fake TPU metrics DaemonSet" harness.

Counterpart of ``yoda_tpu/testing``, whole: ``FakeKubeApiServer`` and
``wait_until``, on the standard library only, and the modules
``chaos`` (the fault-injection harness), ``tracegen`` (seeded traces
and their replay through a whole stack) and ``fake_libtpu`` (the libtpu
runtime-metrics gRPC service the native agent's ``--libtpu-metrics``
overlay reads).
"""

import time

from yoda_tpu_torch.testing.fake_kube_api import FakeKubeApiServer

__all__ = ["FakeKubeApiServer", "wait_until"]


def wait_until(
    cond,
    timeout_s: float = 10.0,
    msg: str = "condition",
    poll_s: float = 0.02,
) -> None:
    """Poll ``cond`` until truthy or raise after ``timeout_s`` — the one
    synchronization helper for tests driving the asynchronous watch paths."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(poll_s)
    raise AssertionError(f"timed out waiting for {msg}")
