"""Bind plugin: posts the pod->node binding to the cluster backend — the
step the reference delegates to upstream default binding (SURVEY.md §3.2
[bind] row) — hardened for partial failure:

- **Transient-error retry.** A bind that fails with a retryable error
  (409 conflict, 429 throttle, 5xx, socket timeout — cluster.retry
  classification, ``__cause__`` chains included) is retried with bounded
  jittered exponential backoff before it is reported as a scheduling
  failure. The reference turned any transient API blip into a permanent
  "unschedulable"; here only genuine infeasibility (e.g. the pod is
  already bound elsewhere and stays that way) survives the retries.
- **Interruptible backoff.** With ``stop_event`` wired (the bind
  executor's event), retry sleeps wait on the event instead of
  ``time.sleep``: shutdown and leadership loss abort a pending retry
  immediately instead of draining up to ``retry_cap_s`` per attempt.
- **Worker-side fencing.** With ``fenced_fn`` wired (the scheduler's
  fence), leadership is re-checked immediately before EVERY API write —
  each first attempt and each retry. The scheduler's own fence check runs
  at resolution time; when binds fan out on the executor, the write can
  happen milliseconds later on a worker, and that window must not race a
  new leader's binds.
- **Rollback.** ``unbind`` reverses a bind for the gang transactional
  rollback path (scheduler._do_permit_resolved): backends that can clear
  the binding do (FakeCluster.unbind_pod); against a real API server a
  bound pod cannot be un-bound, so KubeCluster's unbind deletes the pod
  and its controller recreates it — the standard gang remediation.

Counterpart of ``yoda_tpu/plugins/yoda/binder.py``, whole. The bind wall
time hook (``observe_wall_ms``) is wired by ``build_stack`` to
``yoda_bind_wall_ms``.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable

from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.cluster.retry import (
    BackoffPolicy,
    RetryAborted,
    call_with_retries,
    interruptible_sleep,
)
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import BindPlugin, Status

log = logging.getLogger("yoda_tpu_torch.binder")


class BindFenced(RuntimeError):
    """Raised by the pre-write fence check: this process is not leader, so
    the bind must not reach the API. Non-retryable by classification —
    retrying would just spin against the fence; the gang rolls back
    transactionally instead."""


class ClusterBinder(BindPlugin):
    name = "yoda-binder"

    def __init__(
        self,
        cluster,
        *,
        retry_attempts: int = 3,
        retry_base_s: float = 0.05,
        retry_cap_s: float = 1.0,
        rng: "random.Random | None" = None,
        sleep=time.sleep,
        stop_event: "threading.Event | None" = None,
    ) -> None:
        self.cluster = cluster  # anything with bind_pod(pod_key, node_name)
        self.policy = BackoffPolicy(
            attempts=max(retry_attempts, 0),
            base_s=retry_base_s,
            cap_s=retry_cap_s,
        )
        # Seedable for deterministic chaos replays; fresh entropy otherwise.
        self.rng = rng or random.Random()
        self.sleep = sleep
        # Interruptible backoff: when set (standalone wires the bind
        # executor's stop event), sleeps wait on it and abort on fire.
        self.stop_event = stop_event
        # Worker-side leader fencing: True return = fenced, abort before
        # the API write (standalone wires Scheduler._fenced).
        self.fenced_fn: Callable[[], bool] | None = None
        self.on_fenced: Callable[[], None] | None = None  # metrics hook
        # Per-bind wall time (retries + backoff included), in ms — feeds
        # yoda_bind_wall_ms (standalone wires the histogram).
        self.observe_wall_ms: Callable[[float], None] | None = None
        self.retries = 0   # feeds yoda_recovery_bind_retries_total
        self.unbinds = 0   # feeds yoda_recovery_unbinds_total
        self.fenced = 0    # worker-side fence aborts (pre-write)
        self.aborted = 0   # retries abandoned by the stop event

    def _backoff_sleep(self, delay_s: float) -> None:
        if self.stop_event is not None:
            interruptible_sleep(self.stop_event)(delay_s)
            return
        self.sleep(delay_s)

    def bind(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        def on_retry(attempt: int, e: BaseException) -> None:
            self.retries += 1
            log.warning(
                "bind %s -> %s failed transiently (attempt %d: %s); "
                "retrying with backoff", pod.key, node_name, attempt + 1, e,
            )

        def attempt() -> None:
            # Re-checked before EVERY write, retries included: the fan-out
            # worker may reach this point well after the scheduler's own
            # resolution-time fence check passed.
            if self.stop_event is not None and self.stop_event.is_set():
                raise RetryAborted("scheduler stopping; bind abandoned")
            if self.fenced_fn is not None and self.fenced_fn():
                raise BindFenced(
                    f"scheduler fenced (not leader); bind of {pod.key} "
                    "aborted before the API write"
                )
            self.cluster.bind_pod(pod.key, node_name)

        t0 = time.monotonic()
        try:
            call_with_retries(
                attempt,
                policy=self.policy,
                rng=self.rng,
                sleep=self._backoff_sleep,
                on_retry=on_retry,
            )
        except BindFenced as e:
            self.fenced += 1
            if self.on_fenced is not None:
                self.on_fenced()
            return Status.unschedulable(str(e))
        except RetryAborted as e:
            self.aborted += 1
            return Status.error(f"binding {pod.key} to {node_name}: {e}")
        except Exception as e:  # retries exhausted or genuinely infeasible
            return Status.error(f"binding {pod.key} to {node_name}: {e}")
        finally:
            if self.observe_wall_ms is not None:
                self.observe_wall_ms((time.monotonic() - t0) * 1e3)
        return Status.ok()

    def unbind(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        """Reverse a bind (gang rollback). Best-effort with the same
        transient-retry policy; backends without any rollback surface
        report an error and the caller logs the stranded pod.

        Deliberately NOT fenced (the one exception to fence-before-
        write): these are rollbacks of THIS process's own landed binds,
        and an ex-leader that refuses to unwind them strands bound
        members and their chips until the new leader's resync — the
        pinned semantics are that a fence flip mid-release unwinds the
        landed half immediately (tests/test_chaos.py
        test_fence_flips_during_fanout). The write moves cluster state
        toward the pre-gang truth both leaders agree on, so it cannot
        race the new leader the way a forward bind can."""
        target = getattr(self.cluster, "unbind_pod", None)
        if target is None:
            # No unbind and no delete: nothing this backend can do.
            target = getattr(self.cluster, "delete_pod", None)
            if target is None:
                return Status.error(
                    f"backend cannot roll back binding of {pod.key}"
                )
            call = lambda: target(pod.key)  # noqa: E731
        else:
            call = lambda: target(pod.key, node_name)  # noqa: E731
        try:
            call_with_retries(
                call,
                policy=self.policy,
                rng=self.rng,
                sleep=self._backoff_sleep,
                on_retry=lambda a, e: log.warning(
                    "unbind %s from %s failed transiently (attempt %d: %s); "
                    "retrying", pod.key, node_name, a + 1, e,
                ),
            )
        except Exception as e:  # noqa: BLE001 — rollback must not raise
            return Status.error(f"unbinding {pod.key} from {node_name}: {e}")
        self.unbinds += 1
        return Status.ok()
