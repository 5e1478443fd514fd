"""Bind plugin: posts the pod->node binding to the cluster backend — the
step the reference delegates to upstream default binding (SURVEY.md §3.2
[bind] row) — with transient-error retry: a bind that fails with a
retryable error (409 conflict, 429 throttle, 5xx, socket timeout —
cluster.retry classification, ``__cause__`` chains included) is retried
with bounded jittered exponential backoff before it is reported as a
scheduling failure.

Counterpart of ``yoda_tpu/plugins/yoda/binder.py``, ported as far as the
singleton and gang paths reach it, ``unbind`` (the gang rollback)
included, and the bind wall-time hook (``observe_wall_ms``, which
``build_stack`` wires to ``yoda_bind_wall_ms``). Left out until a later
slice: worker-side leader fencing and the interruptible (stop-event)
backoff of the bind executor.
"""

from __future__ import annotations

import logging
import random
import time

from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.cluster.retry import BackoffPolicy, call_with_retries
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import BindPlugin, Status

log = logging.getLogger("yoda_tpu_torch.binder")


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
    ) -> None:
        self.cluster = cluster  # anything with bind_pod(pod_key, node_name)
        self.policy = BackoffPolicy(
            attempts=max(retry_attempts, 0),
            base_s=retry_base_s,
            cap_s=retry_cap_s,
        )
        # Seedable for deterministic replays; fresh entropy otherwise.
        self.rng = rng or random.Random()
        self.sleep = sleep
        # Per-bind wall time (retries + backoff included), in ms — feeds
        # yoda_bind_wall_ms (build_stack wires the histogram).
        self.observe_wall_ms = None
        self.retries = 0
        self.unbinds = 0

    def bind(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        def on_retry(attempt: int, e: BaseException) -> None:
            self.retries += 1
            log.warning(
                "bind %s -> %s failed transiently (attempt %d: %s); "
                "retrying with backoff", pod.key, node_name, attempt + 1, e,
            )

        t0 = time.monotonic()
        try:
            call_with_retries(
                lambda: self.cluster.bind_pod(pod.key, node_name),
                policy=self.policy,
                rng=self.rng,
                sleep=self.sleep,
                on_retry=on_retry,
            )
        except Exception as e:  # retries exhausted or genuinely infeasible
            return Status.error(f"binding {pod.key} to {node_name}: {e}")
        finally:
            if self.observe_wall_ms is not None:
                self.observe_wall_ms((time.monotonic() - t0) * 1e3)
        return Status.ok()

    def unbind(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        """Reverse a bind (gang rollback). Best-effort with the same
        transient-retry policy; backends without any rollback surface
        report an error and the caller logs the stranded pod."""
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
                sleep=self.sleep,
                on_retry=lambda a, e: log.warning(
                    "unbind %s from %s failed transiently (attempt %d: %s); "
                    "retrying", pod.key, node_name, a + 1, e,
                ),
            )
        except Exception as e:  # noqa: BLE001 — rollback must not raise
            return Status.error(f"unbinding {pod.key} from {node_name}: {e}")
        self.unbinds += 1
        return Status.ok()
