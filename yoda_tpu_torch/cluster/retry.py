"""Transient-error classification and jittered-backoff retry.

The reference plugin turns EVERY framework-hook failure into a permanent
pod failure; production API servers throw transient errors constantly —
keep-alive races, 409 write conflicts, 429 throttles, rolling-restart 5xx
— and retrying those with bounded jittered backoff is the difference
between a blip and an unschedulable pod. This module owns the policy so
the binder, the permit-release path, and the chaos tests all agree on
what "transient" means:

- ``retryable_api_error``: classifies an exception (``__cause__`` chains
  included — ``KubeCluster.bind_pod`` wraps ``KubeApiError`` in
  ``ValueError``). Duck-typed on ``.status`` so the chaos harness's
  injected errors classify without importing kube internals.
- ``BackoffPolicy`` + ``call_with_retries``: bounded attempts, exponential
  delay with full jitter from a SEEDED rng (deterministic under the chaos
  harness — the same plan replays the same retry schedule).

Genuine infeasibility (a 404 pod, a plain "already bound elsewhere"
ValueError, a label parse error) is never retried: retry only buys time
against errors where time helps.

Backoff sleeps are interruptible: ``interruptible_sleep(stop)`` builds a
sleeper that waits on a ``threading.Event`` instead of ``time.sleep``, and
raises ``RetryAborted`` the moment the event fires — so shutdown or
leadership loss aborts a pending retry immediately instead of draining up
to ``cap_s`` per attempt on the scheduling thread.

Counterpart of ``yoda_tpu/cluster/retry.py``, whole.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable

# HTTP statuses worth retrying: 409 write conflicts (optimistic-concurrency
# losers and bind races that a fresh read resolves), 429 API throttling,
# and server-side 5xx. 4xx otherwise means the request itself is wrong.
RETRYABLE_STATUSES = frozenset({409, 429, 500, 502, 503, 504})


def retryable_api_error(exc: BaseException) -> bool:
    """True when retrying the SAME call can plausibly succeed. Walks the
    ``__cause__`` chain so wrapped errors classify by their root."""
    seen = 0
    e: BaseException | None = exc
    while e is not None and seen < 8:  # bounded: defensive vs cause cycles
        status = getattr(e, "status", None)
        if isinstance(status, int) and status in RETRYABLE_STATUSES:
            return True
        if isinstance(e, (TimeoutError, ConnectionError)):
            return True
        if isinstance(e, OSError):
            return True  # socket-level failures: the transport, not the verb
        e = e.__cause__
        seen += 1
    return False


class RetryAborted(RuntimeError):
    """A retry backoff sleep was interrupted (stop event fired): the call
    is abandoned immediately. Never retryable by classification — no
    ``status``, not an OSError — so it propagates out of
    ``call_with_retries`` unchanged."""


def interruptible_sleep(stop: "threading.Event") -> Callable[[float], None]:
    """A ``sleep`` drop-in for ``call_with_retries`` that waits on
    ``stop``: the full delay passes when the event stays clear; the event
    firing raises ``RetryAborted`` at once (shutdown / leadership loss
    must not be delayed by up to ``cap_s`` per pending attempt)."""

    def _sleep(delay_s: float) -> None:
        if stop.wait(delay_s):
            raise RetryAborted("stop requested during retry backoff")

    return _sleep


@dataclass(frozen=True)
class BackoffPolicy:
    """Bounded retry with full-jitter exponential backoff (attempt k sleeps
    uniform(0, min(base * 2**k, cap)) — the AWS full-jitter shape, which
    desynchronizes contending retriers better than equal-jitter)."""

    attempts: int = 3          # retries AFTER the first try (0 = no retry)
    base_s: float = 0.05
    cap_s: float = 1.0

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        return rng.uniform(0.0, min(self.base_s * (2 ** attempt), self.cap_s))


def call_with_retries(
    fn: Callable[[], object],
    *,
    policy: BackoffPolicy,
    rng: random.Random | None = None,
    sleep: Callable[[float], None] = time.sleep,
    classify: Callable[[BaseException], bool] = retryable_api_error,
    on_retry: Callable[[int, BaseException], None] | None = None,
):
    """Run ``fn``, retrying transient failures per ``policy``. Non-retryable
    errors and the final exhausted attempt propagate unchanged."""
    rng = rng or random.Random()
    for attempt in range(policy.attempts + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classification decides
            if attempt >= policy.attempts or not classify(e):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(policy.delay_s(attempt, rng))
    raise AssertionError("unreachable")
