"""Per-cluster health: the ``UP -> DEGRADED -> PARTITIONED -> LOST`` ladder.

One monitor per cluster front. Health is SILENCE-driven: "contact" is any
proof the cluster front is alive — a successful probe round-trip, or a
watch event reaching the informer (the staleness clock,
``InformerCache.last_event_age_s``). The state is a function of how long
both signals have been silent:

    silence < degraded_after_s      UP          full member of placement
    silence < partitioned_after_s   DEGRADED    serves locally, but no
                                                NEW spillover routed to it
    silence < lost_after_s          PARTITIONED fenced: no bind may hit its
                                                API; its resync gate closes
    silence >= lost_after_s         LOST        as PARTITIONED, and /readyz
                                                stops waiting for it

Probe failures are classified with the SAME rules the bind retrier uses
(``cluster.retry.retryable_api_error``): a transient/transport failure
(timeout, connection refused, 5xx) is connectivity loss — silence keeps
accumulating toward PARTITIONED/LOST. A NON-retryable API error means the
server answered (reachable, so the silence clock resets) but is broken in
a way retrying won't fix — that pins the cluster at DEGRADED until a probe
succeeds cleanly.

Ticks and state reads are lock-cheap and never do I/O; ``probe()`` does
one round-trip and is only ever called from the federation's background
thread — health evaluation must never ride the serve loop.

Counterpart of ``yoda_tpu/federation/health.py``, whole.
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from typing import Callable

from yoda_tpu_torch.cluster.retry import retryable_api_error

log = logging.getLogger("yoda_tpu_torch.federation")


class ClusterState(enum.Enum):
    UP = "up"
    DEGRADED = "degraded"
    PARTITIONED = "partitioned"
    LOST = "lost"

    @property
    def severity(self) -> int:
        """Gauge encoding (yoda_cluster_state): 0=up 1=degraded
        2=partitioned 3=lost."""
        return _SEVERITY[self]

    @property
    def serving(self) -> bool:
        """May this cluster's own scheduler bind right now? DEGRADED still
        serves locally (the API answers — it is only excluded as a NEW
        spillover target); PARTITIONED/LOST are fenced."""
        return self in (ClusterState.UP, ClusterState.DEGRADED)


_SEVERITY = {
    ClusterState.UP: 0,
    ClusterState.DEGRADED: 1,
    ClusterState.PARTITIONED: 2,
    ClusterState.LOST: 3,
}


class ClusterHealthMonitor:
    """The health ladder for one cluster front.

    ``probe_fn`` does one cheap round-trip against the cluster's API and
    raises on failure (``KubeCluster.probe`` / ``FakeCluster.probe``);
    ``staleness_fn`` returns the watch-stream event age in seconds or None
    (``InformerCache.last_event_age_s``). ``on_transition(old, new)``
    fires under no lock whenever the state changes.
    """

    def __init__(
        self,
        name: str,
        *,
        probe_fn: "Callable[[], object] | None" = None,
        staleness_fn: "Callable[[], float | None] | None" = None,
        degraded_after_s: float = 10.0,
        partitioned_after_s: float = 30.0,
        lost_after_s: float = 120.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: "Callable[[ClusterState, ClusterState], None] | None" = None,
    ) -> None:
        if not 0 < degraded_after_s <= partitioned_after_s <= lost_after_s:
            raise ValueError(
                "health thresholds must satisfy 0 < degraded <= "
                f"partitioned <= lost, got {degraded_after_s}/"
                f"{partitioned_after_s}/{lost_after_s}"
            )
        self.name = name
        self.probe_fn = probe_fn
        self.staleness_fn = staleness_fn
        self.degraded_after_s = degraded_after_s
        self.partitioned_after_s = partitioned_after_s
        self.lost_after_s = lost_after_s
        self.clock = clock
        self.on_transition = on_transition
        self.transitions = 0
        self._lock = threading.Lock()
        self._state = ClusterState.UP
        # Optimistic start: a freshly-built member gets the full degraded
        # window to prove itself before it is fenced out of anything.
        self._last_contact = clock()
        # Set by a NON-retryable probe error (server reachable but
        # broken): pins DEGRADED; cleared by the next clean probe.
        self._api_error = False

    # --- readers ---

    @property
    def state(self) -> ClusterState:
        with self._lock:
            return self._state

    def silence_s(self) -> float:
        """Seconds since the last proof of life, taking the FRESHER of
        probe contact and watch-event arrival (a healthy-but-quiet
        cluster stays UP on probes alone; a chatty watch keeps a cluster
        UP between probes)."""
        now = self.clock()
        with self._lock:
            silence = now - self._last_contact
        if self.staleness_fn is not None:
            age = self.staleness_fn()
            if age is not None:
                silence = min(silence, age)
        return max(silence, 0.0)

    # --- probe and tick ---

    def probe(self) -> ClusterState:
        """One probe round-trip, then a tick. Runs I/O — background thread
        only, never the serve loop."""
        if self.probe_fn is not None:
            try:
                self.probe_fn()
            except Exception as e:  # noqa: BLE001 — classification decides
                if retryable_api_error(e):
                    # Transient/transport failure: connectivity loss — no
                    # contact recorded, silence accumulates toward
                    # PARTITIONED/LOST.
                    log.debug(
                        "cluster %s: probe failed transiently (%s: %s)",
                        self.name, type(e).__name__, e,
                    )
                else:
                    # The server ANSWERED with a non-retryable error:
                    # reachable but broken. Contact resets the partition
                    # clock; the error pins DEGRADED.
                    with self._lock:
                        self._last_contact = self.clock()
                        self._api_error = True
                    log.warning(
                        "cluster %s: probe answered with a non-retryable "
                        "error (%s: %s); pinning DEGRADED", self.name,
                        type(e).__name__, e,
                    )
            else:
                with self._lock:
                    self._last_contact = self.clock()
                    self._api_error = False
        return self.tick()

    def record_contact(self) -> None:
        """External proof of life (e.g. a successful API write observed by
        the caller) — equivalent to a clean probe, without the round-trip."""
        with self._lock:
            self._last_contact = self.clock()
            self._api_error = False

    def tick(self) -> ClusterState:
        """Re-evaluate the ladder from current silence; fire
        ``on_transition`` if the state changed. Lock-cheap, no I/O."""
        silence = self.silence_s()
        with self._lock:
            if silence >= self.lost_after_s:
                new = ClusterState.LOST
            elif silence >= self.partitioned_after_s:
                new = ClusterState.PARTITIONED
            elif silence >= self.degraded_after_s or self._api_error:
                new = ClusterState.DEGRADED
            else:
                new = ClusterState.UP
            old, self._state = self._state, new
            if new is not old:
                self.transitions += 1
        if new is not old:
            log.warning(
                "cluster %s: health %s -> %s (%.1fs silent)",
                self.name, old.value, new.value, silence,
            )
            cb = self.on_transition
            if cb is not None:
                cb(old, new)
        return new
