"""Lease-based leader election for scheduler HA.

The reference deploys with ``leaderElect: true`` and gets the whole
mechanism from the upstream kube-scheduler it wraps (reference
deploy/yoda-scheduler.yaml:11-14 via pkg/register/register.go:10); this is
the from-scratch equivalent on the modern ``coordination.k8s.io/v1`` Lease
API (the resourceVersion-checked update IS the mutual exclusion — the API
server rejects concurrent writes with 409, so at most one candidate's
acquire/renew round-trip wins per lease interval).

Semantics follow upstream leaderelection.LeaderElector:

- A candidate acquires the lease when it is absent, expired
  (``renewTime + leaseDurationSeconds < now``), or already its own.
- The holder renews every ``renew_period_s``; on failure it keeps acting as
  leader until ``renew_deadline_s`` since the last successful renew
  (transient API blips do not flap leadership), then reports loss. The
  deadline is strictly inside the lease duration, so the old leader always
  stands down BEFORE a standby may acquire (upstream renewDeadline
  semantics — no split-brain window).
- Observing ANOTHER holder's valid lease while leading reports loss
  immediately (the lock moved: split-brain window closed).
- ``release()`` clears the holder on orderly shutdown so a standby takes
  over without waiting out the lease (upstream ReleaseOnCancel).

Counterpart of ``yoda_tpu/cluster/lease.py``, whole.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Callable

log = logging.getLogger("yoda_tpu_torch.lease")

LEASE_API_BASE = "/apis/coordination.k8s.io/v1"


def lease_path(namespace: str, name: str = "") -> str:
    base = f"{LEASE_API_BASE}/namespaces/{namespace}/leases"
    return f"{base}/{name}" if name else base


def _fmt_micro(ts: float) -> str:
    return (
        datetime.fromtimestamp(ts, tz=timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")
        + "Z"
    )


def _parse_micro(s: str | None) -> float | None:
    if not s:
        return None
    for fmt in ("%Y-%m-%dT%H:%M:%S.%fZ", "%Y-%m-%dT%H:%M:%SZ"):
        try:
            return datetime.strptime(s, fmt).replace(tzinfo=timezone.utc).timestamp()
        except ValueError:
            continue
    return None


@dataclass
class LeaseView:
    holder: str
    renew_unix: float | None
    duration_s: float
    transitions: int
    resource_version: str
    acquire_time: str | None = None  # raw spec.acquireTime, carried on renew


class LeaderElector:
    """Drives acquire/renew against the Lease API. ``run`` blocks; callers
    put it on a thread and react to the callbacks (cli._run_scheduler)."""

    def __init__(
        self,
        api,  # KubeApiClient
        *,
        identity: str,
        namespace: str = "kube-system",
        name: str = "yoda-tpu-scheduler",
        lease_duration_s: float = 15.0,
        renew_deadline_s: float | None = None,
        renew_period_s: float = 2.0,
        clock: Callable[[], float] = time.time,
    ) -> None:
        if not identity:
            raise ValueError("leader election requires a non-empty identity")
        # Upstream leaderelection margins: the holder ABANDONS leadership
        # once it has failed to renew for renew_deadline_s — strictly less
        # than lease_duration_s, the point where standbys may acquire — so
        # even with a detection granularity of renew_period_s the old leader
        # stops scheduling before a new one can start (no split-brain
        # window). Default: 2/3 of the lease duration, like upstream's
        # 10s/15s.
        if renew_deadline_s is None:
            renew_deadline_s = lease_duration_s * 2.0 / 3.0
        if not (renew_period_s < renew_deadline_s < lease_duration_s):
            raise ValueError(
                f"need renew_period ({renew_period_s}) < renew_deadline "
                f"({renew_deadline_s}) < lease_duration ({lease_duration_s})"
            )
        if lease_duration_s - renew_deadline_s <= renew_period_s:
            raise ValueError(
                "lease_duration - renew_deadline must exceed renew_period "
                "(the loss-detection tick granularity), or a standby could "
                "acquire before the old leader notices it must stop"
            )
        self.api = api
        self.identity = identity
        self.namespace = namespace
        self.name = name
        self.lease_duration_s = lease_duration_s
        self.renew_deadline_s = renew_deadline_s
        self.renew_period_s = renew_period_s
        self.clock = clock
        self._leading = threading.Event()
        self._last_renew = 0.0

    # --- introspection ---

    def is_leader(self) -> bool:
        return self._leading.is_set()

    def observe(self) -> LeaseView | None:
        """Current lease state, None when absent (tests, metrics)."""
        from yoda_tpu_torch.cluster.kube import KubeApiError

        try:
            obj = self.api.request("GET", lease_path(self.namespace, self.name))
        except KubeApiError as e:
            if e.status == 404:
                return None
            raise
        spec = obj.get("spec", {})
        return LeaseView(
            holder=spec.get("holderIdentity") or "",
            renew_unix=_parse_micro(spec.get("renewTime")),
            duration_s=float(spec.get("leaseDurationSeconds") or 0),
            transitions=int(spec.get("leaseTransitions") or 0),
            resource_version=obj.get("metadata", {}).get("resourceVersion", ""),
            acquire_time=spec.get("acquireTime"),
        )

    # --- acquire / renew ---

    def _lease_body(
        self,
        *,
        acquire: bool,
        transitions: int,
        rv: str,
        acquire_time: str | None = None,
    ) -> dict:
        now = _fmt_micro(self.clock())
        body = {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": {
                "holderIdentity": self.identity,
                "leaseDurationSeconds": int(self.lease_duration_s),
                "renewTime": now,
                "leaseTransitions": transitions,
            },
        }
        if acquire:
            body["spec"]["acquireTime"] = now
        elif acquire_time:
            # PUT replaces the whole spec on a real API server: carry the
            # acquireTime recorded at acquisition through every renewal.
            body["spec"]["acquireTime"] = acquire_time
        if rv:
            body["metadata"]["resourceVersion"] = rv
        return body

    def try_acquire_or_renew(self) -> bool:
        """One round: True when this identity holds the lease afterwards.
        Raises nothing — API errors count as a failed round (the run loop's
        expiry deadline decides when that costs leadership)."""
        from yoda_tpu_torch.cluster.kube import KubeApiError

        try:
            view = self.observe()
            if view is None:
                self.api.request(
                    "POST",
                    lease_path(self.namespace),
                    body=self._lease_body(acquire=True, transitions=0, rv=""),
                )
                self._last_renew = self.clock()
                return True
            if view.holder == self.identity:
                body = self._lease_body(
                    acquire=False,
                    transitions=view.transitions,
                    rv=view.resource_version,
                    acquire_time=view.acquire_time,
                )
                self.api.request(
                    "PUT", lease_path(self.namespace, self.name), body=body
                )
                self._last_renew = self.clock()
                return True
            released = not view.holder  # orderly release(): free immediately
            expired = (
                view.renew_unix is None
                or view.renew_unix + view.duration_s <= self.clock()
            )
            if not released and not expired:
                return False
            body = self._lease_body(
                acquire=True,
                transitions=view.transitions + 1,
                rv=view.resource_version,
            )
            self.api.request("PUT", lease_path(self.namespace, self.name), body=body)
            self._last_renew = self.clock()
            return True
        except (KubeApiError, OSError):
            # 409 = lost the write race; others = API blip. Either way this
            # round did not secure the lease.
            return False

    def release(self) -> None:
        """Clear the holder so a standby can take over immediately."""
        from yoda_tpu_torch.cluster.kube import KubeApiError

        try:
            view = self.observe()
            if view is None or view.holder != self.identity:
                return
            body = self._lease_body(
                acquire=False,
                transitions=view.transitions,
                rv=view.resource_version,
                acquire_time=view.acquire_time,
            )
            body["spec"]["holderIdentity"] = ""
            self.api.request("PUT", lease_path(self.namespace, self.name), body=body)
        except (KubeApiError, OSError):
            pass  # best-effort; the lease expires on its own
        finally:
            self._leading.clear()

    # --- the loop ---

    def run(
        self,
        stop: threading.Event,
        *,
        on_started_leading: Callable[[], None] | None = None,
        on_stopped_leading: Callable[[], None] | None = None,
    ) -> None:
        """Blocks until ``stop``. Fires ``on_started_leading`` when acquired
        and ``on_stopped_leading`` when leadership is lost (expired without
        renewal, or another holder observed). Releases on orderly exit."""
        try:
            while not stop.is_set():
                got = self.try_acquire_or_renew()
                if got and not self._leading.is_set():
                    log.info("acquired lease %s/%s as %s",
                             self.namespace, self.name, self.identity)
                    self._leading.set()
                    if on_started_leading:
                        on_started_leading()
                elif not got and self._leading.is_set():
                    view = None
                    try:
                        view = self.observe()
                    except Exception:
                        pass
                    taken_over = view is not None and view.holder not in (
                        "",
                        self.identity,
                    )
                    deadline_passed = (
                        self.clock() - self._last_renew >= self.renew_deadline_s
                    )
                    if taken_over or deadline_passed:
                        log.warning(
                            "lost leadership of %s/%s (%s)",
                            self.namespace, self.name,
                            "taken over by " + view.holder if taken_over
                            else "renew deadline passed",
                        )
                        self._leading.clear()
                        if on_stopped_leading:
                            on_stopped_leading()
                stop.wait(self.renew_period_s)
        finally:
            if self._leading.is_set():
                self.release()
