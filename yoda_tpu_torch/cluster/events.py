"""Kubernetes Event emission: the `kubectl describe pod` trail.

A cluster running the upstream kube-scheduler gets scheduling Events from
the framework's EventRecorder (Scheduled / FailedScheduling); this
from-scratch loop must emit its own. The recorder follows the upstream
aggregation discipline: one Event object per (involved pod UID, reason),
POSTed on first occurrence and updated with an incremented ``count`` and
refreshed ``lastTimestamp`` on repeats — so a pod retried 50 times shows
one FailedScheduling row with count=50, not 50 objects.

Reasons emitted (upstream-parity names):

- ``Scheduled`` (Normal) — pod bound to a node,
- ``FailedScheduling`` (Warning) — no feasible node this attempt,
- ``Preempted`` (Warning) — on the victim, when preemption evicts it,
- ``GangRollback`` (Warning) — on every member of a gang that rolled back,
  naming the member and the reason that took it down.

Counterpart of ``yoda_tpu/cluster/events.py``, whole. The sink is the
cluster's ``write_event`` (``FakeCluster`` here; the real API server's
client waits for the kube backend).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable

from yoda_tpu_torch.api.types import PodSpec

log = logging.getLogger("yoda_tpu_torch.events")

# Bounded memory: beyond this many distinct (uid, reason) keys the oldest
# aggregation entry is dropped (its next event just POSTs a fresh object).
_MAX_TRACKED = 4096

# Bounded backlog of unsent events; overflow sheds the OLDEST (best-effort,
# like upstream's broadcaster) — in a mass-failure storm the newest events
# describe the storm's current phase and must survive.
_MAX_PENDING = 1024


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts))


class EventRecorder:
    """Builds and aggregates k8s Event objects, handing them to ``sink``.

    ``sink(obj, update)`` persists the Event: ``update=False`` means create
    (POST), ``update=True`` means rewrite the same named object (PUT) — the
    count-aggregation path. Both cluster backends implement this as
    ``write_event``.

    The sink runs on a dedicated worker thread (upstream keeps event
    emission off the scheduling path via an async broadcaster for the same
    reason: with a real API server every write is a blocking HTTP round
    trip, and the scheduling loop must not pay it). Enqueueing happens
    inside the aggregation lock, so sink calls for one (pod, reason) are
    strictly ordered — a later count can never be overwritten by an earlier
    one. Sink failures are logged and swallowed: events are best-effort
    observability, never scheduling-path errors. Call :meth:`flush` to wait
    for the backlog (tests, shutdown).
    """

    def __init__(
        self,
        sink: Callable[[dict, bool], None],
        *,
        component: str = "yoda-tpu-scheduler",
        clock: Callable[[], float] = time.time,
        on_drop: Callable[[], None] | None = None,
        max_tracked: int = _MAX_TRACKED,
        max_pending: int = _MAX_PENDING,
    ) -> None:
        self.sink = sink
        self.component = component
        self.clock = clock
        self.on_drop = on_drop
        self.max_tracked = max_tracked
        self.dropped_total = 0  # backlog sheds; mirrored to on_drop per event
        self._lock = threading.Lock()
        self._closing = False
        # (uid, reason) -> (event name, count, firstTimestamp); LRU-ordered:
        # every _emit reinserts its key, so capacity eviction removes the
        # least-recently-AGGREGATING entry, not the oldest-created.
        self._seen: dict[tuple[str, str], tuple[str, int, float]] = {}
        self._pending: queue.Queue = queue.Queue(maxsize=max_pending)
        self._worker = threading.Thread(
            target=self._drain, daemon=True, name="yoda-events"
        )
        self._worker.start()

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until all enqueued events reached the sink (True) or the
        timeout passed (False)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._pending.unfinished_tasks == 0:
                return True
            time.sleep(0.005)
        return False

    def close(self, timeout_s: float = 5.0) -> None:
        """Flush the backlog and stop the worker thread. Events emitted
        after close() are aggregated but never sent. Bounded: if the
        backlog is wedged (sink blocked on an unreachable API server) the
        sentinel is skipped and the daemon worker dies with the process —
        close() must never hold a SIGTERM handler past its timeout."""
        self.flush(timeout_s)
        # Under the lock: _emit's shed-oldest loop also runs under it, so a
        # concurrent emit can never dequeue this stop sentinel.
        with self._lock:
            self._closing = True
            try:
                self._pending.put_nowait(None)
            except queue.Full:
                return
        self._worker.join(timeout=timeout_s)

    def _drain(self) -> None:
        while True:
            item = self._pending.get()
            if item is None:
                self._pending.task_done()
                return
            obj, update = item
            try:
                self.sink(obj, update)
            except Exception:  # noqa: BLE001 — best-effort, see docstring
                log.warning(
                    "failed to write event %s/%s",
                    obj["metadata"].get("namespace"),
                    obj["metadata"].get("name"),
                    exc_info=True,
                )
            finally:
                self._pending.task_done()

    # --- the public reasons ---

    def scheduled(self, pod: PodSpec, node_name: str) -> None:
        self._emit(
            pod,
            "Normal",
            "Scheduled",
            f"Successfully assigned {pod.key} to {node_name}",
        )

    def failed_scheduling(self, pod: PodSpec, message: str) -> None:
        self._emit(pod, "Warning", "FailedScheduling", message)

    def preempted(self, victim: PodSpec, node: str) -> None:
        self._emit(
            victim,
            "Warning",
            "Preempted",
            f"Preempted by {self.component} on node {node} to make room for "
            "a higher-priority TPU workload",
        )

    def gang_rollback(self, member: PodSpec, gang: str, why: str) -> None:
        """The gang-level reason a member bounced: each member's `kubectl
        describe pod` shows WHY the whole gang rolled back (the triggering
        member/host), not just its own FailedScheduling row."""
        self._emit(member, "Warning", "GangRollback", f"gang {gang}: {why}")

    # --- watch: prune aggregation state for deleted pods ---

    def handle(self, event) -> None:
        """Cluster watch hook (standalone wires it): a deleted pod's
        (uid, reason) entries can never aggregate again — drop them so idle
        entries for dead pods cannot crowd a live long-pending pod out of
        the LRU."""
        if getattr(event, "kind", None) != "Pod" or event.type != "deleted":
            return
        uid = event.obj.uid
        with self._lock:
            for key in [k for k in self._seen if k[0] == uid]:
                del self._seen[key]

    # --- mechanics ---

    def _emit(self, pod: PodSpec, etype: str, reason: str, message: str) -> None:
        now = self.clock()
        key = (pod.uid, reason)
        with self._lock:
            # pop + reinsert: a repeat refreshes the key's LRU position, so
            # an actively-aggregating pod is never evicted by idle entries.
            prior = self._seen.pop(key, None)
            if prior is None:
                # Unique, deterministic-enough name: upstream uses
                # <pod>.<hex timestamp>; collisions just surface as a 409
                # the sink's create-then-update handles.
                name = f"{pod.name}.{format(int(now * 1e6), 'x')}"
                entry = (name, 1, now)
            else:
                entry = (prior[0], prior[1] + 1, prior[2])
            if len(self._seen) >= self.max_tracked:
                self._seen.pop(next(iter(self._seen)))
            self._seen[key] = entry
            name, count, first = entry
            obj = self._build(pod, etype, reason, message, name, count, first, now)
            # Inside the lock: enqueue order == aggregation order, so the
            # worker can never persist counts out of order. On overflow,
            # shed the OLDEST pending event — the newest describe the
            # current phase of whatever storm is causing the backlog.
            while not self._closing:
                try:
                    self._pending.put_nowait((obj, count > 1))
                    break
                except queue.Full:
                    try:
                        shed, _ = self._pending.get_nowait()
                        self._pending.task_done()
                    except queue.Empty:
                        # Worker drained everything between our put and get:
                        # the next put attempt will succeed.
                        continue
                    self.dropped_total += 1
                    if self.on_drop is not None:
                        try:
                            self.on_drop()
                        except Exception:  # noqa: BLE001 — metrics best-effort
                            pass
                    log.warning(
                        "event backlog full; shed oldest %s/%s",
                        shed["metadata"].get("namespace"),
                        shed["metadata"].get("name"),
                    )

    def _build(
        self,
        pod: PodSpec,
        etype: str,
        reason: str,
        message: str,
        name: str,
        count: int,
        first: float,
        now: float,
    ) -> dict:
        return {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": name, "namespace": pod.namespace},
            "involvedObject": {
                "apiVersion": "v1",
                "kind": "Pod",
                "namespace": pod.namespace,
                "name": pod.name,
                "uid": pod.uid,
            },
            "reason": reason,
            "message": message,
            "type": etype,
            "source": {"component": self.component},
            "firstTimestamp": _iso(first),
            "lastTimestamp": _iso(now),
            "count": count,
        }
