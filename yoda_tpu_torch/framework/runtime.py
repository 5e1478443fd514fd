"""Framework runtime: drives plugins through the extension points and owns
the Permit waitlist.

Semantics follow the modern upstream framework runtime:
- Filter: every FilterPlugin must succeed for a node to be feasible.
- Score: each ScorePlugin's raw scores are normalized by its ``normalize``
  then summed across plugins.
- Reserve: runs in plugin order; on failure, already-reserved plugins are
  unreserved in reverse order.
- Permit: any WAIT parks the pod on the waitlist; approval requires every
  waiting plugin to allow; rejection or timeout unreserves.

The batch fast path (``BatchFilterScorePlugin``) replaces the per-node
filter/score loops with one fused computation.

Counterpart of ``yoda_tpu/framework/runtime.py``, ported as far as the
singleton, gang and preemption paths reach it: the Permit waitlist
(``WaitingPod``, expiry and cancellation), the gang-fused and joint
pre-evaluation hooks, PostFilter (``run_post_filter``) and unbind, and the
bind executor (``BindExecutor`` over ``_DaemonPool``), which the node
health monitor and the rebalancer fan their unbinds out on. Left out until
a later slice: the per-node filter loop (loop mode), the bind pipeline
that would put the scheduler's own binds on the executor (so every bind of
a scheduling cycle runs inline on the scheduling thread) with the
executor's completion bookkeeping, and bind tracing.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Mapping, Sequence

from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import (
    BatchFilterScorePlugin,
    BindPlugin,
    Code,
    FilterPlugin,
    PermitPlugin,
    Plugin,
    PostFilterPlugin,
    PreFilterPlugin,
    PreScorePlugin,
    QueueSortPlugin,
    ReservePlugin,
    ScorePlugin,
    Snapshot,
    Status,
)

log = logging.getLogger("yoda_tpu_torch.framework")


class WaitingPod:
    """A pod parked at Permit (gang members wait here until the gang is
    complete). Thread-safe; resolution fires ``on_resolved`` exactly once."""

    def __init__(
        self,
        pod: PodSpec,
        node_name: str,
        state: CycleState,
        pending_plugins: set[str],
        deadline: float,
        on_resolved: Callable[["WaitingPod", Status], None],
    ) -> None:
        self.pod = pod
        self.node_name = node_name
        self.state = state
        self.deadline = deadline
        self._pending = set(pending_plugins)
        self._on_resolved = on_resolved
        self._lock = threading.Lock()
        self._resolved: Status | None = None

    def allow(self, plugin_name: str) -> None:
        fire = False
        with self._lock:
            if self._resolved is not None:
                return
            self._pending.discard(plugin_name)
            if not self._pending:
                self._resolved = Status.ok()
                fire = True
        if fire:
            self._on_resolved(self, Status.ok())

    def reject(self, message: str) -> None:
        with self._lock:
            if self._resolved is not None:
                return
            self._resolved = Status.unschedulable(message)
        self._on_resolved(self, Status.unschedulable(message))


class _DaemonPool:
    """Minimal ``ThreadPoolExecutor`` stand-in with DAEMON worker
    threads and the same Future-returning ``submit`` contract.

    stdlib pools join their (non-daemon) workers at interpreter
    shutdown; for bind I/O that policy inverts the failure mode that
    matters — an executor whose owner dropped it without ``shutdown()``
    keeps idle non-daemon workers alive forever (the tests' thread
    hygiene gate flags exactly this), and a stalled round trip can then
    block process exit. Unbind tasks need no exit-time draining: in-flight
    work is bounded by the API client's request timeout and reservations
    roll back through resync."""

    def __init__(self, max_workers: int, thread_name_prefix: str) -> None:
        import queue as _queue

        self._max_workers = max_workers
        self._prefix = thread_name_prefix
        self._q: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._threads: "list[threading.Thread]" = []
        self._lock = threading.Lock()
        self._down = False

    def submit(self, fn: Callable[[], object]):
        from concurrent.futures import Future

        fut: Future = Future()
        with self._lock:
            if self._down:
                raise RuntimeError("cannot submit after shutdown")
            self._q.put((fut, fn))
            if len(self._threads) < self._max_workers:
                t = threading.Thread(
                    target=self._worker,
                    name=f"{self._prefix}_{len(self._threads)}",
                    daemon=True,
                )
                self._threads.append(t)
                t.start()
        return fut

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — future carries it
                fut.set_exception(e)

    def shutdown(self) -> None:
        """Refuse new work and end every worker after the tasks already
        queued (one sentinel each); does not wait for them."""
        with self._lock:
            self._down = True
            threads = list(self._threads)
        for _ in threads:
            self._q.put(None)


class BindExecutor:
    """Bounded-concurrency unbind fan-out (config ``bind_workers``).

    A persistent thread pool that carries unbind API round trips off the
    calling thread. ``build_stack`` makes one when ``bind_workers`` > 0 and
    hands it to the node health monitor and the rebalancer, whose repairs
    and moves put every member's unbind here through :func:`unbind_all`
    and wait for all of them, so the round trips overlap.

    The reference's executor also keeps completion bookkeeping
    (``inflight()``, ``on_settled``) and a ``stop_event`` for its bind
    pipeline and CLI; neither is ported, so neither is here.

    Workers are created lazily on the first submit, so stacks that never
    repair or move anything never pay the threads. They are DAEMON
    threads (see ``_DaemonPool``): an executor whose owner forgot
    ``shutdown()`` must never wedge interpreter exit.
    """

    def __init__(self, workers: int = 8, *, name: str = "bind") -> None:
        self.workers = max(int(workers), 1)
        self._name = name
        self._lock = threading.Lock()
        self._pool: _DaemonPool | None = None

    def submit(self, fn: Callable[[], None]):
        """Run ``fn`` on a worker; returns the Future. ``fn``'s exceptions
        are logged, never propagated — unbind failures are reported through
        the rollback path, not the future."""
        with self._lock:
            if self._pool is None:
                self._pool = _DaemonPool(
                    max_workers=self.workers,
                    thread_name_prefix=f"{self._name}-worker",
                )
            pool = self._pool

        def run() -> None:
            try:
                fn()
            except Exception:  # noqa: BLE001 — workers must never die silently
                log.exception("bind executor task failed")

        return pool.submit(run)

    def shutdown(self) -> None:
        """Stop the workers; the next submit starts a fresh pool."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown()


def unbind_all(
    scheduler,
    bind_executor: BindExecutor | None,
    items: "list[tuple[PodSpec, str]]",
    why: str,
) -> None:
    """Unbind every (pod, host) through the scheduler's standard rollback
    path (unbind -> unreserve -> requeue). With an executor and more than
    one item every rollback is submitted there and the caller waits for
    all of them, so the API round trips overlap; otherwise they run inline.
    The node health monitor's repairs and the rebalancer's moves both call
    this from their own (background) thread — the serve loop never waits."""
    if bind_executor is not None and len(items) > 1:
        futures = [
            bind_executor.submit(
                lambda pod=pod, host=host: scheduler._rollback_bound(
                    pod, host, None, why
                )
            )
            for pod, host in items
        ]
        for f in futures:
            f.result()
    else:
        for pod, host in items:
            scheduler._rollback_bound(pod, host, None, why)


class Framework:
    def __init__(self, plugins: Sequence[Plugin]) -> None:
        self.queue_sort = next(
            (p for p in plugins if isinstance(p, QueueSortPlugin)), None
        )
        self.pre_filter_plugins = [p for p in plugins if isinstance(p, PreFilterPlugin)]
        self.filter_plugins = [p for p in plugins if isinstance(p, FilterPlugin)]
        self.post_filter_plugins = [p for p in plugins if isinstance(p, PostFilterPlugin)]
        self.pre_score_plugins = [p for p in plugins if isinstance(p, PreScorePlugin)]
        self.score_plugins = [p for p in plugins if isinstance(p, ScorePlugin)]
        self.batch_plugins = [p for p in plugins if isinstance(p, BatchFilterScorePlugin)]
        self.reserve_plugins = [p for p in plugins if isinstance(p, ReservePlugin)]
        self.permit_plugins = [p for p in plugins if isinstance(p, PermitPlugin)]
        self.bind_plugins = [p for p in plugins if isinstance(p, BindPlugin)]
        self._waiting: dict[str, WaitingPod] = {}
        self._waiting_lock = threading.Lock()

    # --- filter / score ---

    def run_pre_filter(self, state: CycleState, pod: PodSpec, snapshot: Snapshot) -> Status:
        for p in self.pre_filter_plugins:
            st = p.pre_filter(state, pod, snapshot)
            if not st.success and st.code != Code.SKIP:
                return st
        return Status.ok()

    @property
    def supports_burst(self) -> bool:
        """True when some batch plugin can pre-evaluate a multi-pod burst
        (YodaBatch.prepare_burst)."""
        return any(hasattr(p, "prepare_burst") for p in self.batch_plugins)

    def prepare_burst(self, pods: Sequence[PodSpec], snapshot: Snapshot) -> None:
        """Hand the next K pending pods to burst-capable batch plugins: one
        kernel dispatch evaluates them all, and their individual scheduling
        cycles are then served from the cached rows. Purely advisory — a
        plugin may decline, and cycles fall back to individual dispatches."""
        for p in self.batch_plugins:
            prepare = getattr(p, "prepare_burst", None)
            if prepare is not None:
                prepare(pods, snapshot)

    def prepare_gang(self, pods: Sequence[PodSpec], snapshot: Snapshot) -> None:
        """Hand a gathered gang (every co-queued member, one gang) to
        gang-burst-capable batch plugins: ONE kernel dispatch evaluates all
        members, and each member's cycle is served from its own row with
        the chips claimed by earlier members deducted
        (YodaBatch.prepare_gang_burst). Advisory, like prepare_burst —
        member cycles fall back to per-cycle dispatches / the gang plan."""
        for p in self.batch_plugins:
            prepare = getattr(p, "prepare_gang_burst", None)
            if prepare is not None:
                prepare(pods, snapshot)

    def prepare_joint(
        self,
        groups: "Sequence[Sequence[PodSpec]]",
        snapshot: Snapshot,
    ) -> "list[str] | None":
        """Hand SEVERAL gathered gangs (one group per gang, priority
        order) to joint-capable batch plugins: ONE kernel dispatch
        evaluates every member of every gang, and each gang's cycles are
        served net of the claims of higher-priority gangs in the same
        dispatch (YodaBatch.prepare_joint_burst). Returns the first
        capable plugin's per-group verdicts — "fused" (drive the members
        this turn), "solo" (schedule per-cycle), "park" (cannot fit
        whole; restore untouched) — or None when no plugin can run a
        joint pass (the scheduler then falls back to per-gang passes)."""
        for p in self.batch_plugins:
            prepare = getattr(p, "prepare_joint_burst", None)
            if prepare is not None:
                return prepare(groups, snapshot)
        return None

    def run_batch_filter_score(
        self, state: CycleState, pod: PodSpec, snapshot: Snapshot
    ) -> tuple[dict[str, Status], dict[str, int]] | None:
        """Fused fast path; None when no batch plugin is registered. Regular
        FilterPlugins still run, but only over the batch-feasible subset."""
        if not self.batch_plugins:
            return None
        if len(self.batch_plugins) == 1:
            # The plugin's dicts are used directly (the batch contract hands
            # ownership to the caller — plugins must return fresh dicts).
            statuses, totals = self.batch_plugins[0].filter_and_score_batch(
                state, pod, snapshot
            )
            for n in snapshot.names():
                if n not in statuses:
                    statuses[n] = Status.ok()
                    totals.setdefault(n, 0)
        else:
            statuses = {n: Status.ok() for n in snapshot.names()}
            totals = {n: 0 for n in snapshot.names()}
            for p in self.batch_plugins:
                p_statuses, p_scores = p.filter_and_score_batch(
                    state, pod, snapshot
                )
                for n, st in p_statuses.items():
                    if not st.success and statuses[n].success:
                        statuses[n] = st
                for n, s in p_scores.items():
                    totals[n] += s
        for n, st in statuses.items():
            if not st.success:
                continue
            for p in self.filter_plugins:
                st2 = p.filter(state, pod, snapshot.get(n))
                if not st2.success:
                    statuses[n] = st2
                    break
        feasible_scores = {
            n: totals.get(n, 0) for n, st in statuses.items() if st.success
        }
        return statuses, feasible_scores

    def run_post_filter(
        self,
        state: CycleState,
        pod: PodSpec,
        snapshot: Snapshot,
        statuses: Mapping[str, Status],
    ) -> tuple[str | None, Status]:
        """PostFilter plugins in order, when no node passed Filter: the
        first that makes room nominates its node; an error stops the
        chain."""
        for p in self.post_filter_plugins:
            nominated, st = p.post_filter(state, pod, snapshot, statuses)
            if st.success and nominated:
                return nominated, st
            if st.code == Code.ERROR:
                return None, st
        return None, Status.unschedulable("no postfilter plugin could make room")

    def run_pre_score(
        self, state: CycleState, pod: PodSpec, snapshot: Snapshot, feasible: Sequence[str]
    ) -> Status:
        for p in self.pre_score_plugins:
            st = p.pre_score(state, pod, snapshot, feasible)
            if not st.success and st.code != Code.SKIP:
                return st
        return Status.ok()

    def run_scores(
        self, state: CycleState, pod: PodSpec, snapshot: Snapshot, feasible: Sequence[str]
    ) -> tuple[dict[str, int], Status]:
        totals: dict[str, int] = {n: 0 for n in feasible}
        for p in self.score_plugins:
            raw: dict[str, int] = {}
            for n in feasible:
                s, st = p.score(state, pod, snapshot.get(n))
                if not st.success:
                    return {}, st
                raw[n] = s
            st = p.normalize(state, pod, raw)
            if not st.success:
                return {}, st
            for n, s in raw.items():
                totals[n] += s
        return totals, Status.ok()

    # --- reserve / permit / bind ---

    def run_reserve(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        done: list[ReservePlugin] = []
        for p in self.reserve_plugins:
            st = p.reserve(state, pod, node_name)
            if not st.success:
                for q in reversed(done):
                    q.unreserve(state, pod, node_name)
                return st
            done.append(p)
        return Status.ok()

    def run_unreserve(self, state: CycleState, pod: PodSpec, node_name: str) -> None:
        for p in reversed(self.reserve_plugins):
            p.unreserve(state, pod, node_name)

    def run_permit(
        self,
        state: CycleState,
        pod: PodSpec,
        node_name: str,
        on_resolved: Callable[[WaitingPod, Status], None],
        *,
        now: float | None = None,
    ) -> Status:
        """Runs Permit plugins. On WAIT, registers a WaitingPod and returns
        WAIT; ``on_resolved`` fires (possibly re-entrantly from a later
        permit call) once it is allowed/rejected."""
        waiting_plugins: set[str] = set()
        max_timeout = 0.0
        for p in self.permit_plugins:
            st, timeout = p.permit(state, pod, node_name)
            if st.code == Code.WAIT:
                waiting_plugins.add(p.name)
                max_timeout = max(max_timeout, timeout)
            elif not st.success:
                return st
        if not waiting_plugins:
            return Status.ok()
        now = time.monotonic() if now is None else now
        wp = WaitingPod(
            pod,
            node_name,
            state,
            waiting_plugins,
            deadline=now + max_timeout,
            on_resolved=lambda w, s: self._finish_waiting(w, s, on_resolved),
        )
        with self._waiting_lock:
            self._waiting[pod.key] = wp
        # A permit plugin may have been waiting for exactly this pod (last
        # gang member): give plugins a chance to flush now it is registered.
        for p in self.permit_plugins:
            post = getattr(p, "on_pod_waiting", None)
            if post is not None:
                post(self, wp)
        return Status.wait()

    def _finish_waiting(
        self, wp: WaitingPod, status: Status, cb: Callable[[WaitingPod, Status], None]
    ) -> None:
        with self._waiting_lock:
            self._waiting.pop(wp.pod.key, None)
        # Permit plugins observe resolutions first (gang bookkeeping and
        # cascade rollback), then the scheduler binds or unreserves.
        for p in self.permit_plugins:
            hook = getattr(p, "on_pod_resolved", None)
            if hook is not None:
                hook(self, wp, status)
        cb(wp, status)

    def waiting_pods(self) -> list[WaitingPod]:
        with self._waiting_lock:
            return list(self._waiting.values())

    def get_waiting_pod(self, pod_key: str) -> WaitingPod | None:
        with self._waiting_lock:
            return self._waiting.get(pod_key)

    def cancel_waiting(self, pod_key: str, message: str) -> bool:
        """Reject ONE waiting pod by key, if present — the delete-event
        fast path cancels a deleted pod's Permit wait immediately instead
        of letting it eat the full timeout (its gang cascade then releases
        every sibling's reservation). Returns whether a wait was actually
        cancelled."""
        wp = self.get_waiting_pod(pod_key)
        if wp is None:
            return False
        wp.reject(message)
        return True

    def expire_waiting(self, *, now: float | None = None) -> int:
        """Reject waiting pods past their Permit deadline. Returns count."""
        now = time.monotonic() if now is None else now
        expired = [w for w in self.waiting_pods() if now >= w.deadline]
        for w in expired:
            w.reject(f"permit wait timed out for pod {w.pod.key}")
        return len(expired)

    def run_bind(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        for p in self.bind_plugins:
            st = p.bind(state, pod, node_name)
            if st.code != Code.SKIP:
                return st
        return Status.error(f"no bind plugin bound pod {pod.key}")

    def run_unbind(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        """Reverse a landed bind (transactional gang rollback): the first
        bind plugin implementing ``unbind`` handles it. An error status —
        including no plugin implementing it — means the pod may be
        stranded bound; the caller logs it and the watch stream remains
        the source of truth."""
        for p in self.bind_plugins:
            unbind = getattr(p, "unbind", None)
            if unbind is not None:
                st = unbind(state, pod, node_name)
                if st.code != Code.SKIP:
                    return st
        return Status.error(f"no bind plugin can unbind pod {pod.key}")
