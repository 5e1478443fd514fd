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
bind executor (``BindExecutor`` over ``_DaemonPool``) with its completion
bookkeeping (``inflight()``, ``on_settled``, ``submitted``) and its
``stop_event``: the bind pipeline fans a gang's member binds out on it, and
the node health monitor and the rebalancer fan their unbinds out on it.
Loop mode's per-node filter loop (``run_filters``) is here too, with its
truncated, rotating search and the node-health fence.
``Framework.tracer`` (wired by ``build_stack``) records the bind and unbind
spans on whichever thread runs them: the scheduling thread, or an executor
worker for pipelined binds and for the monitor's and the rebalancer's
unbind fan-out.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Mapping, Sequence

from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.tracing import subject_of
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
    RowVerdicts,
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
        parked_at: float | None = None,
    ) -> None:
        self.pod = pod
        self.node_name = node_name
        self.state = state
        self.deadline = deadline
        self.parked_at = parked_at  # clock time the pod entered the waitlist
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

    def shutdown(self, wait: bool = True, cancel_futures: bool = False) -> None:
        import queue as _queue

        with self._lock:
            self._down = True
            threads = list(self._threads)
        if cancel_futures:
            while True:
                try:
                    item = self._q.get_nowait()
                except _queue.Empty:
                    break
                if item is not None:
                    item[0].cancel()
        for _ in threads:
            self._q.put(None)
        if wait:
            for t in threads:
                t.join()


class BindExecutor:
    """Bounded-concurrency bind fan-out — the bind pipeline (config
    ``bind_workers``).

    A persistent thread pool that carries bind API round-trips, and their
    retry/backoff sleeps, OFF the scheduling thread: a gang's waitlist
    release submits every member's allow-and-bind here and returns, so the
    serve loop starts the next cycle's snapshot refresh and kernel dispatch
    while the previous cycle's binds are still in flight. In-flight binds
    stay charged to the accountant through their reservations, so the
    overlapped dispatch already sees their capacity as consumed.

    The executor is the pipeline's completion bookkeeping too:

    - ``inflight()`` feeds the ``yoda_bind_inflight`` gauge and the drain
      barrier (``Scheduler.run_until_idle`` treats pending binds as active
      work instead of concluding idle under them);
    - every settle fires ``on_settled`` (the scheduler wires its activity
      signal) so drain waits are event-bound, not polled;
    - ``stop_event`` is shared with the binder's interruptible backoff
      sleeps: setting it (shutdown, leadership loss) aborts pending retry
      waits promptly instead of draining up to ``retry_cap_s`` each.

    Workers are created lazily on the first submit, so pipeline-disabled
    stacks and tests never pay the threads. They are DAEMON threads (see
    ``_DaemonPool``): an executor whose owner forgot ``shutdown()`` — a
    dropped test stack, a SIGTERM mid-drain — must never wedge
    interpreter exit or trip the tests' thread-hygiene gate; orderly
    shutdown still exists and is what cli.py uses.

    The node health monitor's repairs and the rebalancer's moves fan their
    unbinds out on the same executor (:func:`unbind_all`).
    """

    def __init__(
        self,
        workers: int = 8,
        *,
        stop_event: "threading.Event | None" = None,
        name: str = "bind",
    ) -> None:
        self.workers = max(int(workers), 1)
        self.stop_event = stop_event if stop_event is not None else threading.Event()
        # Fired (no args) after every task settles, successes and failures
        # alike, AFTER the in-flight count dropped — a waiter woken by it
        # observes the decrement.
        self.on_settled: Callable[[], None] | None = None
        self._name = name
        self._lock = threading.Lock()
        self._pool = None
        self._inflight = 0
        self.submitted = 0  # lifetime task count (tests, introspection)

    def submit(self, fn: Callable[[], None]):
        """Run ``fn`` on a worker; returns the Future. ``fn``'s exceptions
        are logged, never propagated — bind failures are reported through
        the resolution chain, not the future."""
        with self._lock:
            if self._pool is None:
                self._pool = _DaemonPool(
                    max_workers=self.workers,
                    thread_name_prefix=f"{self._name}-worker",
                )
            self._inflight += 1
            self.submitted += 1

        def run() -> None:
            try:
                fn()
            except Exception:  # noqa: BLE001 — workers must never die silently
                log.exception("bind executor task failed")
            finally:
                with self._lock:
                    self._inflight -= 1
                cb = self.on_settled
                if cb is not None:
                    cb()

        return self._pool.submit(run)

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def shutdown(self) -> None:
        """Stop accepting work and abort pending retry sleeps. ``wait=False``
        so a SIGTERM during a stalled bind round-trip does not block the
        drain on the worker; the in-flight HTTP call is bounded by the API
        client's request timeout either way."""
        self.stop_event.set()
        self.release()

    def release(self) -> None:
        """Shut the worker pool WITHOUT firing ``stop_event`` — the live
        shard resize retires one lane's executor while the process-wide
        stop event (shared by every lane's interruptible sleeps) must
        stay unset. Idle daemon workers exit on their sentinels."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)


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
        # Lifecycle tracer (tracing.py), wired by standalone.build_stack:
        # run_bind/run_unbind record spans on WHICHEVER thread executes
        # them, so the Perfetto view puts executor-side unbinds on their
        # worker's own track.
        self.tracer = None
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

    def run_filters(
        self,
        state: CycleState,
        pod: PodSpec,
        snapshot: Snapshot,
        *,
        stop_after_feasible: int = 0,
        start_index: int = 0,
    ) -> dict[str, Status]:
        """Run the FilterPlugin chain per node. ``stop_after_feasible > 0``
        truncates the SEARCH once that many feasible nodes are found
        (upstream percentageOfNodesToScore semantics: Filter work is
        capped too, not just score fan-out), scanning from the rotating
        ``start_index`` so the cap does not always favor the same
        name-ordered prefix. Unscanned nodes are simply absent from the
        returned map — preemption walks the snapshot itself, so PostFilter
        is unaffected."""
        statuses: dict[str, Status] = {}
        infos = snapshot.infos()
        n = len(infos)
        feasible = 0
        # Node-health fence (yoda_tpu/nodehealth): SUSPECT/DRAINING/DOWN
        # hosts take no NEW placements — the loop-mode half of the veto
        # the batch path applies in its cached admission vector.
        fenced = getattr(snapshot, "fenced", None)
        for i in range(n):
            node = infos[(start_index + i) % n]
            if fenced and node.name in fenced:
                statuses[node.name] = Status.unschedulable(
                    "node fenced by the health monitor (suspect/draining/"
                    "down)"
                )
                continue
            st = Status.ok()
            for p in self.filter_plugins:
                st = p.filter(state, pod, node)
                if not st.success:
                    break
            statuses[node.name] = st
            if st.success:
                feasible += 1
                if stop_after_feasible and feasible >= stop_after_feasible:
                    break
        return statuses

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
    ) -> tuple[Mapping[str, Status], dict[str, int]] | None:
        """Fused fast path; None when no batch plugin is registered. Regular
        FilterPlugins still run, but only over the batch-feasible subset.
        A lone plugin's :class:`RowVerdicts` comes back as it is when it
        covers the snapshot's nodes; otherwise the statuses are a dict."""
        if not self.batch_plugins:
            return None
        if len(self.batch_plugins) == 1:
            # The plugin's dicts are used directly (the batch contract hands
            # ownership to the caller — plugins must return fresh dicts).
            statuses, totals = self.batch_plugins[0].filter_and_score_batch(
                state, pod, snapshot
            )
            if isinstance(statuses, RowVerdicts):
                names = snapshot.names()
                if statuses.covers(names):
                    # A row-served cycle: only the row's pick can pass, so
                    # the filter plugins see it alone and no other node's
                    # verdict is read.
                    for n in statuses.feasible():
                        for p in self.filter_plugins:
                            st2 = p.filter(state, pod, snapshot.get(n))
                            if not st2.success:
                                statuses.reject(n, st2)
                                break
                    return statuses, {
                        n: totals.get(n, 0) for n in statuses.feasible()
                    }
                statuses = dict(statuses)
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
            parked_at=now,
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

    # An inline bind cheaper than this adds no information beyond its
    # cycle span (whose wall already contains it) — recording it would be
    # pure hot-path cost. Executor-side binds record regardless (their
    # wall lives on a worker track the cycle span cannot show).
    BIND_SPAN_MIN_S = 0.0005

    def run_bind(self, state: CycleState, pod: PodSpec, node_name: str) -> Status:
        tracer = self.tracer
        if tracer is None or not tracer.enabled:
            return self._run_bind_inner(state, pod, node_name)
        t0 = time.monotonic()
        st = self._run_bind_inner(state, pod, node_name)
        t1 = time.monotonic()
        track = threading.current_thread().name
        if (
            t1 - t0 >= self.BIND_SPAN_MIN_S
            or not st.success
            or track.startswith("bind-")
        ):
            tracer.add(
                subject_of(pod), "bind",
                t0=t0, t1=t1, track=track,
                attrs={"pod": pod.key, "node": node_name, "ok": st.success},
            )
        return st

    def _run_bind_inner(
        self, state: CycleState, pod: PodSpec, node_name: str
    ) -> Status:
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
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            t0 = time.monotonic()
            st = self._run_unbind_inner(state, pod, node_name)
            tracer.add(
                subject_of(pod), "unbind",
                t0=t0, t1=time.monotonic(),
                attrs={"pod": pod.key, "node": node_name, "ok": st.success},
            )
            return st
        return self._run_unbind_inner(state, pod, node_name)

    def _run_unbind_inner(
        self, state: CycleState, pod: PodSpec, node_name: str
    ) -> Status:
        for p in self.bind_plugins:
            unbind = getattr(p, "unbind", None)
            if unbind is not None:
                st = unbind(state, pod, node_name)
                if st.code != Code.SKIP:
                    return st
        return Status.error(f"no bind plugin can unbind pod {pod.key}")
