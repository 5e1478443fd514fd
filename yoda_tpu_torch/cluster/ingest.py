"""Batched watch-event ingestion: bounded coalescing batches between the
cluster watch streams and the handler chain.

The serve-side scalability wall this removes: every watch event used to
run the full handler chain one at a time — per-event informer lock
round-trips, a metrics-epoch bump per event, and (for qualifying events) a
whole-queue ``move_all_to_active()`` sweep per event. At 1M-pod fleet
event rates the scheduler serializes through per-event Python long before
any kernel dispatch matters. Here the stream is drained into bounded
batches, coalesced by ``(kind, uid)`` — last-write-wins for modifies,
delete supersedes — and each batch is applied under ONE informer lock
acquisition with ONE metrics-epoch bump and ONE reactivation decision
(``InformerCache.handle_batch`` + the ``on_change_batch`` hook wired in
``standalone.build_stack``).

Coalescing semantics (the ingest-parity contract, tests/test_ingest.py and
tests/test_torch_ingest.py): consumers never observe intermediate states
inside one batch window — an object modified five times arrives once with
its final value; an object created and deleted inside the window never
arrives at all. End state is identical to per-event application; only the
intermediate observations (and the version/epoch counters) differ.

Counterpart of ``yoda_tpu/cluster/ingest.py``, whole. In the port each
applied batch also reaches the device-resident fleet state: the informer's
delta feeds report the batch's changed rows once, and the next dispatch
applies them with one ``TorchFleetKernel.update_rows``. The ``on_batch``
hook also gets each apply's start and end, which ``build_stack`` turns
into ``yoda_ingest_apply_seconds``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable

from yoda_tpu_torch.cluster.fake import Event


def _coalesce_key(event: Event) -> "tuple[str, str] | None":
    """Identity key for coalescing, or None for barrier events ("synced"
    sentinels carry no object and must never merge or reorder). Keyed by
    uid where the object has one (a deleted-and-recreated pod has a fresh
    uid and must NOT coalesce with its predecessor), else by the object's
    key/name."""
    if event.type == "synced" or event.obj is None:
        return None
    obj = event.obj
    ident = getattr(obj, "uid", "") or ""
    if not ident:
        ident = getattr(obj, "key", None) or getattr(obj, "name", "")
    return (event.kind, str(ident))


def coalesce(events: Iterable[Event]) -> list[Event]:
    """Collapse an event run to its net effect per object, preserving the
    relative order of first appearance (cross-kind causality — a Node
    added before a Pod bound to it stays before it). Rules:

    - modify after add  -> one "added" carrying the LATEST object (the
      consumer never saw the add, so the merged event must still announce
      a new object);
    - modify after modify -> last write wins;
    - delete after modify -> the delete alone (delete supersedes);
    - delete after a not-yet-delivered add -> both dropped (net zero);
    - delete then add under the SAME key (non-uid kinds recreated in one
      window) -> both kept, in order — never merged across a deletion.
    """
    slots: list[Event | None] = []
    index: dict[tuple[str, str], int] = {}
    for event in events:
        key = _coalesce_key(event)
        if key is None:
            slots.append(event)
            continue
        i = index.get(key)
        prev = slots[i] if i is not None else None
        if prev is None:
            index[key] = len(slots)
            slots.append(event)
            continue
        if event.type == "deleted":
            if prev.type == "added":
                slots[i] = None  # created and destroyed inside the window
                del index[key]
            else:
                slots[i] = event
        elif prev.type == "deleted":
            # Recreation under a reused key: keep the delete where it
            # was and start a fresh entry for the new object.
            index[key] = len(slots)
            slots.append(event)
        elif prev.type == "added":
            slots[i] = Event("added", event.kind, event.obj)
        else:
            slots[i] = event
    return [e for e in slots if e is not None]


class EventBatcher:
    """Bounded batching stage between a cluster's watch delivery and the
    handler chain. ``offer`` (the per-event watcher) buffers and
    coalesces; a batch is applied — via ``apply_fn(list_of_events)`` —
    when the buffer reaches ``batch_max``, when ``window_s`` elapses
    since the batch's first event (background drain thread), or on an
    explicit :meth:`flush`. With ``window_s == 0`` every offer flushes
    immediately (batch of one: per-event semantics, kept for the
    knob-gated off position). Batches are applied one at a time in
    arrival order (``_apply_lock``); events offered during an apply go
    to the next batch."""

    def __init__(
        self,
        apply_fn: Callable[[list[Event]], None],
        *,
        batch_max: int = 256,
        window_s: float = 0.0,
        on_batch: "Callable[[int, int, float, float], None] | None" = None,
    ) -> None:
        self.apply_fn = apply_fn
        self.batch_max = max(int(batch_max), 1)
        self.window_s = max(float(window_s), 0.0)
        # Observability hook: (raw events in, coalesced events applied,
        # the apply's start and end on the monotonic clock, equal when
        # nothing was applied) per batch — feeds yoda_ingest_events_total
        # / _batch_size and the port's yoda_ingest_apply_seconds.
        self.on_batch = on_batch
        self.events_in = 0
        self.batches = 0
        self.events_out = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._apply_lock = threading.Lock()
        self._slots: list[Event | None] = []
        self._index: dict[tuple[str, str], int] = {}
        self._pending = 0  # live (non-None) slots — O(1) batch_max check
        self._raw = 0  # raw events buffered (pre-coalescing)
        self._first_at: float | None = None
        self._stopped = False
        self._thread: threading.Thread | None = None
        if self.window_s > 0:
            self._thread = threading.Thread(
                target=self._drain_loop, name="yoda-ingest", daemon=True
            )
            self._thread.start()

    # --- watcher surface (cluster add_watcher) ---

    def offer(self, event: Event) -> None:
        self.offer_batch((event,))

    def offer_batch(self, events: Iterable[Event]) -> None:
        """Buffer a run of events (the clusters' list-delivery path hands
        whole LIST/replay diffs here in one call). Coalesces in place
        against anything already buffered."""
        flush_now = False
        with self._cond:
            for event in events:
                self._raw += 1
                key = _coalesce_key(event)
                i = self._index.get(key) if key is not None else None
                prev = self._slots[i] if i is not None else None
                if key is None or prev is None:
                    if key is not None:
                        self._index[key] = len(self._slots)
                    self._slots.append(event)
                    self._pending += 1
                elif event.type == "deleted":
                    if prev.type == "added":
                        self._slots[i] = None
                        del self._index[key]
                        self._pending -= 1
                    else:
                        self._slots[i] = event
                elif prev.type == "deleted":
                    self._index[key] = len(self._slots)
                    self._slots.append(event)
                    self._pending += 1
                elif prev.type == "added":
                    self._slots[i] = Event("added", event.kind, event.obj)
                else:
                    self._slots[i] = event
            if self._first_at is None and self._pending:
                self._first_at = time.monotonic()
                self._cond.notify_all()
            if self._pending >= self.batch_max or (
                self.window_s == 0 and self._pending
            ):
                flush_now = True
        if flush_now:
            self.flush()

    def backlog(self) -> int:
        """Coalesced events buffered and not yet applied — the overload
        monitor's ingest-pressure signal (a flood the apply chain is not
        keeping up with shows here first)."""
        with self._lock:
            return self._pending

    # --- draining ---

    def _take_locked(self) -> "tuple[list[Event], int]":
        batch = [e for e in self._slots if e is not None]
        raw = self._raw
        self._slots = []
        self._index = {}
        self._pending = 0
        self._raw = 0
        self._first_at = None
        return batch, raw

    def flush(self) -> None:
        """Apply everything buffered right now (tests, shutdown, and the
        batch_max / zero-window fast paths). Serialized against the drain
        thread so batches land in order."""
        with self._apply_lock:
            with self._cond:
                batch, raw = self._take_locked()
            if not batch and raw == 0:
                return
            self.events_in += raw
            t0 = t1 = time.monotonic()
            if batch:
                self.batches += 1
                self.events_out += len(batch)
                self.apply_fn(batch)
                t1 = time.monotonic()
            if self.on_batch is not None:
                self.on_batch(raw, len(batch), t0, t1)

    def _drain_loop(self) -> None:
        while True:
            with self._cond:
                while self._first_at is None and not self._stopped:
                    self._cond.wait()
                if self._stopped and self._first_at is None:
                    return
                deadline = (self._first_at or 0.0) + self.window_s
                while not self._stopped:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._first_at is None:
                        break
                    self._cond.wait(timeout=remaining)
            self.flush()
            if self._stopped:
                with self._cond:
                    if self._first_at is None:
                        return

    def stop(self) -> None:
        """Stop the drain thread and apply any residue."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self.flush()
