"""Device-resident, incrementally-maintained fleet state.

Without it the serve loop's pre-dispatch cost is O(fleet) per cycle no
matter how little changed: every metrics bump re-reads the snapshot into
host arrays and re-uploads the whole fleet to the evaluation's device, and
every dispatch rebuilds the [4, N] dynamics vector with an O(N) Python
loop over the accountant / informer maps. :class:`FleetStateCache`
replaces that with delta maintenance:

- The informer's epoch/delta feed (``InformerCache.changes_since``) names
  exactly which nodes' CR values changed since the epoch the resident
  state reflects; only those rows are refilled host-side and scattered
  into the device-resident static tensors in place
  (``TorchFleetKernel.update_rows``: one pinned copy of the rows' payload
  and ``index_copy_`` along the node axis).
- A full re-stack (``FleetArrays.from_snapshot`` + ``put_static``) happens
  only on epoch skew (the consumer fell behind the bounded delta ring, or
  holds state from another informer), on a structural delta (node added or
  removed: row indices may shift), on chip-bucket growth, or when the
  delta touches too much of the fleet for row-wise refill to beat the
  rebuild. The first sync re-stacks like the classic path: what the cache
  removes is the re-stacks and re-uploads after churn.
- The per-cycle dynamics rows (reserved chips, claimed HBM) are likewise
  maintained from the accountant's and informer's delta feeds: at low
  churn a cycle applies O(changed) scalar writes instead of copying
  O(fleet) maps.

Counterpart of ``yoda_tpu/ops/resident.py``. ``mesh_multiple`` (the batch
plugin's ``mesh_devices``) rounds the row bucket up to a multiple of the
mesh's shard count, so the node-sharded evaluation
(``parallel/sharded.py``) splits the fleet into equal row blocks.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from yoda_tpu_torch.ops.arrays import FleetArrays, bucket_rows
from yoda_tpu_torch.ops.kernel import INT32_MAX


class FleetStateCache:
    """Incrementally-maintained mirror of the fleet plus its device-resident
    evaluation state. ``sync(snapshot)`` brings both up to the snapshot's
    metrics epoch (delta row refill, or full re-stack when the delta feed
    cannot serve); ``dyn_packed()`` returns the per-cycle [4, N] dynamics
    array, maintained from the reservation/claim delta feeds.

    ``kern_fn(arrays)`` is consulted on every re-stack and returns the
    kernel the fleet runs on (the batch plugin's one ``TorchFleetKernel``);
    it gets a full ``put_static``, delta syncs use its ``update_rows``.
    """

    def __init__(
        self,
        *,
        changes_fn: Callable,           # InformerCache.changes_since
        kern_fn: Callable,              # arrays -> kernel for this shape
        max_metrics_age_s: float = 0.0,
        mesh_multiple: "int | None" = None,
        reserved_delta_fn: "Callable | None" = None,
        reserved_map_fn: "Callable | None" = None,
        reserved_fn: "Callable | None" = None,
        claimed_delta_fn: "Callable | None" = None,
        claimed_map_fn: "Callable | None" = None,
        claimed_fn: "Callable | None" = None,
        last_updated_map_fn: "Callable | None" = None,
    ) -> None:
        self.changes_fn = changes_fn
        self.kern_fn = kern_fn
        self.max_metrics_age_s = max_metrics_age_s
        self.mesh_multiple = mesh_multiple
        self.reserved_delta_fn = reserved_delta_fn
        self.reserved_map_fn = reserved_map_fn
        self.reserved_fn = reserved_fn          # per-node fallback
        self.claimed_delta_fn = claimed_delta_fn
        self.claimed_map_fn = claimed_map_fn
        self.claimed_fn = claimed_fn            # per-node fallback
        self.last_updated_map_fn = last_updated_map_fn
        self.arrays: FleetArrays | None = None
        self.kern = None
        self.epoch = 0                  # informer metrics epoch reflected
        self._index: dict[str, int] = {}
        # Dynamics state: the [4, N] vector reused across cycles, the
        # delta-feed epochs its rows 1/2 are current to, and the rows the
        # last syncs refilled (their baked dynamics inputs — freshness, and
        # reserved/claimed when no live source is wired — must be
        # refreshed in the reused vector).
        self._dyn: np.ndarray | None = None
        self._res_epoch = -1
        self._claim_epoch = -1
        self._stale_rows: set[int] = set()
        self.reuse = 0                  # syncs answered by the cached epoch
        self.restacks = 0               # full from_snapshot + put_static
        self.delta_syncs = 0            # syncs served by row refill
        self.rows_applied = 0           # rows scattered in place, total
        self.last_delta_ms = 0.0        # wall ms of the last delta sync
        self.last_restack_ms = 0.0      # wall ms of the last full re-stack

    # --- static state ---

    def sync(self, snapshot) -> FleetArrays:
        """Bring the resident state up to ``snapshot``'s metrics epoch and
        return the host mirror arrays."""
        target = snapshot.metrics_version or snapshot.version
        if self.arrays is not None and self.kern is not None and self.epoch == target:
            self.reuse += 1
            return self.arrays
        t0 = time.perf_counter()
        delta = self.changes_fn(self.epoch) if self.arrays is not None else None
        if delta is None or delta.structural:
            return self._restack(snapshot, target, t0)
        a = self.arrays
        # Beyond ~a quarter of the fleet the per-row refill costs what the
        # vectorized rebuild does: re-stack instead.
        if len(delta.changed) > max(len(a.names) // 4, 8):
            return self._restack(snapshot, target, t0)
        rows: list[int] = []
        for name in delta.changed:
            i = self._index.get(name)
            # The delta may run ahead of the snapshot (the informer moved
            # on after this cycle's snapshot was cut): a changed node the
            # snapshot cannot resolve, or one the mirror has no row for,
            # takes the safe path.
            if i is None or name not in snapshot:
                return self._restack(snapshot, target, t0)
            ni = snapshot.get(name)
            if ni.tpu is None or ni.tpu.chip_count > a.padded_shape[1]:
                return self._restack(snapshot, target, t0)  # bucket outgrown
            rows.append(i)
        now = time.time()
        for i in rows:
            a.fill_row(
                i,
                snapshot.get(a.names[i]),
                max_metrics_age_s=self.max_metrics_age_s,
                now=now,
            )
        if rows:
            self.kern.update_rows(a, rows)
            self.rows_applied += len(rows)
            self._stale_rows.update(rows)
        self.delta_syncs += 1
        # The snapshot's epoch, not the feed's current one: changes that
        # landed after the snapshot was cut are applied next sync instead
        # of skipped.
        self.epoch = target
        self.last_delta_ms = (time.perf_counter() - t0) * 1e3
        return a

    def _restack(self, snapshot, target: int, t0: float) -> FleetArrays:
        arrays = FleetArrays.from_snapshot(
            snapshot,
            max_metrics_age_s=self.max_metrics_age_s,
            node_bucket=(
                bucket_rows(len(snapshot), multiple_of=self.mesh_multiple)
                if self.mesh_multiple
                else None
            ),
        )
        kern = self.kern_fn(arrays)
        kern.put_static(arrays)
        self.kern = kern
        self.arrays = arrays
        self._index = {nm: i for i, nm in enumerate(arrays.names)}
        self._dyn = None  # shapes/rows moved: rebuild the dynamics vector
        self.restacks += 1
        self.epoch = target
        self.last_restack_ms = (time.perf_counter() - t0) * 1e3
        return arrays

    # --- per-cycle dynamics ---

    def _apply_row_delta(
        self,
        row: np.ndarray,
        delta_fn: "Callable | None",
        map_fn: "Callable | None",
        node_fn: "Callable | None",
        prev_epoch: int,
        cap: "int | None" = None,
    ) -> int:
        """Bring one dynamics row up to its feed's current epoch: write the
        changed nodes' values in place, or rebuild the row from the full
        map (or the per-node fallback) when the feed cannot serve — the
        consumer fell behind, or no feed is wired. Returns the epoch the
        row is now current to."""
        a = self.arrays
        cur, changes = delta_fn(prev_epoch) if delta_fn else (0, None)
        if changes is None:
            if map_fn is not None:
                get = map_fn().get
                src = (get(nm, 0) for nm in a.names)
            elif node_fn is not None:
                src = (node_fn(nm) for nm in a.names)
            else:
                src = (0 for _ in a.names)
            n_real = len(a.names)
            row[:] = 0
            vals = np.fromiter(src, np.int64, n_real)
            if cap is not None:
                vals = np.minimum(vals, cap)
            row[:n_real] = vals
        else:
            idx = self._index
            for nm, v in changes.items():
                i = idx.get(nm)
                if i is not None:
                    row[i] = v if cap is None else min(v, cap)
        return cur

    def dyn_packed(self, *, host_ok: "np.ndarray | None" = None) -> np.ndarray:
        """The per-cycle [4, N] dynamics array (ops.kernel.DYN_KEYS rows),
        equal to ``FleetArrays.dyn_packed`` over the live reservation and
        claim sources but maintained in place: at low churn a cycle costs
        O(changed reservations), not O(fleet). The freshness row is the one
        O(N)-per-cycle exception, and only when a staleness gate is set.

        The returned array is reused across cycles. It reaches the device
        only through ``pack_inputs``, which copies it into the call's
        staging buffer; callers copy anything they keep (the burst sets
        keep ``dyn[1]`` as a copy)."""
        a = self.arrays
        if a is None:
            raise RuntimeError("sync() must run before dyn_packed()")
        n = a.node_valid.shape[0]
        has_reserved_src = bool(
            self.reserved_delta_fn or self.reserved_map_fn or self.reserved_fn
        )
        has_claimed_src = bool(
            self.claimed_delta_fn or self.claimed_map_fn or self.claimed_fn
        )
        if self._dyn is None or self._dyn.shape[1] != n:
            self._dyn = np.zeros((4, n), dtype=np.int32)
            if self.max_metrics_age_s <= 0:
                self._dyn[0] = a.fresh
            # Without a live source a row tracks the baked arrays' values
            # (fill_row maintains them per refill): FleetArrays.dyn_packed's
            # None-source semantics.
            if not has_reserved_src:
                self._dyn[1] = a.reserved_chips
            if not has_claimed_src:
                self._dyn[2] = a.claimed_hbm_mib
            self._res_epoch = -1    # force row rebuilds from the maps
            self._claim_epoch = -1
            self._stale_rows.clear()
        dyn = self._dyn
        if self._stale_rows:
            # Rows refilled since the last cycle: refresh their baked
            # entries in the reused vector (O(refilled)).
            for i in self._stale_rows:
                if self.max_metrics_age_s <= 0:
                    dyn[0, i] = a.fresh[i]
                if not has_reserved_src:
                    dyn[1, i] = a.reserved_chips[i]
                if not has_claimed_src:
                    dyn[2, i] = a.claimed_hbm_mib[i]
            self._stale_rows.clear()
        if has_reserved_src:
            self._res_epoch = self._apply_row_delta(
                dyn[1], self.reserved_delta_fn, self.reserved_map_fn,
                self.reserved_fn, self._res_epoch,
            )
        if has_claimed_src:
            self._claim_epoch = self._apply_row_delta(
                dyn[2], self.claimed_delta_fn, self.claimed_map_fn,
                self.claimed_fn, self._claim_epoch, cap=INT32_MAX,
            )
        if self.max_metrics_age_s > 0:
            now = time.time()
            if self.last_updated_map_fn is not None:
                # Live timestamps (heartbeat republishes skip the
                # metrics-version bump, so the baked ones age).
                get = self.last_updated_map_fn().get
                n_real = len(a.names)
                ts = np.fromiter(
                    (get(nm, 0.0) for nm in a.names), np.float64, n_real
                )
                dyn[0] = 0
                dyn[0, :n_real] = (now - ts) <= self.max_metrics_age_s
            else:
                dyn[0] = (now - a.last_updated) <= self.max_metrics_age_s
        # (With no staleness gate, row 0 was seeded from a.fresh and row
        # refills keep it current: nothing ages.)
        dyn[3] = a.host_ok if host_ok is None else host_ok
        return dyn
