"""Fleet metrics as padded structure-of-arrays for the fleet evaluation.

Shapes are bucketed per (node-bucket, chip-bucket) so the device-resident
arrays are reallocated only as the fleet outgrows a bucket. HBM is stored
in MiB as int32 (2^31 MiB = 2 PiB max — ample) so all score arithmetic is
exact integer math matching the Python plugin semantics.

Counterpart of ``yoda_tpu/ops/arrays.py``; the arrays stay numpy host
mirrors, uploaded to the evaluation's device by ``ops.kernel``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np

from yoda_tpu_torch.framework.interfaces import Snapshot

MIB = 1 << 20

# Field dtypes other than int32 (FleetArrays.from_numpy).
_DTYPES = {
    "node_valid": bool,
    "in_slice": bool,
    "fresh": bool,
    "host_ok": bool,
    "last_updated": np.float64,
    "chip_valid": bool,
    "chip_healthy": bool,
    "chip_used": bool,
}

_MIN_NODE_BUCKET = 8
_MIN_CHIP_BUCKET = 4


def _bucket(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def bucket_rows(n_nodes: int, *, multiple_of: int = 1) -> int:
    """Padded row count for a fleet of ``n_nodes``: power-of-two growth from
    the minimum bucket, rounded up to ``multiple_of`` (a row-sharded
    evaluation needs rows divisible by its shard count)."""
    b = _bucket(max(n_nodes, 1), _MIN_NODE_BUCKET)
    return -(-b // multiple_of) * multiple_of


@dataclass
class FleetArrays:
    """Structure-of-arrays view of the fleet. ``names[i]`` maps row i back to
    the node; rows >= len(names) are padding (valid=False)."""

    names: list[str]
    # [N] node-level
    node_valid: np.ndarray        # bool
    generation_rank: np.ndarray   # int32
    in_slice: np.ndarray          # bool (host belongs to a multi-host ICI slice)
    fresh: np.ndarray             # bool
    host_ok: np.ndarray           # bool: Node-object admission (not cordoned;
                                  # per-pod taint/toleration results override
                                  # this via the dyn vector at evaluation time)
    last_updated: np.ndarray      # float64 unix (for dynamic re-freshness)
    reserved_chips: np.ndarray    # int32 (chips held by in-flight pods)
    claimed_hbm_mib: np.ndarray   # int32 (HBM claimed by placed pods' labels)
    ext_chips: np.ndarray         # int32 (hardware-read used chips with no
                                  # running pod behind them — external
                                  # tenants; absorb no reservation, earn no
                                  # stale-freed credit)
    # [N, C] chip-level
    chip_valid: np.ndarray        # bool (false for padding columns)
    chip_healthy: np.ndarray      # bool
    chip_used: np.ndarray         # bool (byte-exact hbm_free < hbm_total)
    hbm_free_mib: np.ndarray      # int32
    hbm_total_mib: np.ndarray     # int32
    clock_mhz: np.ndarray         # int32
    hbm_bandwidth: np.ndarray     # int32
    tflops: np.ndarray            # int32
    power_w: np.ndarray           # int32

    @property
    def n_nodes(self) -> int:
        return len(self.names)

    def _apparently_used(self) -> np.ndarray:
        """Per-node count of healthy chips whose metrics show consumption
        (kernel_impl's apparently_used, host-side)."""
        return np.sum(self.chip_healthy & self.chip_used, axis=1).astype(np.int32)

    def _neutral_reserved(self) -> np.ndarray:
        """The reserved_chips pin that makes BOTH reservation corrections
        vanish when no accounting source exists: metrics-visible usage
        minus the external-tenant chips (kernel_impl: absorbable usage).
        Pinning to raw apparently_used would leave invisible == ext_chips
        and double-subtract externally-used chips (already outside
        ``unused``). :meth:`_neutral_reserved_row` is the per-row form
        (incremental updates) — one formula, two shapes."""
        return np.clip(self._apparently_used() - self.ext_chips, 0, None).astype(
            np.int32
        )

    def _neutral_reserved_row(self, i: int) -> int:
        """Row form of :meth:`_neutral_reserved` for fill_row's O(C)
        incremental path."""
        used = int(np.sum(self.chip_healthy[i] & self.chip_used[i]))
        return max(used - int(self.ext_chips[i]), 0)

    @property
    def padded_shape(self) -> tuple[int, int]:
        return self.chip_valid.shape

    @classmethod
    def from_numpy(cls, fields: "dict[str, np.ndarray]") -> "FleetArrays":
        """A fleet from another implementation's state as numpy arrays —
        every field of this dataclass keyed by name (``names`` a list of
        node names). Arrays are copied, with the dtypes this class keeps."""
        out: dict = {"names": list(fields["names"])}
        for f in dataclasses.fields(cls):
            if f.name == "names":
                continue
            out[f.name] = np.array(fields[f.name], dtype=_DTYPES.get(f.name, np.int32))
        return cls(**out)

    @classmethod
    def from_snapshot(
        cls,
        snapshot: Snapshot,
        *,
        reserved_fn: Callable[[str], int] | None = None,
        max_metrics_age_s: float = 0.0,
        now: float | None = None,
        node_bucket: int | None = None,
        chip_bucket: int | None = None,
    ) -> "FleetArrays":
        """Lower a snapshot. ``reserved_fn`` supplies in-flight reservations
        (accounting plugin); ``max_metrics_age_s`` > 0 marks stale nodes
        unfresh (0 = staleness checking disabled, every node fresh)."""
        import time as _time

        infos = snapshot.infos()
        names = [ni.name for ni in infos]
        max_chips = max((ni.tpu.chip_count for ni in infos if ni.tpu), default=0)
        n_pad = node_bucket or _bucket(max(len(names), 1), _MIN_NODE_BUCKET)
        c_pad = chip_bucket or _bucket(max(max_chips, 1), _MIN_CHIP_BUCKET)
        if n_pad < len(names) or c_pad < max_chips:
            raise ValueError(
                f"bucket ({n_pad},{c_pad}) too small for fleet "
                f"({len(names)} nodes, {max_chips} chips)"
            )

        node_valid = np.zeros(n_pad, dtype=bool)
        gen = np.zeros(n_pad, dtype=np.int32)
        in_slice = np.zeros(n_pad, dtype=bool)
        fresh = np.zeros(n_pad, dtype=bool)
        host_ok = np.zeros(n_pad, dtype=bool)
        last_updated = np.zeros(n_pad, dtype=np.float64)
        reserved = np.zeros(n_pad, dtype=np.int32)
        claimed = np.zeros(n_pad, dtype=np.int32)
        ext_chips = np.zeros(n_pad, dtype=np.int32)
        chip_valid = np.zeros((n_pad, c_pad), dtype=bool)
        healthy = np.zeros((n_pad, c_pad), dtype=bool)
        chip_used = np.zeros((n_pad, c_pad), dtype=bool)
        hbm_free = np.zeros((n_pad, c_pad), dtype=np.int32)
        hbm_total = np.zeros((n_pad, c_pad), dtype=np.int32)
        clock = np.zeros((n_pad, c_pad), dtype=np.int32)
        bw = np.zeros((n_pad, c_pad), dtype=np.int32)
        tflops = np.zeros((n_pad, c_pad), dtype=np.int32)
        power = np.zeros((n_pad, c_pad), dtype=np.int32)

        now = _time.time() if now is None else now
        arrays = cls(
            names=names,
            node_valid=node_valid,
            generation_rank=gen,
            in_slice=in_slice,
            fresh=fresh,
            host_ok=host_ok,
            last_updated=last_updated,
            reserved_chips=reserved,
            claimed_hbm_mib=claimed,
            ext_chips=ext_chips,
            chip_valid=chip_valid,
            chip_healthy=healthy,
            chip_used=chip_used,
            hbm_free_mib=hbm_free,
            hbm_total_mib=hbm_total,
            clock_mhz=clock,
            hbm_bandwidth=bw,
            tflops=tflops,
            power_w=power,
        )
        for i, ni in enumerate(infos):
            arrays.fill_row(
                i,
                ni,
                max_metrics_age_s=max_metrics_age_s,
                now=now,
                reserved_fn=reserved_fn,
            )
        return arrays

    def fill_row(
        self,
        i: int,
        ni,
        *,
        max_metrics_age_s: float = 0.0,
        now: float | None = None,
        reserved_fn: Callable[[str], int] | None = None,
    ) -> None:
        """(Re)compute row ``i`` from a NodeInfo in place — the per-node
        half of :meth:`from_snapshot`, also used for INCREMENTAL updates
        when one node's CR changed (a single agent refresh must not cost a
        full O(N x C) fleet rebuild; plugins/yoda/batch.py
        ``_refresh_static``). Chip columns are zeroed first so a CR that
        SHRANK (fewer chips) leaves no stale columns behind."""
        import time as _time

        c_pad = self.chip_valid.shape[1]
        for grid in (
            self.chip_valid, self.chip_healthy, self.chip_used,
            self.hbm_free_mib, self.hbm_total_mib, self.clock_mhz,
            self.hbm_bandwidth, self.tflops, self.power_w,
        ):
            grid[i] = 0
        tpu = ni.tpu
        if tpu is None:
            self.node_valid[i] = False  # never feasible
            return
        now = _time.time() if now is None else now
        self.node_valid[i] = True
        # No-pod-context default: cordon only. Taint/toleration admission
        # is per pod and arrives via the dyn vector (dyn_packed host_ok).
        self.host_ok[i] = ni.node is None or not ni.node.unschedulable
        self.generation_rank[i] = tpu.generation_rank
        self.in_slice[i] = bool(tpu.slice_id)
        self.last_updated[i] = tpu.last_updated_unix
        self.fresh[i] = (
            True
            if max_metrics_age_s <= 0
            else tpu.fresh(max_age_s=max_metrics_age_s, now=now)
        )
        self.claimed_hbm_mib[i] = min(
            _claimed_hbm_mib(ni), np.iinfo(np.int32).max
        )
        self.ext_chips[i] = max(int(tpu.external_used_chips), 0)
        for j, chip in enumerate(tpu.chips[:c_pad]):
            self.chip_valid[i, j] = True
            self.chip_healthy[i, j] = chip.healthy
            self.chip_used[i, j] = chip.hbm_free < chip.hbm_total
            self.hbm_free_mib[i, j] = chip.hbm_free // MIB
            self.hbm_total_mib[i, j] = chip.hbm_total // MIB
            self.clock_mhz[i, j] = chip.clock_mhz
            self.hbm_bandwidth[i, j] = chip.hbm_bandwidth_gbps
            self.tflops[i, j] = chip.tflops_bf16
            self.power_w[i, j] = chip.power_w
        if reserved_fn is not None:
            self.reserved_chips[i] = reserved_fn(ni.name)
        else:
            # No accounting: pin reserved to the absorbable usage so the
            # kernel's invisible-reservation and stale-freed corrections
            # both vanish (kernel_impl comment).
            self.reserved_chips[i] = self._neutral_reserved_row(i)

    def with_dynamic(
        self,
        reserved_fn: Callable[[str], int] | None,
        claimed_fn: Callable[[str], int] | None = None,
        *,
        max_metrics_age_s: float = 0.0,
        now: float | None = None,
        host_ok: np.ndarray | None = None,
    ) -> "FleetArrays":
        """Cheap per-cycle refresh of the per-node reservation/claim/freshness
        vectors (the [N, C] chip metrics are reused between metrics updates,
        so pod binds cost O(N), not O(N x C)). Freshness is re-evaluated
        against the CURRENT time so a node whose agent stops publishing goes
        stale even while the cached arrays are reused. ``host_ok`` overrides
        the static cordon-only admission vector with a per-pod one."""
        import time as _time

        out = dict(vars(self))
        if host_ok is not None:
            out["host_ok"] = host_ok
        if reserved_fn is not None:
            reserved = np.zeros_like(self.reserved_chips)
            for i, name in enumerate(self.names):
                reserved[i] = reserved_fn(name)
        else:
            # No accounting source: pin reserved to the absorbable usage
            # so the kernel's invisible-reservation AND stale-freed
            # corrections both vanish (a fully-occupied node must not look
            # free just because nothing claims it — kernel_impl comment).
            reserved = self._neutral_reserved()
        out["reserved_chips"] = reserved
        if claimed_fn is not None:
            claimed = np.zeros_like(self.claimed_hbm_mib)
            for i, name in enumerate(self.names):
                claimed[i] = claimed_fn(name)
            out["claimed_hbm_mib"] = claimed
        if max_metrics_age_s > 0:
            now = _time.time() if now is None else now
            out["fresh"] = (now - self.last_updated) <= max_metrics_age_s
        return FleetArrays(**out)

    def dyn_packed(
        self,
        reserved_fn: Callable[[str], int] | None,
        claimed_fn: Callable[[str], int] | None = None,
        *,
        max_metrics_age_s: float = 0.0,
        now: float | None = None,
        host_ok: np.ndarray | None = None,
        last_updated: "Mapping[str, float] | None" = None,
    ) -> np.ndarray:
        """The per-cycle node vectors as ONE [4, N] int32 array (rows =
        ops.kernel.DYN_KEYS: fresh, reserved_chips, claimed_hbm_mib,
        host_ok) for the device-resident kernel — same semantics as
        :meth:`with_dynamic`, packed so a scheduling cycle uploads a single
        array. ``host_ok`` carries the per-pod Node-object admission
        (cordon + taints vs THIS pod's tolerations); default: the static
        cordon-only view.

        ``reserved_fn`` / ``claimed_fn`` may each be a per-node callable OR
        a ``{node: value}`` Mapping — the mapping form lets callers take
        ONE consistent snapshot of the accountant under one lock
        (ChipAccountant.chips_by_node) instead of N locked calls per
        dispatch, which dominates the kernel itself at large fleets."""
        import time as _time
        from typing import Mapping as _Mapping

        n = self.node_valid.shape[0]
        dyn = np.zeros((4, n), dtype=np.int32)
        if max_metrics_age_s > 0:
            now = _time.time() if now is None else now
            if last_updated is not None:
                # Live timestamps (InformerCache.last_updated_map): the
                # baked self.last_updated goes stale when heartbeat
                # republishes deliberately skip the metrics-version bump.
                # One vectorized compare — no per-node scalar stores.
                get = last_updated.get
                n_real = len(self.names)
                ts = np.fromiter(
                    (get(name, 0.0) for name in self.names),
                    np.float64,
                    n_real,
                )
                dyn[0, :n_real] = (now - ts) <= max_metrics_age_s
            else:
                dyn[0] = (now - self.last_updated) <= max_metrics_age_s
        else:
            dyn[0] = self.fresh
        if reserved_fn is not None:
            if isinstance(reserved_fn, _Mapping):
                get = reserved_fn.get
                for i, name in enumerate(self.names):
                    dyn[1, i] = get(name, 0)
            else:
                for i, name in enumerate(self.names):
                    dyn[1, i] = reserved_fn(name)
        else:
            # No accounting: neutralize both reservation corrections (see
            # with_dynamic).
            dyn[1] = self._neutral_reserved()
        cap = np.iinfo(np.int32).max
        if claimed_fn is not None:
            if isinstance(claimed_fn, _Mapping):
                get = claimed_fn.get
                for i, name in enumerate(self.names):
                    dyn[2, i] = min(get(name, 0), cap)
            else:
                for i, name in enumerate(self.names):
                    dyn[2, i] = min(claimed_fn(name), cap)
        else:
            dyn[2] = self.claimed_hbm_mib
        dyn[3] = self.host_ok if host_ok is None else host_ok
        return dyn


def _claimed_hbm_mib(ni) -> int:
    """HBM claimed by pods already placed on the node (reference
    CalculateAllocateScore input, pkg/yoda/score/algorithm.go:77-80)."""
    from yoda_tpu_torch.api.requests import LabelParseError, pod_request

    total = 0
    for pod in ni.pods:
        try:
            r = pod_request(pod)
        except LabelParseError:
            continue
        total += (r.hbm_per_chip // MIB) * r.effective_chips
    return total
