"""The node-sharded fleet evaluation: contiguous row blocks of the resident
fleet state over a list of torch devices, driven from one process.

Counterpart of ``yoda_tpu/parallel/sharded.py``. The reference declares
row shardings on one jitted program and lets XLA insert the collectives
for the evaluation's global reductions. Here the three reductions are
explicit: each evaluation runs the phases of the fleet evaluation over
every shard with the hand kernel's shard entry (ops/cuda_kernel.py
``fleet_eval_shard``; its plain version on CPU tensors), and between the
phases small torch ops on the first device combine the shards' partials,
a few int32 values per shard and request:

1. feasibility, reasons and claimable; the six maxima of the feasible
   nodes' qualifying chips -> cross-shard MAX (floored at 1 by phase 2);
2. raw scores against those maxima; each shard's lowest and highest
   feasible raw score (fillers INT32_MAX / -INT32_MAX) and whether any row
   is feasible -> MIN, MAX, OR, then the all-equal guard gives (lowest,
   span);
3. final scores; each shard's best row -> the largest (final, global row)
   (ties to the later row), -1 when nothing is feasible, broadcast into
   every shard's best row.

Every output row equals the single-device evaluation's bit for bit.

The mesh is a list of devices: :func:`default_mesh` takes the first N
CUDA cards, or N of the :data:`HOST_DEVICES` host shards when the platform
is "cpu" (the reference's tests run on 8 virtual host devices). The kernel
classes also take an explicit list, which may repeat one device: a
harness affordance that splits one card's evaluation into several shards
(``chip_smoke.py`` holds a 4-shard split of one H100 against the unsharded
kernel); a deployment's mesh names each card once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from yoda_tpu_torch.config import Weights
from yoda_tpu_torch.ops.arrays import FleetArrays
from yoda_tpu_torch.ops.cuda_kernel import SHARD_PARTIAL_WORDS, fleet_eval_shard
from yoda_tpu_torch.ops.kernel import (
    INT32_MIN,
    KernelRequest,
    KernelResult,
    apply_row_update,
    download,
    evaluate_joint_plan_via_burst,
    evaluate_joint_via_burst,
    inputs_size,
    minmax_span,
    own_dyn,
    pack_inputs,
    pack_request,
    pack_row_update,
    resolve_device,
    results_from_packed,
    row_update_size,
    split_inputs,
    stack_static,
    upload,
)

# Host shards available under kernel_platform "cpu": the reference's tests
# run on 8 virtual host devices (tests/conftest.py), so the port offers as
# many.
HOST_DEVICES = 8


def _check_divisible(n_pad: int, shards: int) -> None:
    if n_pad % shards:
        raise ValueError(
            f"fleet bucket {n_pad} rows not divisible by {shards} mesh "
            f"devices; pass node_bucket a multiple of the mesh size "
            f"(ops.arrays.bucket_rows)"
        )


def default_mesh(
    n_devices: int | None = None, platform: str = "auto"
) -> list[torch.device]:
    """The first ``n_devices`` devices of ``platform`` (all by default): CUDA
    cards for "auto" / "device" (raising without one, as
    ``ops.kernel.resolve_device`` does), host shards for "cpu". Raises when
    fewer devices exist than requested (silent truncation would quietly run
    an n-way workload on fewer shards)."""
    if resolve_device(platform).type == "cpu":
        devs = [torch.device("cpu")] * HOST_DEVICES
    else:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devs)} devices are available"
            )
        devs = devs[:n_devices]
    return devs


class ShardedDeviceFleetKernel:
    """Mesh-sharded evaluator with device-resident fleet state: the
    ``TorchFleetKernel`` protocol (``put_static`` once per metrics version,
    ``update_rows`` for changed rows, ``evaluate`` / ``evaluate_burst``
    per cycle) over ``mesh``, each device holding a contiguous row block of
    the [9, C, N] chip grids and [4, N] static node rows. Selected by
    ``SchedulerConfig(mesh_devices=N)`` (plugins/yoda/batch.py); the fleet
    bucket must be a multiple of the mesh size (ops.arrays.bucket_rows).

    ``shard_launches`` and ``row_updates`` count the CUDA work this object
    issued (the shard entry's launches, the row updates on the card)."""

    def __init__(
        self, weights: Weights, mesh: "list[torch.device] | None" = None
    ) -> None:
        self.weights = weights
        self.mesh = [torch.device(d) for d in (mesh or default_mesh())]
        self.device = self.mesh[0]
        self._chips: "list[torch.Tensor] | None" = None
        self._nodes: "list[torch.Tensor]" = []
        self._names: list[str] = []
        self._rows = 0  # rows per shard
        self.shard_launches = 0
        self.row_updates = 0

    @property
    def names(self) -> list[str]:
        return self._names

    def n_shards(self) -> int:
        return len(self.mesh)

    def put_static(self, arrays: FleetArrays) -> None:
        """Split the metrics-version-static arrays into row blocks, one per
        device."""
        n_pad, _ = arrays.padded_shape
        _check_divisible(n_pad, self.n_shards())
        chips, nodes = stack_static(arrays)
        self._rows = rows = n_pad // self.n_shards()
        self._chips = [
            torch.from_numpy(np.ascontiguousarray(chips[:, :, s * rows : (s + 1) * rows]))
            .to(dev)
            for s, dev in enumerate(self.mesh)
        ]
        self._nodes = [
            torch.from_numpy(np.ascontiguousarray(nodes[:, s * rows : (s + 1) * rows]))
            .to(dev)
            for s, dev in enumerate(self.mesh)
        ]
        self._names = list(arrays.names)

    def update_rows(self, arrays: FleetArrays, rows: "list[int]") -> None:
        """Apply only the given (already refilled, distinct) rows to the
        shards that hold them, in place: per touched shard one pinned copy
        of its rows' payload with local indices and ``apply_row_update``
        (see ``TorchFleetKernel.update_rows`` for the contract)."""
        if self._chips is None:
            self.put_static(arrays)
            return
        by_shard: "dict[int, list[int]]" = {}
        for r in rows:
            by_shard.setdefault(r // self._rows, []).append(r)
        c = self._chips[0].shape[1]
        for s, shard_rows in sorted(by_shard.items()):
            r = len(shard_rows)
            dev = self.mesh[s]

            def fill(buf, shard_rows=shard_rows, lo=s * self._rows):
                pack_row_update(arrays, shard_rows, out=buf)
                buf[: len(shard_rows)] -= lo  # local row indices

            payload = upload(dev, row_update_size(r, c), fill)
            apply_row_update(self._chips[s], self._nodes[s], payload, r)
            if dev.type == "cuda":
                self.row_updates += 1

    def evaluate(self, dyn: np.ndarray, request: KernelRequest) -> KernelResult:
        """One request; its admission row is ``dyn[3]`` (K = 1 of the burst)."""
        dyn = np.asarray(dyn, dtype=np.int32)
        return self.evaluate_burst(dyn, dyn[3:4], [request])[0]

    def evaluate_burst(
        self,
        dyn: np.ndarray,            # [4, N] int32 (row 3 unused)
        host_ok_k: np.ndarray,      # [K, N] per-pod admission
        requests: "list[KernelRequest]",
    ) -> list[KernelResult]:
        """K requests in one sharded evaluation: per shard one upload of its
        columns of the dynamics and admission rows (and the requests), the
        three phases with the combines between them (:meth:`run_phases`),
        and one download of its [K, 6, n] rows, concatenated in row
        order."""
        if self._chips is None:
            raise RuntimeError("put_static() must run before evaluate_burst()")
        outs = self.run_phases(self.stage(dyn, host_ok_k, requests), len(requests))
        packed = np.concatenate([download(out) for out in outs], axis=2)
        return results_from_packed(self._names, packed)

    def stage(
        self,
        dyn: np.ndarray,
        host_ok_k: np.ndarray,
        requests: "list[KernelRequest]",
    ) -> "list[tuple[torch.Tensor, ...]]":
        """Each shard's per-call inputs on its device: one upload of its
        columns of ``dyn`` and ``host_ok_k`` and of the requests, as
        (dyn [4, n], host_ok [K, n], reqs [K, 5]) views."""
        reqs = np.stack([pack_request(r) for r in requests])
        host_ok_k = np.asarray(host_ok_k)
        k, n = len(requests), self._rows
        staged = []
        for s, dev in enumerate(self.mesh):
            cols = slice(s * n, (s + 1) * n)
            buf = upload(
                dev, inputs_size(n, k),
                lambda b, cols=cols: pack_inputs(dyn[:, cols], host_ok_k[:, cols], reqs, out=b),
            )
            staged.append(split_inputs(buf, n, k))
        return staged

    def run_phases(
        self, staged: "list[tuple[torch.Tensor, ...]]", k: int
    ) -> "list[torch.Tensor]":
        """The three phases over every shard and the combines between them,
        on the devices, for :meth:`stage`'s inputs: each shard's [K, 6, n]
        output rows (the best row broadcast into row 4)."""
        n = self._rows
        outs = [
            torch.empty((k, 6, n), dtype=torch.int32, device=dev) for dev in self.mesh
        ]
        globals_ = [None] * self.n_shards()
        for phase in (1, 2, 3):
            parts = []
            for s, dev in enumerate(self.mesh):
                part = torch.empty(
                    (k, SHARD_PARTIAL_WORDS[phase]), dtype=torch.int32, device=dev
                )
                fleet_eval_shard(
                    self._chips[s], self._nodes[s], *staged[s], phase, globals_[s],
                    outs[s], part, self.weights, counter=self,
                )
                parts.append(part.to(self.device))
            stacked = torch.stack(parts)                 # [S, K, words]
            if phase == 1:
                combined = stacked.amax(dim=0)           # [K, 6] maxima
            elif phase == 2:
                lowest, span = minmax_span(
                    stacked[:, :, 0].amin(dim=0)[:, None],
                    stacked[:, :, 1].amax(dim=0)[:, None],
                )
                any_feasible = stacked[:, :, 2].amax(dim=0) != 0
                combined = torch.cat([lowest, span], dim=1)  # [K, 2]
            else:
                best = _best_of(stacked, n, any_feasible)
            if phase < 3:
                globals_ = [combined.to(dev) for dev in self.mesh]
        for s, dev in enumerate(self.mesh):
            outs[s][:, 4] = best.to(dev)[:, None]
        return outs

    def evaluate_joint(
        self,
        dyn: np.ndarray,
        host_ok_groups: "list[np.ndarray]",
        request_groups: "list[list[KernelRequest]]",
        minimum: int = 1,
    ) -> "list[list[KernelResult]]":
        """G gangs' member rows in ONE sharded evaluation (cross-gang joint
        placement), stacked per ops.kernel.stack_joint_burst and regrouped
        per gang, so mesh mode joins the joint pass too."""
        return evaluate_joint_via_burst(
            self, dyn, host_ok_groups, request_groups, minimum
        )

    def evaluate_joint_plan(
        self,
        dyn: np.ndarray,
        host_ok_groups: "list[np.ndarray]",
        request_groups: "list[list[KernelRequest]]",
        minimum: int = 1,
    ) -> "tuple[list[list[KernelResult]], list[bool], list[np.ndarray]]":
        """Fit-gated joint pass on the mesh: member rows through the sharded
        burst, the fit scan on the host over the gathered results
        (ops.kernel.evaluate_joint_plan_via_burst), as the reference does:
        the scan is a short serial chain over rows the host already holds."""
        return evaluate_joint_plan_via_burst(
            self, dyn, host_ok_groups, request_groups, minimum
        )


def _best_of(stacked: torch.Tensor, rows: int, any_feasible: torch.Tensor) -> torch.Tensor:
    """The best row from the shards' phase-3 partials [S, K, 2] (local row,
    score ^ INT32_MIN): the largest (score, global row), -1 where no row of
    any shard is feasible. [K] int32."""
    offsets = torch.arange(
        stacked.shape[0], dtype=torch.int64, device=stacked.device
    )[:, None] * rows
    score = (stacked[:, :, 1] ^ INT32_MIN).to(torch.int64)
    key = score * (1 << 32) + stacked[:, :, 0].to(torch.int64) + offsets
    best = (key.amax(dim=0) & 0xFFFFFFFF).to(torch.int32)
    return torch.where(any_feasible, best, torch.full_like(best, -1))


@dataclass
class ShardedFleetKernel:
    """One-shot sharded evaluation of a fleet as it stands (its own fresh,
    reserved, claimed and admission rows) over ``mesh``. Use
    :func:`sharded_filter_score` for the convenience path; hold a
    :class:`ShardedDeviceFleetKernel` to evaluate many pods against one
    upload."""

    mesh: "list[torch.device]"
    weights: Weights

    def n_shards(self) -> int:
        return len(self.mesh)

    def __call__(self, arrays: FleetArrays, request: KernelRequest) -> KernelResult:
        n_pad, _ = arrays.padded_shape
        _check_divisible(n_pad, self.n_shards())
        kern = ShardedDeviceFleetKernel(self.weights, mesh=self.mesh)
        kern.put_static(arrays)
        return kern.evaluate(own_dyn(arrays), request)


def sharded_filter_score(
    arrays: FleetArrays,
    request: KernelRequest,
    *,
    mesh: "list[torch.device] | None" = None,
    weights: Weights | None = None,
) -> KernelResult:
    """One-shot sharded evaluation (builds the kernel; prefer holding a
    :class:`ShardedDeviceFleetKernel` across pods)."""
    kern = ShardedFleetKernel(mesh or default_mesh(), weights or Weights())
    return kern(arrays, request)
