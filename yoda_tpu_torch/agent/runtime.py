"""Runtime hardware reader: real per-chip TPU values for the node agent.

The reference's metric source was a sniffer DaemonSet reading live GPU
hardware state per card (reference readme.md:9-15 — health, FreeMemory,
Clock feeding pkg/yoda/filter/filter.go:52-58). This is the TPU-native
equivalent: when a live TPU runtime is present on the node, the agent reads
the hardware through it instead of fabricating values from a spec table.

What is genuinely hardware-read depends on what the runtime exposes:

- **Always real when devices enumerate:** device identity
  (``device_kind`` → generation), chip count, and per-chip topology
  coordinates (``device.coords``).
- **Real where the PJRT transport exposes it:** HBM total/free via
  ``device.memory_stats()`` (``bytes_limit`` / ``bytes_in_use``) — live on
  TPU VMs; some transports (e.g. a remote tunnel) return ``None``, in which
  case HBM falls back to the generation spec table.

The CR's ``source`` field records which of these fired, so an operator (and
the scheduler's tests) can tell hardware-read values from table fallbacks:
``jax-runtime+memstats`` vs ``jax-runtime+spec-hbm``.

The agent keeps publishing (via the native library / spec table) on hosts
where no Python TPU runtime exists.

Counterpart of ``yoda_tpu/agent/runtime.py``, whole, with one difference:
the port reads no TPU runtime, so the default device source
:func:`probe_devices` finds none and returns ``[]`` — the reference's own
result on a host without one. Every reading function takes its device
source as an argument (``--runtime-probe`` wires the default; tests inject
device stand-ins with ``device_kind``, ``coords`` and ``memory_stats()``),
and the ``source`` strings it stamps (``jax-runtime+memstats`` /
``jax-runtime+spec-hbm``) are the reference's byte for byte: they travel
in the CR.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from yoda_tpu_torch.api.types import HEALTHY, TpuChip, TpuNodeMetrics

# PJRT device_kind strings -> the generation vocabulary the label API uses
# (api/requests.py GENERATION_RANK). Real kinds observed on TPU VMs.
GENERATION_BY_KIND = {
    "TPU v4": "v4",
    "TPU v5 lite": "v5e",
    "TPU v5e": "v5e",
    "TPU v5": "v5p",
    "TPU v5p": "v5p",
    "TPU v6 lite": "v6e",
    "TPU v6e": "v6e",
}


@dataclass
class RuntimeChip:
    index: int
    hbm_total: int | None   # bytes; None = runtime does not expose it
    hbm_free: int | None


@dataclass
class RuntimeReading:
    device_kind: str
    generation: str | None  # None: unknown kind (CR keeps the native value)
    coords: tuple[int, int, int]
    chips: list[RuntimeChip]
    source: str             # "jax-runtime+memstats" | "jax-runtime+spec-hbm"

    @property
    def has_real_hbm(self) -> bool:
        return any(c.hbm_total is not None for c in self.chips)


def probe_devices() -> list:
    """The default device source: live local TPU devices. This package
    reads no TPU runtime, so there are none: ``[]``, what the reference
    returns when no runtime or TPU is present."""
    return []


def read_runtime(devices_fn=probe_devices) -> RuntimeReading | None:
    """One hardware read through the live runtime; None when no TPU devices
    enumerate."""
    devs = devices_fn()
    if not devs:
        return None
    kind = str(getattr(devs[0], "device_kind", ""))
    chips: list[RuntimeChip] = []
    any_mem = False
    for i, d in enumerate(devs):
        try:
            stats = d.memory_stats()
        except Exception:  # noqa: BLE001 — transport-dependent
            stats = None
        total = free = None
        if stats and stats.get("bytes_limit"):
            total = int(stats["bytes_limit"])
            free = max(total - int(stats.get("bytes_in_use", 0)), 0)
            any_mem = True
        chips.append(RuntimeChip(index=i, hbm_total=total, hbm_free=free))
    coords = tuple(getattr(devs[0], "coords", None) or (0, 0, 0))[:3]
    return RuntimeReading(
        device_kind=kind,
        generation=GENERATION_BY_KIND.get(kind),
        coords=coords,  # type: ignore[arg-type]
        chips=chips,
        source="jax-runtime+memstats" if any_mem else "jax-runtime+spec-hbm",
    )


def probe_hbm_sources(devices_fn=probe_devices, *, libtpu_addr=None) -> list[dict]:
    """Try every known HBM-counter source on THIS host and report what each
    returned: the hardware-read story for the metric the scheduler filters
    on is evidenced — a value, or the enumerated reasons none is
    reachable. Sources, in preference order:

    1. PJRT ``device.memory_stats()`` — live on TPU VMs; remote transports
       return None.
    2. The libtpu runtime-metrics gRPC endpoint (localhost:8431 — what
       ``tpu-info`` reads), queried with the typed client
       (`agent/tpu_metrics.py` ``query_hbm``): a real unary
       ``GetRuntimeMetric`` call for HBM total/usage, reporting per-chip
       values on success or the typed transport/codec failure.
    3. Local accelerator device files (``/dev/accel*``, ``/dev/vfio``) —
       the native library's domain; they carry no memory counters but
       their absence explains why the native path reports none.
    """
    import glob

    report: list[dict] = []
    devs = devices_fn()
    if not devs:
        report.append(
            {"source": "pjrt.memory_stats", "status": "no TPU devices enumerate"}
        )
    else:
        got = none = err = 0
        ok_sample = err_sample = None
        for d in devs:
            try:
                stats = d.memory_stats()
            except Exception as e:  # noqa: BLE001 — transport-dependent
                err += 1
                err_sample = err_sample or f"{type(e).__name__}: {e}"
                continue
            if stats and stats.get("bytes_limit"):
                got += 1
                ok_sample = ok_sample or f"bytes_limit={stats['bytes_limit']}"
            else:
                none += 1
        report.append(
            {
                "source": "pjrt.memory_stats",
                "status": (
                    f"{got}/{len(devs)} devices exposed counters"
                    f" ({ok_sample})" if got
                    else f"returned None on {none} device(s), raised on "
                    f"{err} ({err_sample or 'transport exposes no stats'})"
                ),
            }
        )
    from yoda_tpu_torch.agent import tpu_metrics as tm

    addr = libtpu_addr or tm.DEFAULT_ADDR
    try:
        hbm = tm.query_hbm(addr, timeout_s=1.0)
        sample = {
            i: {"total": t, "used": u} for i, (t, u) in sorted(hbm.per_chip.items())
        }
        report.append(
            {
                "source": f"libtpu-metrics-grpc:{hbm.endpoint}",
                "status": f"typed GetRuntimeMetric read {len(hbm.per_chip)} "
                f"chip(s): {sample}",
            }
        )
    except tm.LibtpuMetricsUnavailable as e:
        report.append(
            {
                "source": f"libtpu-metrics-grpc:{addr}",
                "status": f"typed GetRuntimeMetric query attempted: {e}",
            }
        )
    accels = glob.glob("/dev/accel*") + glob.glob("/dev/vfio/*")
    report.append(
        {
            "source": "device-files",
            "status": (
                f"present: {sorted(accels)[:4]} (no memory counters there; "
                "identity only)" if accels
                else "no /dev/accel* or /dev/vfio nodes (TPU is remote or "
                "absent)"
            ),
        }
    )
    return report


def metrics_from_runtime(
    node_name: str,
    reading: RuntimeReading,
    *,
    now_fn=time.time,
    slice_id: str = "",
) -> TpuNodeMetrics:
    """Build a CR from a runtime reading alone (no native library): real
    identity/count/coords (+ HBM when exposed), spec-table values for the
    static chip characteristics the runtime has no counters for."""
    from yoda_tpu_torch.agent.fake_publisher import CHIP_SPECS, GIB

    generation = reading.generation or "v5e"
    spec = CHIP_SPECS[generation]
    chips = []
    for rc in reading.chips:
        total = rc.hbm_total if rc.hbm_total is not None else spec.hbm_gib * GIB
        free = rc.hbm_free if rc.hbm_free is not None else total
        chips.append(
            TpuChip(
                index=rc.index,
                health=HEALTHY,  # it enumerated and answered: responsive
                hbm_free=free,
                hbm_total=total,
                clock_mhz=spec.clock_mhz,
                hbm_bandwidth_gbps=spec.hbm_bandwidth_gbps,
                tflops_bf16=spec.tflops_bf16,
                power_w=spec.power_w,
                hw_read=rc.hbm_total is not None,
            )
        )
    return TpuNodeMetrics(
        name=node_name,
        generation=generation,
        accel_type=f"{generation}-{len(chips)}",
        slice_id=slice_id,
        topology_coords=reading.coords,
        last_updated_unix=now_fn(),
        chips=chips,
        source=reading.source,
    )


def overlay_runtime(tpu: TpuNodeMetrics, reading: RuntimeReading) -> None:
    """Overlay runtime-read values onto a natively-collected CR in place:
    the runtime's device identity and (when exposed) HBM counters are
    authoritative over the native library's env/spec-derived values; the
    native slice identity and GKE-env coords are kept (richer than what a
    single-host runtime view knows)."""
    if reading.generation is not None and reading.generation != tpu.generation:
        # device_kind is authoritative; keep accel_type consistent with it
        # (a CR claiming generation v5e with accel_type "v5p-2" would
        # mislead anything keying on either field).
        tpu.generation = reading.generation
        tpu.accel_type = f"{reading.generation}-{len(tpu.chips)}"
    by_index = {rc.index: rc for rc in reading.chips}
    for chip in tpu.chips:
        rc = by_index.get(chip.index)
        if rc is not None and rc.hbm_total is not None:
            chip.hbm_total = rc.hbm_total
            chip.hbm_free = rc.hbm_free if rc.hbm_free is not None else rc.hbm_total
            chip.hw_read = True
    tpu.source = (
        f"{tpu.source}+{reading.source}" if tpu.source else reading.source
    )


def overlay_libtpu(tpu: TpuNodeMetrics, hbm) -> frozenset[int]:
    """Overlay a libtpu-metrics-service HBM read (`agent/tpu_metrics.py`
    ``LibtpuHbm``) onto a CR in place; returns the chip indices that now
    carry hardware-read occupancy (so the agent skips label attribution for
    them — they already reflect actual usage, the reference's
    Scv.Status.CardList[].FreeMemory semantics).

    Applied AFTER any PJRT overlay: the gRPC service is served by the
    process that owns the TPU, so its usage numbers see *all* tenants'
    allocations where PJRT ``memory_stats`` sees only this process's —
    when both answer, the service's view is the schedulable truth.
    """
    covered = set()
    for chip in tpu.chips:
        pair = hbm.per_chip.get(chip.index)
        if pair is None:
            continue
        total, used = pair
        chip.hbm_total = total
        chip.hbm_free = max(total - used, 0)
        chip.hw_read = True
        duty = hbm.duty_cycle_pct.get(chip.index)
        if duty is not None:
            chip.duty_cycle_pct = float(duty)
        covered.add(chip.index)
    if covered:
        tpu.source = (
            f"{tpu.source}+libtpu-grpc" if tpu.source else "libtpu-grpc"
        )
    return frozenset(covered)
