"""Typed client for the libtpu runtime-metrics gRPC service.

The reference's metrics source read *live* GPU counters per card (reference
readme.md:9-15; consumed at pkg/yoda/filter/filter.go:22-58 and
pkg/yoda/score/algorithm.go:72). On a TPU VM the analogous live counters —
per-chip HBM total/usage — are served by libtpu's runtime metrics gRPC
service on localhost:8431, the same endpoint the public ``tpu-info`` tool
reads. Crucially this service is served by whichever process *owns* the TPU,
so a node agent can read real HBM occupancy even when it cannot initialize
the devices itself (the case PJRT ``memory_stats()`` can never cover).

This module is a minimal typed client for that service:

- the transport is real gRPC (grpcio, baked into the image), unary call
  ``/tpu.monitoring.runtime.RuntimeMetricService/GetRuntimeMetric``;
- the message layer is a hand-rolled protobuf wire codec for the small
  surface of ``tpu_metric_service.proto`` (the public proto shipped with
  tpu-info in google/cloud-accelerator-diagnostics), reconstructed offline:

      message MetricRequest  { string metric_name = 1; }
      message MetricResponse { TPUMetric metric = 1; }
      message TPUMetric      { string name = 1; repeated Metric metrics = 2; }
      message Metric         { Attribute attribute = 1; Gauge gauge = 2; }
      message Attribute      { string key = 1; AttrValue value = 2; }
      message AttrValue      { oneof attr { int64 int_attr = 1;
                                            string string_attr = 2; } }
      message Gauge          { oneof value { int64 as_int = 1;
                                             double as_double = 2; } }

  The decoder is deliberately tolerant: unknown fields are skipped, a gauge
  accepts either oneof arm, and any parse failure degrades to "no reading"
  rather than an exception — if the deployed proto revision moved a field,
  the agent falls back to spec-table HBM exactly as when the port is closed.

The in-repo fake server for tests lives in
``yoda_tpu_torch/testing/fake_libtpu.py`` and speaks this same wire format
through the same codec's *encode* half, so client/server stay consistent by
construction.

Counterpart of ``yoda_tpu/agent/tpu_metrics.py``, whole: the same wire
bytes, so a client of either package reads a server of the other.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

# Metric names served by libtpu (the ones tpu-info displays).
METRIC_HBM_TOTAL = "tpu.runtime.hbm.memory.total.bytes"
METRIC_HBM_USAGE = "tpu.runtime.hbm.memory.usage.bytes"
METRIC_DUTY_CYCLE = "tpu.runtime.tensorcore.dutycycle.percent"

GRPC_METHOD = "/tpu.monitoring.runtime.RuntimeMetricService/GetRuntimeMetric"
DEFAULT_ADDR = "127.0.0.1:8431"

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


class LibtpuMetricsUnavailable(Exception):
    """The metrics service could not be queried; ``str(exc)`` is the typed
    reason (transport error, empty response, codec mismatch) recorded in
    the agent's source-evidence trail."""


# ---------------------------------------------------------------- wire codec


def _enc_varint(v: int) -> bytes:
    if v < 0:
        v &= (1 << 64) - 1  # int64 two's complement, 10-byte varint
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_tag(field_no: int, wt: int) -> bytes:
    return _enc_varint((field_no << 3) | wt)


def _enc_len(field_no: int, payload: bytes) -> bytes:
    return _enc_tag(field_no, _WT_LEN) + _enc_varint(len(payload)) + payload


def _enc_int(field_no: int, v: int) -> bytes:
    return _enc_tag(field_no, _WT_VARINT) + _enc_varint(v)


def _dec_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def iter_fields(data: bytes):
    """Yield (field_no, wire_type, value) over one message's wire bytes.
    value: int for varint, bytes for length-delimited and fixed widths."""
    pos = 0
    while pos < len(data):
        tag, pos = _dec_varint(data, pos)
        field_no, wt = tag >> 3, tag & 0x7
        if wt == _WT_VARINT:
            val, pos = _dec_varint(data, pos)
        elif wt == _WT_LEN:
            n, pos = _dec_varint(data, pos)
            if pos + n > len(data):
                raise ValueError("truncated length-delimited field")
            val = data[pos : pos + n]
            pos += n
        elif wt == _WT_I64:
            if pos + 8 > len(data):
                raise ValueError("truncated fixed64")
            val = data[pos : pos + 8]
            pos += 8
        elif wt == _WT_I32:
            if pos + 4 > len(data):
                raise ValueError("truncated fixed32")
            val = data[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field_no, wt, val


# ------------------------------------------------------------- message layer


def encode_metric_request(metric_name: str) -> bytes:
    return _enc_len(1, metric_name.encode())


def decode_metric_request(data: bytes) -> str:
    for field_no, wt, val in iter_fields(data):
        if field_no == 1 and wt == _WT_LEN:
            return val.decode()
    return ""


def encode_metric_response(metric_name: str, per_device: dict[int, float]) -> bytes:
    """Server half (fake server + tests): one Metric per device, the device
    id as attribute.value.int_attr, the value as gauge.as_int when integral
    else gauge.as_double."""
    metrics = b""
    for dev_id, value in sorted(per_device.items()):
        attr = _enc_len(1, b"device-id") + _enc_len(2, _enc_int(1, dev_id))
        if isinstance(value, float) and not value.is_integer():
            gauge = _enc_tag(2, _WT_I64) + struct.pack("<d", value)
        else:
            gauge = _enc_int(1, int(value))
        metrics += _enc_len(2, _enc_len(1, attr) + _enc_len(2, gauge))
    tpu_metric = _enc_len(1, metric_name.encode()) + metrics
    return _enc_len(1, tpu_metric)


def _dec_gauge(data: bytes) -> float | None:
    for field_no, wt, val in iter_fields(data):
        if field_no == 1 and wt == _WT_VARINT:
            return float(val)
        if field_no == 2 and wt == _WT_I64:
            return struct.unpack("<d", val)[0]
    return None


def _dec_attr_device(data: bytes) -> int | None:
    """Attribute -> device id: value.int_attr, any attribute key."""
    for field_no, wt, val in iter_fields(data):
        if field_no == 2 and wt == _WT_LEN:  # AttrValue
            for f2, wt2, v2 in iter_fields(val):
                if f2 == 1 and wt2 == _WT_VARINT:
                    return int(v2)
    return None


def decode_metric_response(data: bytes) -> dict[int, float]:
    """MetricResponse wire bytes -> {device_id: value}. Devices that carry
    no parsable attribute are numbered by position (single-chip responses
    in the wild often omit the attribute)."""
    out: dict[int, float] = {}
    position = 0
    for field_no, wt, val in iter_fields(data):
        if field_no != 1 or wt != _WT_LEN:
            continue
        for f2, wt2, v2 in iter_fields(val):  # TPUMetric
            if f2 != 2 or wt2 != _WT_LEN:
                continue
            dev_id = None
            gauge = None
            for f3, wt3, v3 in iter_fields(v2):  # Metric
                if f3 == 1 and wt3 == _WT_LEN:
                    dev_id = _dec_attr_device(v3)
                elif f3 == 2 and wt3 == _WT_LEN:
                    gauge = _dec_gauge(v3)
            if gauge is not None:
                out[dev_id if dev_id is not None else position] = gauge
            position += 1
    return out


# ------------------------------------------------------------------- client


@dataclass
class LibtpuHbm:
    """One successful read: per-chip (total, used) bytes, plus the optional
    tensorcore duty cycle for the observability surface."""

    per_chip: dict[int, tuple[int, int]] = field(default_factory=dict)
    duty_cycle_pct: dict[int, float] = field(default_factory=dict)
    endpoint: str = DEFAULT_ADDR

    def free(self, chip_index: int) -> int | None:
        pair = self.per_chip.get(chip_index)
        if pair is None:
            return None
        total, used = pair
        return max(total - used, 0)


def query_hbm(
    address: str = DEFAULT_ADDR,
    *,
    timeout_s: float = 1.0,
    channel=None,
    duty_cycle: bool = False,
) -> LibtpuHbm:
    """One typed read of per-chip HBM total/usage from the libtpu metrics
    service. ``duty_cycle=True`` adds a best-effort third query for the
    tensorcore duty cycle — observational only (the CR's per-chip
    ``duty_cycle_pct`` and the /metrics fleet gauge; the scheduling path
    never consumes it). The CLI agent opts in (cli.py --libtpu-metrics);
    callers that want only the scheduling inputs leave it off and save
    the RPC. Raises :class:`LibtpuMetricsUnavailable` with the typed
    reason on any failure — callers treat that as "fall back to the next
    HBM source", never as an agent error."""
    try:
        import grpc
    except Exception as e:  # noqa: BLE001 — keep the agent import-safe
        raise LibtpuMetricsUnavailable(f"grpcio unavailable: {e}") from e

    own_channel = channel is None
    if channel is None:
        channel = grpc.insecure_channel(address)
    call = channel.unary_unary(
        GRPC_METHOD,
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )
    try:
        try:
            total_wire = call(
                encode_metric_request(METRIC_HBM_TOTAL), timeout=timeout_s
            )
            usage_wire = call(
                encode_metric_request(METRIC_HBM_USAGE), timeout=timeout_s
            )
        except grpc.RpcError as e:
            code = getattr(e, "code", lambda: None)()
            detail = getattr(e, "details", lambda: "")() or ""
            raise LibtpuMetricsUnavailable(
                f"GetRuntimeMetric failed: {code} {detail}".strip()
            ) from e
        try:
            totals = decode_metric_response(total_wire)
            usages = decode_metric_response(usage_wire)
        except ValueError as e:
            raise LibtpuMetricsUnavailable(f"response codec mismatch: {e}") from e
        if not totals:
            raise LibtpuMetricsUnavailable(
                "service answered but reported no HBM devices"
            )
        reading = LibtpuHbm(endpoint=address)
        # A device present in totals but absent from the usage response is
        # NOT covered: defaulting its usage to 0 would publish an occupied
        # chip as fully free WITH hardware-read authority (and the agent
        # would skip label attribution on top). Drop it — the chip falls
        # back to spec-table + accounting like any unqueried chip.
        for dev, total in totals.items():
            if dev in usages:
                reading.per_chip[dev] = (int(total), int(usages[dev]))
        if not reading.per_chip:
            raise LibtpuMetricsUnavailable(
                "usage response covered none of the reported HBM devices"
            )
        if duty_cycle:
            try:  # best-effort; absence must not discard the HBM read
                duty_wire = call(
                    encode_metric_request(METRIC_DUTY_CYCLE), timeout=timeout_s
                )
                reading.duty_cycle_pct = decode_metric_response(duty_wire)
            except (grpc.RpcError, ValueError):
                pass
        return reading
    finally:
        if own_channel:
            channel.close()
