"""In-process fake of the libtpu runtime-metrics gRPC service.

Speaks the real transport (grpcio server) and the same wire format as the
typed client (`agent/tpu_metrics.py` — encode half of the shared codec), so
agent tests exercise the genuine query path end to end: channel dial, unary
`GetRuntimeMetric` frames, protobuf wire decode, per-chip overlay. The
reference's metrics source had no test double at all (its SCV sniffer was an
external, unshipped project — reference readme.md:9-15); this is the
first-party equivalent.

Counterpart of ``yoda_tpu/testing/fake_libtpu.py``, whole, over this
package's ``agent.tpu_metrics``.
"""

from __future__ import annotations

from yoda_tpu_torch.agent import tpu_metrics as tm


class FakeLibtpuMetricsServer:
    """Serve METRIC_HBM_TOTAL / METRIC_HBM_USAGE / METRIC_DUTY_CYCLE for a
    configurable chip map on a loopback port.

    ``per_chip`` maps chip index -> (hbm_total_bytes, hbm_used_bytes);
    mutate it between queries to simulate occupancy changes. Unknown metric
    names are answered with NOT_FOUND, like the real service.
    """

    def __init__(
        self,
        per_chip: dict[int, tuple[int, int]],
        *,
        duty_cycle_pct: dict[int, float] | None = None,
        omit_usage_for: set[int] | None = None,
        port: int = 0,
    ):
        import grpc

        self.per_chip = dict(per_chip)
        self.duty_cycle_pct = dict(duty_cycle_pct or {})
        # Devices to drop from METRIC_HBM_USAGE responses — simulates the
        # partial-coverage fault the client must treat as "chip not read"
        # (a 0-usage default would publish an occupied chip as free).
        self.omit_usage_for = set(omit_usage_for or ())
        self.requests_seen: list[str] = []
        self._grpc = grpc

        def handler(request: bytes, context) -> bytes:
            name = tm.decode_metric_request(request)
            self.requests_seen.append(name)
            if name == tm.METRIC_HBM_TOTAL:
                vals = {i: float(t) for i, (t, _) in self.per_chip.items()}
            elif name == tm.METRIC_HBM_USAGE:
                vals = {
                    i: float(u)
                    for i, (_, u) in self.per_chip.items()
                    if i not in self.omit_usage_for
                }
            elif name == tm.METRIC_DUTY_CYCLE:
                vals = dict(self.duty_cycle_pct)
            else:
                context.abort(
                    grpc.StatusCode.NOT_FOUND, f"unknown metric {name!r}"
                )
            return tm.encode_metric_response(name, vals)

        from concurrent.futures import ThreadPoolExecutor

        service, method = tm.GRPC_METHOD.strip("/").rsplit("/", 1)
        self._server = grpc.server(ThreadPoolExecutor(max_workers=2))
        self._server.add_generic_rpc_handlers(
            (
                grpc.method_handlers_generic_handler(
                    service,
                    {
                        method: grpc.unary_unary_rpc_method_handler(
                            handler,
                            request_deserializer=lambda b: b,
                            response_serializer=lambda b: b,
                        )
                    },
                ),
            )
        )
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")
        self._server.start()

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def stop(self) -> None:
        self._server.stop(grace=None)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
