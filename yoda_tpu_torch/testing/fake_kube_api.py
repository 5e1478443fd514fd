"""In-process fake Kubernetes API server (HTTP, list/watch subset).

Speaks exactly the API surface ``yoda_tpu_torch.cluster.kube`` uses — pod
list/watch/create/delete, the pods/binding subresource, and CRUD + watch for
the TpuNodeMetrics CRD — over real HTTP with real chunked watch streams, so
e2e tests exercise the production wire path (connection drops, 410 Gone
relists, resourceVersion resume) without a cluster. The reference has no
such harness; its scheduler was verified by deploying it (SURVEY.md §4).

Not a general API-server emulation: no authn/z, no field/label selectors
(the scheduler filters client-side), namespaces are just key prefixes.

Counterpart of ``yoda_tpu/testing/fake_kube_api.py``, whole, on the
standard library only, plus a log of every pods/binding POST
(``FakeKubeApiServer.bindings``) for harnesses that count binds per pod
and time them.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

POD_KIND = "Pod"
CR_KIND = "TpuNodeMetrics"
LEASE_KIND = "Lease"
NODE_KIND = "Node"
EVENT_KIND = "Event"
NAMESPACE_KIND = "Namespace"
PVC_KIND = "PersistentVolumeClaim"
PDB_KIND = "PodDisruptionBudget"
PV_KIND = "PersistentVolume"


@dataclass
class _State:
    lock: threading.Condition = field(
        default_factory=lambda: threading.Condition(threading.RLock())
    )
    rv: int = 0
    # kind -> key -> object dict (with metadata.resourceVersion set)
    objects: dict[str, dict[str, dict]] = field(
        default_factory=lambda: {
            POD_KIND: {}, CR_KIND: {}, LEASE_KIND: {}, NODE_KIND: {},
            EVENT_KIND: {}, NAMESPACE_KIND: {}, PVC_KIND: {}, PDB_KIND: {}, PV_KIND: {}
        }
    )
    # kind -> list of (rv:int, watch-event dict); pruned by compact()
    events: dict[str, list[tuple[int, dict]]] = field(
        default_factory=lambda: {
            POD_KIND: [], CR_KIND: [], LEASE_KIND: [], NODE_KIND: [],
            EVENT_KIND: [], NAMESPACE_KIND: [], PVC_KIND: [], PDB_KIND: [], PV_KIND: []
        }
    )
    # kind -> oldest rv still replayable (for 410 Gone)
    window_start: dict[str, int] = field(
        default_factory=lambda: {
            POD_KIND: 0, CR_KIND: 0, LEASE_KIND: 0, NODE_KIND: 0,
            EVENT_KIND: 0, NAMESPACE_KIND: 0, PVC_KIND: 0, PDB_KIND: 0, PV_KIND: 0
        }
    )
    uid_seq: int = 0
    stopping: bool = False
    # Pod keys whose eviction returns 429 (a PodDisruptionBudget would be
    # violated) — set via FakeKubeApiServer.set_eviction_blocked.
    eviction_blocked: set = field(default_factory=set)
    # When True, a fresh watch from an expired resourceVersion is refused
    # with an HTTP 410 STATUS (some API-server paths answer this way)
    # instead of the in-band one-event ERROR stream — exercises the
    # client's immediate-relist handling of transport-level 410s.
    http_410_on_expired: bool = False
    # Every pods/binding POST, in arrival order: (pod key, target node,
    # HTTP status, time.monotonic(), time.time()) — how a harness counts
    # binds per pod (a second POST for a pod is a double bind, whatever
    # the server answered) and times API creation -> binding.
    binding_log: list = field(default_factory=list)


class FakeKubeApiServer:
    """``with FakeKubeApiServer() as srv: KubeApiClient(... srv.base_url)``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.state = _State()
        state = self.state

        class Handler(_Handler):
            pass

        Handler.state = state
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fake-kube-api", daemon=True
        )

    # --- lifecycle ---

    def start(self) -> "FakeKubeApiServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        with self.state.lock:
            self.state.stopping = True
            self.state.lock.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "FakeKubeApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def base_url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    # --- test controls ---

    def compact(self) -> None:
        """Drop the watch-event history: the next watch from an old
        resourceVersion gets 410 Gone (forces a client relist)."""
        with self.state.lock:
            for kind in self.state.events:
                self.state.events[kind].clear()
                self.state.window_start[kind] = self.state.rv
            self.state.lock.notify_all()

    def put_object(self, kind: str, key: str, obj: dict) -> None:
        """Server-side upsert (bypasses HTTP) for seeding state."""
        with self.state.lock:
            etype = "MODIFIED" if key in self.state.objects[kind] else "ADDED"
            _record(self.state, kind, key, obj, etype)

    def delete_object(self, kind: str, key: str) -> None:
        with self.state.lock:
            obj = self.state.objects[kind].pop(key, None)
            if obj is not None:
                _append_event(self.state, kind, "DELETED", obj)

    def get_object(self, kind: str, key: str) -> dict | None:
        with self.state.lock:
            obj = self.state.objects[kind].get(key)
            return json.loads(json.dumps(obj)) if obj is not None else None

    def list_keys(self, kind: str) -> list[str]:
        with self.state.lock:
            return sorted(self.state.objects[kind])

    def bindings(self) -> "list[tuple[str, str, int, float, float]]":
        """A copy of the binding log: (pod key, node, HTTP status,
        monotonic s, wall s) per pods/binding POST, in arrival order."""
        with self.state.lock:
            return list(self.state.binding_log)

    def set_eviction_blocked(self, pod_key: str, blocked: bool = True) -> None:
        """Mark a pod PDB-protected: POST pods/<name>/eviction returns 429."""
        with self.state.lock:
            if blocked:
                self.state.eviction_blocked.add(pod_key)
            else:
                self.state.eviction_blocked.discard(pod_key)


def _expired_event(rv: int) -> dict:
    """The watch-stream 410 Status event — one shape for both the
    fresh-watch rejection and the mid-stream compaction kill."""
    return {
        "type": "ERROR",
        "object": {
            "kind": "Status",
            "code": 410,
            "reason": "Expired",
            "message": f"too old resource version: {rv}",
        },
    }


def _record(state: _State, kind: str, key: str, obj: dict, etype: str) -> None:
    """Must hold state.lock. Bumps rv, stores, appends the watch event."""
    state.rv += 1
    obj = json.loads(json.dumps(obj))
    obj.setdefault("metadata", {})["resourceVersion"] = str(state.rv)
    state.objects[kind][key] = obj
    _append_event(state, kind, etype, obj)


def _append_event(state: _State, kind: str, etype: str, obj: dict) -> None:
    if etype == "DELETED":
        state.rv += 1
        obj = json.loads(json.dumps(obj))
        obj.setdefault("metadata", {})["resourceVersion"] = str(state.rv)
    state.events[kind].append((state.rv, {"type": etype, "object": obj}))
    state.lock.notify_all()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Real API servers run TCP_NODELAY; without it, keep-alive clients
    # (KubeCluster's per-thread pooled connections) serialize on Nagle +
    # delayed-ACK — observed ~40 ms per request/response pair.
    disable_nagle_algorithm = True
    state: _State  # injected per server

    # Silence per-request logging (tests drive thousands of requests).
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    # --- routing ---

    def _route(self) -> tuple[str, dict]:
        parsed = urllib.parse.urlsplit(self.path)
        params = dict(urllib.parse.parse_qsl(parsed.query))
        return parsed.path, params

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length", "0"))
        raw = self.rfile.read(length) if length else b""
        return json.loads(raw) if raw else {}

    def _send_json(self, status: int, obj: dict) -> None:
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_status(self, code: int, message: str) -> None:
        self._send_json(
            code,
            {"kind": "Status", "apiVersion": "v1", "code": code, "message": message},
        )

    # --- kind/key parsing ---

    def _parse(self, path: str):
        """Returns (kind, namespace|None, name|None, subresource|None) or
        None if the path is not recognized."""
        parts = [p for p in path.split("/") if p]
        if parts[:2] == ["api", "v1"]:
            rest = parts[2:]
            if rest == ["pods"]:
                return POD_KIND, None, None, None
            if rest[:1] == ["nodes"]:
                name = rest[1] if len(rest) > 1 else None
                return NODE_KIND, None, name, None
            if len(rest) >= 3 and rest[0] == "namespaces" and rest[2] == "pods":
                ns = rest[1]
                name = rest[3] if len(rest) > 3 else None
                sub = rest[4] if len(rest) > 4 else None
                return POD_KIND, ns, name, sub
            if len(rest) >= 3 and rest[0] == "namespaces" and rest[2] == "events":
                ns = rest[1]
                name = rest[3] if len(rest) > 3 else None
                return EVENT_KIND, ns, name, None
            if rest[:1] == ["namespaces"] and len(rest) <= 2:
                # Cluster-scoped Namespace objects: /api/v1/namespaces[/name]
                name = rest[1] if len(rest) > 1 else None
                return NAMESPACE_KIND, None, name, None
            if rest[:1] == ["persistentvolumes"]:
                name = rest[1] if len(rest) > 1 else None
                return PV_KIND, None, name, None
            if rest[:1] == ["persistentvolumeclaims"]:
                # Cluster-scoped LIST/WATCH (the scheduler's read path);
                # claims themselves carry their namespace in metadata.
                name = rest[1] if len(rest) > 1 else None
                return PVC_KIND, None, name, None
            return None
        if len(parts) >= 3 and parts[0] == "apis":
            from yoda_tpu_torch.api.types import GROUP, VERSION

            if parts[1] == GROUP and parts[2] == VERSION and parts[3:4] == [
                "tpunodemetrics"
            ]:
                name = parts[4] if len(parts) > 4 else None
                return CR_KIND, None, name, None
            if parts[1] == "policy" and parts[2] == "v1" and parts[3:4] == [
                "poddisruptionbudgets"
            ]:
                # Cluster-scoped LIST/WATCH (the scheduler's read path);
                # budgets carry their namespace in metadata, as for PVCs.
                name = parts[4] if len(parts) > 4 else None
                return PDB_KIND, None, name, None
            if (
                parts[1] == "coordination.k8s.io"
                and parts[2] == "v1"
                and len(parts) >= 5
                and parts[3] == "namespaces"
                and parts[5:6] == ["leases"]
            ):
                name = parts[6] if len(parts) > 6 else None
                return LEASE_KIND, parts[4], name, None
            return None
        return None

    @staticmethod
    def _key(kind: str, namespace: str | None, obj_or_name) -> str:
        if kind in (POD_KIND, LEASE_KIND, EVENT_KIND, PVC_KIND, PDB_KIND):  # namespaced
            if isinstance(obj_or_name, dict):
                md = obj_or_name.get("metadata", {})
                return f"{md.get('namespace', namespace or 'default')}/{md['name']}"
            return f"{namespace}/{obj_or_name}"
        if isinstance(obj_or_name, dict):
            return obj_or_name["metadata"]["name"]
        return obj_or_name

    # --- verbs ---

    def do_GET(self) -> None:
        path, params = self._route()
        parsed = self._parse(path)
        if parsed is None:
            return self._send_status(404, f"unknown path {path}")
        kind, ns, name, _sub = parsed
        if name:
            with self.state.lock:
                obj = self.state.objects[kind].get(self._key(kind, ns, name))
            if obj is None:
                return self._send_status(404, f"{kind} {name} not found")
            return self._send_json(200, obj)
        if params.get("watch") == "true":
            return self._watch(kind, params)
        with self.state.lock:
            items = list(self.state.objects[kind].values())
            rv = str(self.state.rv)
        self._send_json(
            200,
            {
                "kind": f"{kind}List",
                "items": items,
                "metadata": {"resourceVersion": rv},
            },
        )

    def do_POST(self) -> None:
        path, _params = self._route()
        parsed = self._parse(path)
        if parsed is None:
            return self._send_status(404, f"unknown path {path}")
        kind, ns, name, sub = parsed
        body = self._body()
        if kind == POD_KIND and sub == "binding":
            return self._bind(ns, name, body)
        if kind == POD_KIND and sub == "eviction":
            return self._evict(ns, name)
        if name:
            return self._send_status(405, "POST to a named resource")
        key = self._key(kind, ns, body)
        with self.state.lock:
            if key in self.state.objects[kind]:
                return self._send_status(409, f"{kind} {key} already exists")
            md = body.setdefault("metadata", {})
            if kind == POD_KIND:
                self.state.uid_seq += 1
                md.setdefault("uid", f"uid-{self.state.uid_seq}")
                md.setdefault(
                    "creationTimestamp",
                    time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
                    + f".{self.state.uid_seq:06d}",
                )
            _record(self.state, kind, key, body, "ADDED")
            created = self.state.objects[kind][key]
        self._send_json(201, created)

    def do_PUT(self) -> None:
        path, _params = self._route()
        parsed = self._parse(path)
        if parsed is None or parsed[2] is None:
            return self._send_status(404, f"unknown path {path}")
        kind, ns, name, _sub = parsed
        body = self._body()
        key = self._key(kind, ns, name)
        with self.state.lock:
            current = self.state.objects[kind].get(key)
            if current is None:
                return self._send_status(404, f"{kind} {key} not found")
            want_rv = body.get("metadata", {}).get("resourceVersion")
            have_rv = current.get("metadata", {}).get("resourceVersion")
            if want_rv and want_rv != have_rv:
                return self._send_status(
                    409, f"resourceVersion conflict: {want_rv} != {have_rv}"
                )
            _record(self.state, kind, key, body, "MODIFIED")
            updated = self.state.objects[kind][key]
        self._send_json(200, updated)

    def do_PATCH(self) -> None:
        """Merge-patch on the pods/status subresource — the nomination
        write (KubeCluster.set_nominated_node). Only the status field is
        merged (None values delete keys, merge-patch semantics)."""
        path, _params = self._route()
        parsed = self._parse(path)
        if parsed is None or parsed[2] is None:
            return self._send_status(404, f"unknown path {path}")
        kind, ns, name, sub = parsed
        if kind != POD_KIND or sub != "status":
            return self._send_status(405, f"PATCH unsupported on {path}")
        body = self._body()
        key = self._key(kind, ns, name)
        with self.state.lock:
            current = self.state.objects[kind].get(key)
            if current is None:
                return self._send_status(404, f"{kind} {key} not found")
            status = dict(current.get("status") or {})
            for k, v in (body.get("status") or {}).items():
                if v is None:
                    status.pop(k, None)
                else:
                    status[k] = v
            merged = dict(current)
            merged["status"] = status
            _record(self.state, kind, key, merged, "MODIFIED")
            updated = self.state.objects[kind][key]
        self._send_json(200, updated)

    def do_DELETE(self) -> None:
        path, _params = self._route()
        parsed = self._parse(path)
        if parsed is None or parsed[2] is None:
            return self._send_status(404, f"unknown path {path}")
        kind, ns, name, _sub = parsed
        key = self._key(kind, ns, name)
        with self.state.lock:
            obj = self.state.objects[kind].pop(key, None)
            if obj is None:
                return self._send_status(404, f"{kind} {key} not found")
            _append_event(self.state, kind, "DELETED", obj)
        self._send_json(200, obj)

    # --- eviction subresource ---

    def _evict(self, ns: str, name: str) -> None:
        key = self._key(POD_KIND, ns, name)
        with self.state.lock:
            if key in self.state.eviction_blocked:
                # The real server answers 429 TooManyRequests when deleting
                # the pod would violate a PodDisruptionBudget.
                return self._send_status(
                    429,
                    f"Cannot evict pod as it would violate the pod's "
                    f"disruption budget ({key})",
                )
            obj = self.state.objects[POD_KIND].pop(key, None)
            if obj is None:
                return self._send_status(404, f"pod {key} not found")
            _append_event(self.state, POD_KIND, "DELETED", obj)
        self._send_status(201, "evicted")

    # --- binding subresource ---

    def _bind(self, ns: str, name: str, body: dict) -> None:
        node = body.get("target", {}).get("name")
        if not node:
            return self._send_status(400, "binding target.name required")
        key = self._key(POD_KIND, ns, name)
        with self.state.lock:
            pod = self.state.objects[POD_KIND].get(key)
            bound = (pod or {}).get("spec", {}).get("nodeName")
            status = 404 if pod is None else 409 if bound and bound != node else 201
            self.state.binding_log.append(
                (key, node, status, time.monotonic(), time.time())
            )
            if pod is None:
                return self._send_status(404, f"pod {key} not found")
            if bound and bound != node:
                return self._send_status(
                    409, f"pod {key} already bound to {bound}"
                )
            pod = json.loads(json.dumps(pod))
            pod.setdefault("spec", {})["nodeName"] = node
            pod.setdefault("status", {})["phase"] = "Running"
            _record(self.state, POD_KIND, key, pod, "MODIFIED")
        self._send_status(201, "bound")

    # --- watch streaming ---

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _watch(self, kind: str, params: dict) -> None:
        since = int(params.get("resourceVersion", "0") or "0")
        timeout_s = float(params.get("timeoutSeconds", "30"))
        state = self.state
        with state.lock:
            expired = since and since < state.window_start[kind]
            http_410 = state.http_410_on_expired
        if expired and http_410:
            return self._send_status(
                410, f"too old resource version: {since}"
            )
        if expired:
            # Resume window compacted away: the client must relist. Sent as
            # a one-event watch stream (newline-framed), like the real API.
            data = json.dumps(_expired_event(since)).encode() + b"\n"
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        deadline = time.monotonic() + timeout_s
        cursor = since
        try:
            while True:
                batch: list[dict] = []
                expired_mid = False
                with state.lock:
                    if cursor and cursor < state.window_start[kind]:
                        # compact() overtook this OPEN stream's cursor:
                        # events between cursor and window_start are gone,
                        # so the stream must die with an in-band 410 and
                        # force a relist — real API servers terminate
                        # long-running watches at compaction the same way
                        # (without this, open watches silently survive
                        # compaction and the relist tests go
                        # nondeterministic).
                        expired_mid = True
                    else:
                        # The history is in rv order: start after the
                        # cursor instead of walking it all on every wake.
                        events = state.events[kind]
                        start = bisect.bisect_right(events, cursor, key=lambda e: e[0])
                        for rv, event in events[start:]:
                            batch.append(event)
                            cursor = rv
                        if not batch:
                            if state.stopping or time.monotonic() >= deadline:
                                break
                            state.lock.wait(
                                min(0.25, max(deadline - time.monotonic(), 0.01))
                            )
                            continue
                if expired_mid:
                    self._write_chunk(
                        json.dumps(_expired_event(cursor)).encode() + b"\n"
                    )
                    break
                for event in batch:
                    self._write_chunk(json.dumps(event).encode() + b"\n")
            self._write_chunk(b"")  # terminating chunk: orderly stream end
        except (BrokenPipeError, ConnectionResetError):
            pass
