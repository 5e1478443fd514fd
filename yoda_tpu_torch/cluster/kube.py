"""Real Kubernetes API backend: stdlib HTTP list/watch client.

The reference talks to the API server through controller-runtime with an
UNCACHED client — one HTTP round-trip per node per cycle (reference
pkg/yoda/scheduler.go:69-74,87-91,107-112; the §3.2 ★ hot-loop). Here the
real-cluster backend is the opposite shape by construction: background
list+watch loops keep a local store current, the scheduler reads only the
InformerCache built on top of it, and the only per-cycle API write is the
pods/binding POST (the step upstream default binding does for the
reference, SURVEY.md §3.2 [bind]).

Implemented with ``http.client`` only (no kubernetes / requests dependency):

- ``KubeApiConfig`` — endpoint + auth, from kubeconfig-ish env vars or the
  in-cluster service-account mount.
- ``KubeApiClient`` — JSON requests plus a streaming watch (chunked JSON
  lines), one connection per call.
- ``KubeCluster`` — the ``FakeCluster`` surface (add_watcher / list_pods /
  bind_pod / delete_pod / create_pod / put_tpu_metrics ...) backed by the
  real API: list-then-watch threads for Pods and TpuNodeMetrics CRs with
  resourceVersion resume, 410-Gone relist, diff-on-relist event replay, and
  exponential backoff.

Counterpart of ``yoda_tpu/cluster/kube.py``, whole, on the standard
library only: ``KubeApiError``, ``KubeApiConfig`` (``in_cluster``,
``from_env`` with ``YODA_KUBE_API_URL``), ``KubeApiClient`` (per-thread
keep-alive connections, chunked watch) and ``KubeCluster`` (list/watch of
Pods, TpuNodeMetrics CRs, Nodes, Namespaces, PersistentVolumeClaims,
PersistentVolumes and PodDisruptionBudgets with resourceVersion resume,
410 relists and "synced" sentinels; the pods/binding subresource,
evictions, nomination patches, Events; ``remote_binds = True``, which
turns the bind pipeline on under ``bind_pipeline: auto``), and
``remove_watcher`` (a live shard resize retiring a lane), and the
signals the federation health monitor reads: ``last_event_age_s`` (the
age of the last applied watch event), ``probe`` (a one-item pod LIST)
and ``consecutive_watch_failures``.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import socket
import ssl
import threading
import time
import urllib.parse
from dataclasses import dataclass, field

log = logging.getLogger("yoda_tpu_torch.cluster")

from yoda_tpu_torch.api.types import (
    GROUP,
    VERSION,
    K8sNamespace,
    K8sPdb,
    K8sPv,
    K8sPvc,
    K8sNode,
    PodSpec,
    TpuNodeMetrics,
)
from yoda_tpu_torch.cluster.fake import Event

PODS_PATH = "/api/v1/pods"
NODES_PATH = "/api/v1/nodes"
NAMESPACES_PATH = "/api/v1/namespaces"
PVCS_PATH = "/api/v1/persistentvolumeclaims"
PDBS_PATH = "/apis/policy/v1/poddisruptionbudgets"
PVS_PATH = "/api/v1/persistentvolumes"
CR_PLURAL = "tpunodemetrics"
CR_PATH = f"/apis/{GROUP}/{VERSION}/{CR_PLURAL}"

# Kinds KubeCluster can list+watch. The scheduler needs all of them; the node
# agent passes kinds=("Pod",) — it reads pods (HBM attribution of bound
# pods) but never list/watches TpuNodeMetrics or Nodes, so its RBAC needs
# pod reads plus only the tpunodemetrics WRITE verbs.
SCHEDULER_KINDS = (
    "Pod",
    "TpuNodeMetrics",
    "Node",
    "Namespace",
    "PersistentVolumeClaim",
    "PersistentVolume",
    "PodDisruptionBudget",
)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeApiError(RuntimeError):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


@dataclass(frozen=True)
class KubeApiConfig:
    """Where the API server is and how to authenticate to it."""

    base_url: str                      # e.g. "https://10.0.0.1:443"
    token: str = ""
    ca_file: str | None = None
    insecure_skip_verify: bool = False
    request_timeout_s: float = 30.0
    watch_timeout_s: int = 300         # server-side timeoutSeconds per watch

    @classmethod
    def in_cluster(cls) -> "KubeApiConfig":
        """Service-account config, the in-cluster analog of the reference's
        ``BuildConfigFromFlags("", "")`` fallthrough (reference
        pkg/yoda/scheduler.go:158). Raises (instead of returning a nil
        client like the reference's NewScvClient, SURVEY.md §3.1) when the
        mount is absent."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        token_path = os.path.join(SA_DIR, "token")
        if not host or not os.path.exists(token_path):
            raise RuntimeError(
                "not running in-cluster: KUBERNETES_SERVICE_HOST unset or "
                f"{token_path} missing"
            )
        with open(token_path) as f:
            token = f.read().strip()
        ca = os.path.join(SA_DIR, "ca.crt")
        return cls(
            base_url=f"https://{host}:{port}",
            token=token,
            ca_file=ca if os.path.exists(ca) else None,
        )

    @classmethod
    def from_env(cls) -> "KubeApiConfig":
        """Explicit endpoint via YODA_KUBE_API_URL (+ optional
        YODA_KUBE_TOKEN / YODA_KUBE_CA_FILE / YODA_KUBE_INSECURE=1), falling
        back to the in-cluster mount."""
        url = os.environ.get("YODA_KUBE_API_URL")
        if not url:
            return cls.in_cluster()
        return cls(
            base_url=url,
            token=os.environ.get("YODA_KUBE_TOKEN", ""),
            ca_file=os.environ.get("YODA_KUBE_CA_FILE") or None,
            insecure_skip_verify=os.environ.get("YODA_KUBE_INSECURE") == "1",
        )


class KubeApiClient:
    """Minimal JSON-over-HTTP client with a streaming watch.

    Unary requests reuse ONE keep-alive connection per thread (per-call
    TCP setup would dominate the scheduler's share of gang latency —
    binding POSTs and status PATCHes
    ride the scheduler thread, so per-thread reuse removes the handshakes
    without any locking). Retry rules for failures on a REUSED connection
    (fresh-connection failures always propagate — a real outage, the
    caller's backoff): send-phase failures retry for any method (the
    server saw at most a truncated request); ``RemoteDisconnected`` —
    the server closed with ZERO response bytes, the signature of the
    keep-alive idle-close race — retries for any method (the Go
    net/http convention for replayable requests); other receive-phase
    failures retry only for idempotent methods, and timeouts never
    (both are response-possibly-processed ambiguous, and re-POSTing a
    committed binding turns a successful bind into a 409 failure).
    Connections idle past the server's plausible keep-alive window are
    proactively discarded, so the race window is the exception, not the
    steady state. Watches manage their own long-lived streaming
    connection as before."""

    # Discard a pooled connection idle longer than this (servers commonly
    # close keep-alive sockets after 60-300 s; reconnecting beats racing
    # the close).
    POOL_IDLE_MAX_S = 30.0

    def __init__(self, config: KubeApiConfig) -> None:
        self.config = config
        parsed = urllib.parse.urlsplit(config.base_url)
        if parsed.scheme not in ("http", "https"):
            raise ValueError(f"unsupported scheme in {config.base_url!r}")
        self._scheme = parsed.scheme
        self._netloc = parsed.netloc
        self._local = threading.local()
        self._ssl_ctx: ssl.SSLContext | None = None
        if self._scheme == "https":
            ctx = ssl.create_default_context(cafile=config.ca_file)
            if config.insecure_skip_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self._ssl_ctx = ctx

    def _connect(self, timeout: float) -> http.client.HTTPConnection:
        if self._scheme == "https":
            return http.client.HTTPSConnection(
                self._netloc, timeout=timeout, context=self._ssl_ctx
            )
        return http.client.HTTPConnection(self._netloc, timeout=timeout)

    def _headers(
        self, has_body: bool, content_type: str | None = None
    ) -> dict[str, str]:
        h = {"Accept": "application/json"}
        if self.config.token:
            h["Authorization"] = f"Bearer {self.config.token}"
        if has_body:
            h["Content-Type"] = content_type or "application/json"
        return h

    @staticmethod
    def _url(path: str, params: dict | None) -> str:
        if params:
            return f"{path}?{urllib.parse.urlencode(params)}"
        return path

    def _pooled(self) -> tuple[http.client.HTTPConnection, bool]:
        """This thread's keep-alive connection (reused=True), or a fresh
        one (reused=False). TCP_NODELAY is set on the fresh socket:
        without it, back-to-back request/response pairs on a persistent
        connection serialize on Nagle + delayed-ACK (observed: ~40 ms
        quanta per POST, 10x worse than per-call connections)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            if (
                time.monotonic() - getattr(self._local, "last_used", 0.0)
                <= self.POOL_IDLE_MAX_S
            ):
                return conn, True
            self._discard(conn)  # likely server-closed while idle
        conn = self._connect(self.config.request_timeout_s)
        try:
            conn.connect()
            if conn.sock is not None:
                conn.sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
        except OSError:
            pass  # connect errors surface on the actual request
        self._local.conn = conn
        return conn, False

    def _discard(self, conn: http.client.HTTPConnection) -> None:
        if getattr(self._local, "conn", None) is conn:
            self._local.conn = None
        try:
            conn.close()
        except Exception:  # noqa: BLE001 — already broken
            pass

    def request(
        self,
        method: str,
        path: str,
        *,
        body: dict | None = None,
        params: dict | None = None,
        content_type: str | None = None,
    ) -> dict:
        payload = json.dumps(body) if body is not None else None
        url = self._url(path, params)
        headers = self._headers(payload is not None, content_type)
        # Retry safety: a SEND-phase failure means the socket broke while
        # writing — the server saw at most a truncated request and will
        # not process it, so any method may retry. A RECEIVE-phase
        # failure is ambiguous (the server may have processed the request
        # and died before the response): only idempotent methods retry;
        # re-sending a POST could double-apply (a binding re-POST would
        # 409 and make a SUCCESSFUL bind look failed). Timeouts are
        # receive-ambiguous by definition and never retried.
        idempotent = method in ("GET", "HEAD", "PUT", "DELETE")
        for attempt in (0, 1):
            conn, reused = self._pooled()
            try:
                conn.request(method, url, body=payload, headers=headers)
            except (http.client.HTTPException, OSError):
                self._discard(conn)
                if reused and attempt == 0:
                    continue  # stale keep-alive caught at send: safe retry
                raise
            try:
                resp = conn.getresponse()
                data = resp.read()
            except socket.timeout:
                self._discard(conn)
                raise
            except http.client.RemoteDisconnected:
                self._discard(conn)
                if reused and attempt == 0:
                    # Zero response bytes on a reused connection: the
                    # keep-alive idle-close race — safe for any method.
                    continue
                raise
            except (http.client.HTTPException, OSError):
                self._discard(conn)
                if reused and attempt == 0 and idempotent:
                    continue
                raise
            self._local.last_used = time.monotonic()
            if resp.will_close:
                self._discard(conn)
            if resp.status >= 400:
                raise KubeApiError(resp.status, data.decode(errors="replace")[:512])
            return json.loads(data) if data else {}
        raise AssertionError("unreachable")

    def watch(self, path: str, *, params: dict | None = None):
        """Generator of decoded watch-event dicts ({"type","object"}).
        Returns (StopIteration) on orderly end-of-stream; raises on HTTP or
        connection errors. The caller owns resume/backoff."""
        params = dict(params or {})
        params["watch"] = "true"
        params.setdefault("timeoutSeconds", str(self.config.watch_timeout_s))
        params.setdefault("allowWatchBookmarks", "true")
        # Read timeout slightly past the server-side watch timeout so an
        # orderly stream end wins the race against the socket deadline.
        conn = self._connect(self.config.watch_timeout_s + 15)
        try:
            conn.request(
                "GET", self._url(path, params), headers=self._headers(False)
            )
            resp = conn.getresponse()
            if resp.status >= 400:
                raise KubeApiError(
                    resp.status, resp.read().decode(errors="replace")[:512]
                )
            buf = b""
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    if buf.strip():  # stream ended without trailing newline
                        yield json.loads(buf)
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line.strip():
                        yield json.loads(line)
        finally:
            conn.close()


def _pod_path(namespace: str, name: str = "") -> str:
    base = f"/api/v1/namespaces/{namespace}/pods"
    return f"{base}/{name}" if name else base


def _split_key(pod_key: str) -> tuple[str, str]:
    namespace, _, name = pod_key.partition("/")
    if not name:
        raise ValueError(f"pod key must be namespace/name, got {pod_key!r}")
    return namespace, name


@dataclass
class _WatchTarget:
    kind: str                 # "Pod" | "TpuNodeMetrics"
    path: str
    decode: object            # Callable[[dict], object]
    key: object               # Callable[[obj], str]
    synced: threading.Event = field(default_factory=threading.Event)
    # True only after a LIST genuinely succeeded — distinct from `synced`,
    # which a 403-degraded optional target also sets (to unblock
    # wait_for_sync). The "synced" liveness sentinel (watch-loop emit and
    # late-watcher replay) must key on THIS flag: replaying the sentinel
    # for a degraded target would flip the informer's enforcement on over
    # an empty store — for PVCs that parks every claim-referencing pod on
    # "claim not found", the exact failure the sentinel exists to prevent.
    listed: threading.Event = field(default_factory=threading.Event)
    # Optional kinds degrade on RBAC 403 instead of blocking wait_for_sync
    # forever: the scheduler runs with no data for that kind (documented
    # fail-closed behavior at the consumer) while the loop keeps retrying.
    optional: bool = False
    # Kinds whose consumers distinguish "no data" from "verifiably empty"
    # get a per-kind "synced" liveness sentinel after a successful LIST
    # (and on late-watcher replay, keyed on `listed`).
    sentinel: bool = False


class KubeCluster:
    """The scheduler's cluster backend against a real API server.

    Exposes the same surface as ``FakeCluster`` (so ``build_stack`` and the
    whole plugin set run unchanged) while maintaining local stores through
    background list+watch loops. Watch delivery order within a kind matches
    API-server event order; ``add_watcher(replay=True)`` replays the current
    store first (list-then-watch), matching ``FakeCluster.add_watcher``.
    """

    # Binds are real API round-trips: the bind pipeline fans gang releases
    # out on the bounded bind executor and overlaps the next scheduling
    # cycle with the in-flight POSTs (standalone.build_stack's
    # bind_pipeline="auto" gate keys on this flag). In-process backends
    # leave this False — their binds are microseconds and the thread
    # handoff costs more.
    remote_binds = True

    def __init__(
        self,
        api: KubeApiClient,
        *,
        backoff_initial_s: float = 0.5,
        backoff_max_s: float = 30.0,
        kinds: tuple[str, ...] = SCHEDULER_KINDS,
        bind_latency_s: float = 0.0,
    ) -> None:
        self.api = api
        # Injectable extra per-bind latency (bench/soak only — emulates a
        # slower API server in front of the real wire path; 0 in
        # production). Slept before the POST, outside any lock, so
        # pipelined binds overlap it.
        self.bind_latency_s = bind_latency_s
        self._backoff_initial_s = backoff_initial_s
        self._backoff_max_s = backoff_max_s
        self._lock = threading.RLock()
        self._watchers: list = []
        self._pods: dict[str, PodSpec] = {}
        self._tpus: dict[str, TpuNodeMetrics] = {}
        self._nodes: dict[str, K8sNode] = {}
        self._nss: dict[str, K8sNamespace] = {}
        self._pvcs: dict[str, K8sPvc] = {}
        # Watch-health signals for the federation monitor: when the last
        # event was applied (staleness clock) and how many consecutive
        # watch-loop failures have occurred since the last successful
        # LIST (reset there) — a climbing count with a climbing event age
        # is a partitioned or dying API server, not a quiet cluster.
        self._last_event_mono: float | None = None
        self.consecutive_watch_failures = 0
        self._pdbs: dict[str, K8sPdb] = {}
        self._pvs: dict[str, K8sPv] = {}
        self._rvs: dict[tuple[str, str], str] = {}  # (kind, key) -> resourceVersion
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        all_targets = {
            "Pod": _WatchTarget(
                "Pod",
                PODS_PATH,
                decode=PodSpec.from_obj,
                key=lambda p: p.key,
            ),
            "TpuNodeMetrics": _WatchTarget(
                "TpuNodeMetrics",
                CR_PATH,
                decode=TpuNodeMetrics.from_obj,
                key=lambda t: t.name,
            ),
            "Node": _WatchTarget(
                "Node",
                NODES_PATH,
                decode=K8sNode.from_obj,
                key=lambda n: n.name,
            ),
            "Namespace": _WatchTarget(
                "Namespace",
                NAMESPACES_PATH,
                decode=K8sNamespace.from_obj,
                key=lambda n: n.name,
                # An image upgraded before the ClusterRole gains the
                # namespaces rule must not crash-loop on sync timeout:
                # namespaceSelector terms fail closed without data, the
                # rest of the scheduler is unaffected.
                optional=True,
            ),
            "PersistentVolumeClaim": _WatchTarget(
                "PersistentVolumeClaim",
                PVCS_PATH,
                decode=K8sPvc.from_obj,
                key=lambda c: c.key,
                # Same degradation contract as Namespace: without the RBAC
                # rule the LIST 403s forever, the "synced" liveness
                # sentinel never fires, the informer's watches_pvcs stays
                # False, and volume constraints are simply not enforced
                # (no volume data) instead of parking PVC-referencing
                # pods on "claim not found".
                optional=True,
                sentinel=True,
            ),
            "PersistentVolume": _WatchTarget(
                "PersistentVolume",
                PVS_PATH,
                decode=K8sPv.from_obj,
                key=lambda v: v.name,
                # Same degradation contract: no RBAC rule -> sentinel
                # never fires -> PV affinity not enforced (the claim's
                # zone-label stand-in still applies).
                optional=True,
                sentinel=True,
            ),
            "PodDisruptionBudget": _WatchTarget(
                "PodDisruptionBudget",
                PDBS_PATH,
                decode=K8sPdb.from_obj,
                key=lambda b: b.key,
                # Same degradation contract as PersistentVolumeClaim:
                # without the RBAC rule the LIST 403s forever, the
                # "synced" sentinel never fires, the informer's
                # watches_pdbs stays False, and preemption's victim
                # preference simply ignores budgets (no budget data:
                # violations surface as per-eviction 429 refusals).
                optional=True,
                sentinel=True,
            ),
        }
        unknown = set(kinds) - set(all_targets)
        if unknown:
            raise ValueError(f"unknown watch kinds: {sorted(unknown)}")
        self.kinds = tuple(kinds)
        self._targets = [all_targets[k] for k in kinds]

    # --- lifecycle ---

    def start(self) -> None:
        if self._threads:
            raise RuntimeError("KubeCluster already started")
        for target in self._targets:
            t = threading.Thread(
                target=self._watch_loop,
                args=(target,),
                name=f"kube-watch-{target.kind}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()

    def wait_for_sync(self, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        for target in self._targets:
            if not target.synced.wait(max(deadline - time.monotonic(), 0)):
                return False
        return True

    # --- watch plumbing ---

    def _store(self, kind: str):
        return {
            "Pod": self._pods,
            "TpuNodeMetrics": self._tpus,
            "Node": self._nodes,
            "Namespace": self._nss,
            "PersistentVolumeClaim": self._pvcs,
            "PersistentVolume": self._pvs,
            "PodDisruptionBudget": self._pdbs,
        }[kind]

    def _list_rv(self, target: _WatchTarget) -> str:
        """One LIST: reconcile the local store (diff → added/modified/
        deleted events) and return the collection resourceVersion to watch
        from."""
        data = self.api.request("GET", target.path)
        items = data.get("items", [])
        if target.kind == "Pod":
            # Emit in creation order so restored arrival sequence numbers
            # (queue FIFO tie-breaks) follow pod age.
            items.sort(
                key=lambda o: (
                    o.get("metadata", {}).get("creationTimestamp") or "",
                    o.get("metadata", {}).get("name", ""),
                )
            )
        events: list[Event] = []
        with self._lock:
            store = self._store(target.kind)
            seen: set[str] = set()
            for obj in items:
                decoded = target.decode(obj)
                key = target.key(decoded)
                rv = obj.get("metadata", {}).get("resourceVersion", "")
                seen.add(key)
                prev_rv = self._rvs.get((target.kind, key))
                if key not in store:
                    events.append(Event("added", target.kind, decoded))
                elif rv != prev_rv:
                    events.append(Event("modified", target.kind, decoded))
                else:
                    continue
                store[key] = decoded
                self._rvs[(target.kind, key)] = rv
            for key in list(store):
                if key not in seen:
                    gone = store.pop(key)
                    self._rvs.pop((target.kind, key), None)
                    events.append(Event("deleted", target.kind, gone))
            # Emit while still holding the lock: add_watcher(replay=True)
            # serializes against this, so a registering watcher sees each
            # object exactly once — via replay or via these events, never
            # both (the FakeCluster mutate+emit-under-lock contract).
            # Delivered as ONE list to batch-capable watchers: a relist
            # after a 410/partition replays thousands of diffs, and the
            # batched-ingest pipeline applies them in one pass.
            self._emit_many(events)
        return data.get("metadata", {}).get("resourceVersion", "")

    def _watch_loop(self, target: _WatchTarget) -> None:
        backoff = self._backoff_initial_s
        while not self._stop.is_set():
            try:
                rv = self._list_rv(target)
                self.consecutive_watch_failures = 0
                target.listed.set()
                target.synced.set()
                if target.sentinel:
                    # Prove the watch is genuinely live (RBAC granted) to
                    # downstream informers: only then does an empty store
                    # mean "no objects exist" rather than "no data"
                    # (InformerCache._handle_pvc / _handle_pdb). Without
                    # this sentinel a cluster missing the RBAC rule would
                    # enforce against missing data instead of degrading.
                    self._emit(Event("synced", target.kind, None))
                backoff = self._backoff_initial_s
                while not self._stop.is_set():
                    params = {"resourceVersion": rv} if rv else {}
                    ended = False
                    for raw in self.api.watch(target.path, params=params):
                        etype = raw.get("type", "")
                        if etype == "BOOKMARK":
                            rv = (
                                raw.get("object", {})
                                .get("metadata", {})
                                .get("resourceVersion", rv)
                            )
                            continue
                        if etype == "ERROR":
                            code = raw.get("object", {}).get("code")
                            if code == 410:  # Gone: resume window lost, relist
                                ended = True
                                break
                            raise KubeApiError(
                                int(code or 500), json.dumps(raw.get("object", {}))
                            )
                        obj = raw.get("object", {})
                        rv = obj.get("metadata", {}).get("resourceVersion", rv)
                        self._apply(target, etype, obj)
                    if ended:
                        break  # relist
                    # Orderly stream end (server watch timeout): re-watch
                    # from the last seen rv without relisting.
            except Exception as e:
                if self._stop.is_set():
                    return
                self.consecutive_watch_failures += 1
                if isinstance(e, KubeApiError) and e.status == 410:
                    # Resume window gone (the server answered the watch
                    # request itself with 410, not an in-band ERROR event):
                    # the stored resourceVersion is stale, so relist NOW —
                    # a full list-and-resync reconciles the store and
                    # replays the diff as events. Backing off here would
                    # only widen the blind window; this is not an outage.
                    log.warning(
                        "watch %s: resume window expired (410 Gone); "
                        "relisting immediately", target.kind,
                    )
                    continue
                if (
                    target.optional
                    and isinstance(e, KubeApiError)
                    and e.status == 403
                    and not target.synced.is_set()
                ):
                    log.warning(
                        "watch %s forbidden (RBAC not applied?); scheduler "
                        "proceeds WITHOUT %s data — namespaceSelector "
                        "affinity terms match nothing (pods wait) and "
                        "anti-affinity terms repel conservatively until "
                        "access is granted",
                        target.kind, target.kind,
                    )
                    target.synced.set()  # degrade: do not block cache sync
                # Surface persistent failures (401/403/TLS would otherwise
                # only show up as an opaque sync timeout).
                log.warning(
                    "watch %s failed (%s: %s); retrying in %.1fs",
                    target.kind,
                    type(e).__name__,
                    e,
                    backoff,
                )
                time.sleep(backoff)
                backoff = min(backoff * 2, self._backoff_max_s)

    def _apply(self, target: _WatchTarget, etype: str, obj: dict) -> None:
        decoded = target.decode(obj)
        key = target.key(decoded)
        kind = target.kind
        mapped = {"ADDED": "added", "MODIFIED": "modified", "DELETED": "deleted"}.get(
            etype
        )
        if mapped is None:
            return
        with self._lock:
            store = self._store(kind)
            if mapped == "deleted":
                decoded = store.pop(key, decoded)
                self._rvs.pop((kind, key), None)
            else:
                store[key] = decoded
                self._rvs[(kind, key)] = obj.get("metadata", {}).get(
                    "resourceVersion", ""
                )
            # Under the lock (see _list_rv): no duplicate delivery around a
            # concurrent add_watcher replay.
            self._emit(Event(mapped, kind, decoded))

    # --- FakeCluster surface: watch ---

    def add_watcher(
        self, fn, *, replay: bool = True, batch_fn=None
    ) -> None:
        """Register a watcher (``FakeCluster.add_watcher`` contract).
        ``batch_fn`` marks it batch-capable: the replay here and every
        LIST reconcile diff (``_list_rv``) arrive as ONE list call — the
        batched-ingest pipeline's list plumbing. Live watch events still
        deliver per-event via ``fn``."""
        self._do_add_watcher(fn, replay=replay, batch_fn=batch_fn)

    def remove_watcher(self, fn) -> None:
        """Unregister a watcher by its per-event fn (live shard resize
        retiring a dissolved lane); unknown fns are ignored."""
        with self._lock:
            self._watchers = [
                (f, b) for f, b in self._watchers if f is not fn
            ]

    def _do_add_watcher(self, fn, *, replay: bool = True, batch_fn=None) -> None:
        with self._lock:
            self._watchers.append((fn, batch_fn))
            if replay:
                events: list[Event] = []
                events.extend(
                    Event("added", "Namespace", ns)
                    for ns in self._nss.values()
                )
                for t in self._targets:
                    # Late watchers must not miss the liveness sentinel
                    # (the informer may register after the first LIST).
                    # Key on `listed`, NOT `synced`: a 403-degraded
                    # optional target sets synced without ever listing,
                    # and replaying the sentinel for it would turn the
                    # degradation into enforcement-over-no-data.
                    if t.sentinel and t.listed.is_set():
                        events.append(Event("synced", t.kind, None))
                events.extend(
                    Event("added", "PersistentVolumeClaim", pvc)
                    for pvc in self._pvcs.values()
                )
                events.extend(
                    Event("added", "PersistentVolume", pv)
                    for pv in self._pvs.values()
                )
                events.extend(
                    Event("added", "PodDisruptionBudget", pdb)
                    for pdb in self._pdbs.values()
                )
                events.extend(
                    Event("added", "Node", node)
                    for node in self._nodes.values()
                )
                events.extend(
                    Event("added", "TpuNodeMetrics", tpu)
                    for tpu in self._tpus.values()
                )
                events.extend(
                    Event("added", "Pod", pod)
                    for pod in sorted(
                        self._pods.values(), key=lambda p: p.creation_seq
                    )
                )
                if batch_fn is not None:
                    batch_fn(events)
                else:
                    for event in events:
                        fn(event)

    def _emit(self, event: Event) -> None:
        # Callers hold self._lock (RLock) so store mutation + delivery are
        # atomic w.r.t. add_watcher replay, as in FakeCluster._emit.
        with self._lock:
            self._last_event_mono = time.monotonic()
            for fn, _ in list(self._watchers):
                fn(event)

    def _emit_many(self, events: "list[Event]") -> None:
        """Deliver a reconcile diff: one list call to batch-capable
        watchers, per-event to the rest. Callers hold self._lock."""
        if not events:
            return
        with self._lock:
            self._last_event_mono = time.monotonic()
            for fn, batch_fn in list(self._watchers):
                if batch_fn is not None:
                    batch_fn(events)
                else:
                    for event in events:
                        fn(event)

    def last_event_age_s(self) -> "float | None":
        """Seconds since the last watch event was applied (None before the
        first): the federation health monitor's watch-staleness signal,
        mirroring FakeCluster.last_event_age_s."""
        with self._lock:
            if self._last_event_mono is None:
                return None
            return max(time.monotonic() - self._last_event_mono, 0.0)

    def probe(self) -> None:
        """One cheap authenticated round trip against the API server (the
        federation health monitor's probe): a single-item pod LIST, so RBAC
        already granted for the watch covers it. Raises on failure — the
        monitor classifies the exception with cluster.retry's rules
        (timeouts/5xx = connectivity loss driving PARTITIONED/LOST; other
        API errors = reachable-but-broken, pinning DEGRADED)."""
        self.api.request("GET", PODS_PATH, params={"limit": "1"})

    # --- FakeCluster surface: pods ---

    def create_pod(self, pod: PodSpec) -> PodSpec:
        self.api.request("POST", _pod_path(pod.namespace), body=pod.to_obj())
        return pod

    def bind_pod(self, pod_key: str, node_name: str) -> None:
        """POST the pods/binding subresource — upstream default binding's
        API call (SURVEY.md §3.2 [bind])."""
        if self.bind_latency_s > 0:
            time.sleep(self.bind_latency_s)
        namespace, name = _split_key(pod_key)
        body = {
            "apiVersion": "v1",
            "kind": "Binding",
            "metadata": {"name": name, "namespace": namespace},
            "target": {"apiVersion": "v1", "kind": "Node", "name": node_name},
        }
        try:
            self.api.request(
                "POST", f"{_pod_path(namespace, name)}/binding", body=body
            )
        except KubeApiError as e:
            raise ValueError(f"binding {pod_key} -> {node_name}: {e}") from e

    def delete_pod(self, pod_key: str) -> None:
        namespace, name = _split_key(pod_key)
        try:
            self.api.request("DELETE", _pod_path(namespace, name))
        except KubeApiError as e:
            if e.status != 404:
                raise

    def unbind_pod(self, pod_key: str, node_name: str) -> None:
        """Gang transactional rollback against a real API server: a bound
        pod cannot be un-bound (spec.nodeName is immutable once set), so
        the rollback deletes the pod and its controller (Job/Deployment)
        recreates a fresh unbound replica — the same remediation
        coscheduling operators apply to partially-bound gangs. An
        already-gone pod counts as rolled back (delete_pod's 404 path)."""
        self.delete_pod(pod_key)

    def set_nominated_node(self, pod_key: str, node_name: str | None) -> None:
        """PATCH status.nominatedNodeName (merge-patch on pods/status) —
        upstream preemption's nomination write: kubectl's NOMINATED NODE
        column, and other components see the earmarked capacity.

        Best-effort BY DESIGN: this is cosmetic status, and it is the only
        synchronous remote write on the scheduling loop's callback path
        (binds/events go through their own error handling) — a 403 from
        not-yet-applied RBAC, a transient 5xx, or a socket error must
        degrade to a warning, never kill serve_forever."""
        namespace, name = _split_key(pod_key)
        try:
            self.api.request(
                "PATCH",
                f"{_pod_path(namespace, name)}/status",
                body={"status": {"nominatedNodeName": node_name}},
                content_type="application/merge-patch+json",
            )
        except KubeApiError as e:
            if e.status != 404:  # pod deleted while nominating: routine
                log.warning(
                    "nominatedNodeName patch for %s failed (%s); status "
                    "not updated", pod_key, e,
                )
        except OSError as e:
            log.warning(
                "nominatedNodeName patch for %s failed (%s); status not "
                "updated", pod_key, e,
            )

    def write_event(self, obj: dict, update: bool = False) -> None:
        """Persist a scheduling Event (cluster.events.EventRecorder sink):
        POST on first occurrence, PUT the same named object on count
        aggregation. A 409 on create (name collision after recorder
        restart) falls through to the update path; a 404 on update (the
        API server TTL-garbage-collected the Event while the recorder
        still aggregates it — default --event-ttl is 1h, long-pending
        pods outlive it) falls back to re-creating."""
        md = obj.get("metadata", {})
        ns, name = md.get("namespace", "default"), md["name"]
        base = f"/api/v1/namespaces/{ns}/events"
        if not update:
            try:
                self.api.request("POST", base, body=obj)
                return
            except KubeApiError as e:
                if e.status != 409:
                    raise
        try:
            self.api.request("PUT", f"{base}/{name}", body=obj)
        except KubeApiError as e:
            if e.status != 404:
                raise
            self.api.request("POST", base, body=obj)

    def evict_pod(self, pod_key: str) -> bool:
        """Evict via the ``pods/eviction`` subresource — the API-server path
        that honors PodDisruptionBudgets and grace periods, which a bare
        DELETE bypasses (upstream preemption evicts; the reference's cluster
        exhibits that behavior via its upstream scheduler). Returns False
        when the server refuses the eviction (429: a PDB would be violated)
        so the caller can retry a later cycle; an already-gone pod counts
        as evicted."""
        namespace, name = _split_key(pod_key)
        body = {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": name, "namespace": namespace},
        }
        try:
            self.api.request(
                "POST", f"{_pod_path(namespace, name)}/eviction", body=body
            )
        except KubeApiError as e:
            if e.status == 404:
                return True
            if e.status == 429:
                log.warning(
                    "eviction of %s refused (disruption budget); will retry",
                    pod_key,
                )
                return False
            raise
        return True

    def get_pod(self, pod_key: str) -> PodSpec | None:
        with self._lock:
            return self._pods.get(pod_key)

    def list_pods(self) -> list[PodSpec]:
        with self._lock:
            return list(self._pods.values())

    def resync_pods(self) -> None:
        """Force one pod LIST against the API server and reconcile the
        local store to it — the failover reconciler's truth refresh
        (framework/reconciler.py). The diff replays through every
        registered watcher as added/modified/deleted events (_list_rv's
        contract), so a bind or deletion the watch stream dropped is
        repaired in the informer, the accountant, and the gang plugin in
        one pass. The watch loop keeps streaming from its own
        resourceVersion; re-applying an already-seen change is a no-op
        (same rv -> no event)."""
        target = next((t for t in self._targets if t.kind == "Pod"), None)
        if target is not None:
            self._list_rv(target)

    # --- FakeCluster surface: TpuNodeMetrics CRs (agent side) ---

    def put_tpu_metrics(self, tpu: TpuNodeMetrics) -> None:
        """Create-or-update the per-node CR: the node agent's publish path.
        Uses GET + POST/PUT (resourceVersion-checked) rather than
        server-side apply to stay dependency-free."""
        path = f"{CR_PATH}/{tpu.name}"
        obj = tpu.to_obj()
        try:
            current = self.api.request("GET", path)
        except KubeApiError as e:
            if e.status != 404:
                raise
            obj["metadata"].pop("resourceVersion", None)
            self.api.request("POST", CR_PATH, body=obj)
            return
        obj["metadata"]["resourceVersion"] = current.get("metadata", {}).get(
            "resourceVersion", ""
        )
        self.api.request("PUT", path, body=obj)

    def delete_tpu_metrics(self, name: str) -> None:
        try:
            self.api.request("DELETE", f"{CR_PATH}/{name}")
        except KubeApiError as e:
            if e.status != 404:
                raise

    def list_tpu_metrics(self) -> list[TpuNodeMetrics]:
        with self._lock:
            return list(self._tpus.values())

    # --- FakeCluster surface: Node objects ---

    def list_nodes(self) -> list[K8sNode]:
        with self._lock:
            return list(self._nodes.values())
