"""Binary entry point — the analog of the reference's ``cmd/scheduler/main.go``.

The reference main seeds rand, builds the upstream scheduler command with the
yoda plugin injected, and executes it (reference cmd/scheduler/main.go:12-21,
pkg/register/register.go:9-13). Here one binary, selected by flags:

    python -m yoda_tpu_torch.cli            in-cluster scheduler (KubeCluster)
    python -m yoda_tpu_torch.cli --demo     in-memory fleet demo (FakeCluster)
    python -m yoda_tpu_torch.cli --agent    node-agent publisher loop (DaemonSet)
    python -m yoda_tpu_torch.cli explain …  why-pending query of a running one
    python -m yoda_tpu_torch.cli slo …      SLO query of a running one

``--config`` takes a YAML file whose top-level keys are ``SchedulerConfig``
fields (weights, mode, gang_permit_timeout_s, ...), validated and used.

The scheduler syncs its caches from the API server ``KubeApiConfig.from_env``
names (``YODA_KUBE_API_URL``, else the in-cluster service account) and
builds its stacks through the ``standalone`` module attribute (so a
caller's patch of ``standalone.build_stack`` applies to every stack), with
the CLI's stop event as each bind executor's: one stack per profile
(``build_profile_stacks``; the base config alone is one profile), or, with
``shard_count`` > 1, a ``ShardSet`` of thread lanes
(``build_sharded_stacks``: the global lane, which alone resyncs and runs
the background repair loops, and one lane per shard, fenced until that
resync completed). It serves ``/metrics`` with ``/readyz`` on the lease
and the warm-start resync, ``/debug/journal`` (the durable claim
journal's summary) and ``/debug/shards`` (the lanes, under this pid), and
runs the first stack's ``Scheduler.serve_forever`` here and every other
stack's on a thread of its own. With ``--leader-elect`` every bind is
fenced on the Lease. The background threads (reconciler, rebalancer,
node health, overload ladder, the lanes' rescue pass, config reload on
SIGHUP or a changed file, a ``shard_count`` reload resizing the lanes)
start with leadership; the ``finally`` drain stops the bind executors,
the ingest threads, the Event recorders, the journal, the metrics server
and the lease.

The fleet evaluation runs on the CUDA card unless the caller asks for the
host: ``--device cpu`` (or a config with ``kernel_platform: cpu``). With
no flag the config's ``kernel_platform`` decides, and its default "auto"
means the card: both kernel libraries are built before the informer sync
(so nvcc never runs inside a lease-holding serve cycle), and on a machine
without a card ``build_stack`` raises — the CLI never serves on the CPU by
itself.

With ``shard_count`` > 1 and ``shard_mode: process`` this process is the
parent: the global lane, the journal-owning accountant behind a
``CommitRPCServer`` (on a Unix socket, or on TCP at ``commit_listen``;
serving at the journal's replayed term) and a ``WorkerSupervisor`` over
one ``python -m yoda_tpu_torch.framework.procserve`` worker per lane, each
given this process's ``--device`` (so each evaluates its partition on the
card, in a CUDA context of its own, unless the caller asked for the
host); ``/debug/shards`` then serves the workers' heartbeat rows merged
with the supervisor's. A ``--leader-elect`` standby with
``commit_endpoint`` tails the live leader's journal over that RPC while it
waits for the Lease and promotes the warm mirror (a term bump first) when
it takes it.

Federated mode (``--federate-url NAME=URL``, repeatable): the
env-configured cluster is the HOME front and each URL a secondary front
(same token and CA env), whose informer may fail to sync at boot without
blocking startup. ``standalone.build_federation`` builds one stack per
front (each on the card unless the caller asks for the host), the
federation owns every member's warm-start resync and fence (leader gate,
health state, resync gate), ``/readyz`` follows the degraded-readiness
contract (home resynced; a remote resynced or verifiably PARTITIONED /
LOST), each member's serve loop and background loops run on threads, and
one more thread runs ``Federation.run_forever`` (health probes, rejoin
resyncs, spillover) every ``federation_probe_period_s``. Profiles and
``shard_count`` > 1 are ignored there, with a message, as in the
reference.

Agent mode (``--agent``) publishes this node's TpuNodeMetrics CR every
``--interval-s`` through ``agent.native.NativeTpuAgent`` (the C++ reader,
built at first use; ``--tpuinfo-lib`` names a library), with
``--runtime-probe`` / ``--libtpu-metrics`` overlays and, only with
``--allow-fake``, a synthetic host when no reader yields anything. It does
no device work.

Counterpart of ``yoda_tpu/cli.py``, whole. ``--jax-platform`` is not
kept: ``--device`` takes its place.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys
import threading
import time

# --device value -> config.kernel_platform
_DEVICE_PLATFORM = {"cpu": "cpu", "cuda": "device"}


def _config_on_device(config, device: "str | None"):
    """``config`` with every profile's ``kernel_platform`` set to what
    ``device`` ("cpu" or "cuda") selects; unchanged when it is None."""
    if device is None:
        return config
    platform = _DEVICE_PLATFORM[device]
    return dataclasses.replace(
        config,
        kernel_platform=platform,
        profiles=tuple(
            dataclasses.replace(p, kernel_platform=platform)
            for p in config.profiles
        ),
    )


def _load_config(path: str | None):
    from yoda_tpu_torch.config import SchedulerConfig

    if not path:
        return SchedulerConfig()
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if not isinstance(raw, dict):
        raise ValueError(f"scheduler config {path} must be a YAML mapping")
    return SchedulerConfig.from_dict(raw)


def _build_kube_cluster(*, kinds=None, url=None, required=True):
    """A started KubeCluster, synced unless it is a federation remote.
    ``url`` overrides the env-derived endpoint (federation remotes share
    the home token/CA env). ``required=False`` is the federation-remote
    contract: a remote API server that cannot sync at boot must NOT block
    startup — the health monitor will mark it PARTITIONED/LOST, readiness
    will not wait for it (degraded readiness), and the first successful
    rejoin resyncs it."""
    from yoda_tpu_torch.cluster import KubeApiClient, KubeApiConfig, KubeCluster

    if url is None:
        cfg = KubeApiConfig.from_env()
    else:
        cfg = KubeApiConfig(
            base_url=url,
            token=os.environ.get("YODA_KUBE_TOKEN", ""),
            ca_file=os.environ.get("YODA_KUBE_CA_FILE") or None,
            insecure_skip_verify=os.environ.get("YODA_KUBE_INSECURE") == "1",
        )
    if kinds is None:
        cluster = KubeCluster(KubeApiClient(cfg))
    else:
        cluster = KubeCluster(KubeApiClient(cfg), kinds=kinds)
    cluster.start()
    if not cluster.wait_for_sync(60.0 if required else 5.0):
        if required:
            cluster.stop()
            raise RuntimeError(
                "timed out syncing informer caches from the API server"
            )
        print(
            f"yoda-tpu-scheduler: federation remote {url} not syncing; "
            "continuing degraded (health monitor will gate it)",
            file=sys.stderr,
        )
    return cluster


def _federate_specs(specs: "list[str]") -> "list[tuple[str, str]] | None":
    """``--federate-url`` values as (name, url) pairs; None (after a
    message) when one is not NAME=URL."""
    out = []
    for spec in specs:
        name, sep, url = spec.partition("=")
        if not sep or not name or not url:
            print(
                f"yoda-tpu-scheduler: --federate-url must be NAME=URL, "
                f"got {spec!r}",
                file=sys.stderr,
            )
            return None
        out.append((name, url))
    return out


def _init_device(platform: str) -> "float | None":
    """Build both kernel libraries when ``platform`` selects the card and
    one is present; returns the build's wall seconds, or None when nothing
    was built. On the host ("cpu") nothing is built; with no card the
    stack build raises later (``ops.kernel.resolve_device``)."""
    if platform == "cpu":
        return None
    import torch

    if not torch.cuda.is_available():
        return None
    from yoda_tpu_torch.ops import cuda_kernel

    t0 = time.perf_counter()
    cuda_kernel.build_all()
    return time.perf_counter() - t0


def _install_reload_handler(reload_event: threading.Event) -> None:
    """SIGHUP -> config hot-reload (the classic daemon contract). Main
    thread only, like the stop handlers; embedded callers trigger
    reloads through the config file's mtime instead."""
    if threading.current_thread() is not threading.main_thread():
        return
    sighup = getattr(signal, "SIGHUP", None)
    if sighup is not None:
        signal.signal(sighup, lambda *_: reload_event.set())


def _config_reload_loop(
    path: "str | None",
    reload_event: threading.Event,
    reloader,
    stop: threading.Event,
    *,
    period_s: float = 2.0,
) -> None:
    """The hot-reload trigger loop: fires ``reloader.reload()`` on
    SIGHUP (reload_event) or when the mounted config file's mtime moves
    (a ConfigMap update re-projects the file — this IS the
    ConfigMap-watch). A failed load keeps the running config; the
    report is logged either way."""
    last_mtime = None
    if path:
        try:
            last_mtime = os.stat(path).st_mtime
        except OSError:
            last_mtime = None
    while not stop.is_set():
        if stop.wait(period_s):
            return
        trigger = reload_event.is_set()
        if path:
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                mtime = last_mtime
            if mtime != last_mtime:
                last_mtime = mtime
                trigger = True
        if not trigger:
            continue
        reload_event.clear()
        report = reloader.reload()
        if report.get("error"):
            print(
                f"yoda-tpu-scheduler: config reload FAILED (kept the "
                f"running config): {report['error']}",
                file=sys.stderr,
            )
        else:
            print(
                "yoda-tpu-scheduler: config reload: "
                f"applied={report['applied'] or '-'} "
                f"requires-drain={report['requires_drain'] or '-'} "
                f"immutable-kept={report['immutable'] or '-'}",
                file=sys.stderr,
            )


def _install_stop_handlers(stop: threading.Event) -> None:
    """SIGTERM/SIGINT -> orderly drain. Signals can only be bound from the
    main thread; tests and chip_smoke drive main() from worker threads
    and stop the loop through ``stop`` instead."""
    if threading.current_thread() is not threading.main_thread():
        return
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())


def _start_process_lanes(args, config, cluster, stop: threading.Event):
    """The parent of ``shard_mode: process``: ``build_proc_parent`` (the
    global lane and the journal-owning accountant), a started
    ``CommitRPCServer`` over that accountant at the journal's replayed
    term, and a started ``WorkerSupervisor`` over one worker process per
    lane, each given the device this process evaluates on. Returns
    ``(shard_set, server)``."""
    import subprocess
    import tempfile

    from yoda_tpu_torch import standalone
    from yoda_tpu_torch.framework.procserve import CommitRPCServer
    from yoda_tpu_torch.framework.shards import WorkerSupervisor

    shard_set = standalone.build_proc_parent(cluster, config, stop_event=stop)
    # Commit endpoint: `commit_listen` (host:port) lifts the commit point
    # onto TCP so shard workers on OTHER hosts and a journal-tailing
    # standby can reach it; unset keeps the per-process AF_UNIX socket.
    sock_path = config.commit_listen or os.path.join(
        tempfile.gettempdir(), f"yoda-commit-{os.getpid()}.sock"
    )

    def _worker_serve() -> bool:
        # The heartbeat verdict workers fence on: the composed leadership
        # + resync gate (shard_fence_fn is swapped in by the caller before
        # any worker can pass resync). Fail-closed while unset or stopping.
        fence = shard_set.shard_fence_fn
        return not stop.is_set() and fence is not None and bool(fence())

    # Resume at the journal's replayed epoch term: a restarted term-N
    # parent serving at the default term 1 would be fenced as stale by any
    # worker that saw N.
    journal = shard_set.accountant.journal
    server = CommitRPCServer(
        shard_set.accountant,
        sock_path,
        metrics=shard_set.metrics,
        fence_fn=_worker_serve,
        expected_workers=config.shard_count,
        term=max(1, journal.term if journal is not None else 0),
    )
    try:
        server.start()
        # Workers spawned HERE dial the endpoint as resolved after bind (a
        # TCP listen on port 0 is only addressable once bound, and a
        # 0.0.0.0 wildcard listen is dialed via loopback locally). Remote
        # workers are launched by the operator with the same host:port.
        worker_endpoint = server.endpoint
        if worker_endpoint.startswith("0.0.0.0:"):
            worker_endpoint = "127.0.0.1" + worker_endpoint[len("0.0.0.0"):]
        # Every worker evaluates where this process does: on the card
        # unless the caller asked for the host.
        device = "cpu" if config.kernel_platform == "cpu" else "cuda"

        def _spawn_worker(i: int):
            cmd = [
                sys.executable,
                "-m",
                "yoda_tpu_torch.framework.procserve",
                "--socket",
                worker_endpoint,
                "--shard-index",
                str(i),
                "--shard-count",
                str(config.shard_count),
                "--device",
                device,
            ]
            if args.config:
                cmd += ["--config", args.config]
            return subprocess.Popen(cmd)

        shard_set.supervisor = WorkerSupervisor(_spawn_worker, config.shard_count)
        shard_set.supervisor.start()
    except BaseException:
        server.stop()
        shard_set.close()
        raise
    print(
        f"yoda-tpu-scheduler: shard_mode=process — {config.shard_count} "
        f"worker processes (device {device}) over {server.endpoint}",
        file=sys.stderr,
    )
    return shard_set, server


def _proc_shards_view(server, shard_set):
    """The ``/debug/shards`` process view: the RPC server's worker rows
    (heartbeat-fed) with each lane's liveness and restarts from the
    supervisor, plus a row for each spawned worker that never said hello."""

    def view() -> dict:
        out = server.debug()
        sup = (
            {r["shard"]: r for r in shard_set.supervisor.debug()}
            if shard_set.supervisor is not None
            else {}
        )
        known = set()
        for row in out["workers"]:
            known.add(row["lane"])
            s = sup.get(row["lane"])
            if s is not None:
                row["alive"] = s["alive"]
                row["restarts"] = s["restarts"]
        for lane in sorted(set(sup) - known):
            # Spawned but never said hello (still importing, or died
            # pre-handshake): the supervisor row is all there is, and
            # hiding it would hide a crash loop.
            s = sup[lane]
            out["workers"].append(
                {
                    "lane": lane,
                    "pid": s["pid"],
                    "alive": s["alive"],
                    "restarts": s["restarts"],
                    "heartbeat_age_s": None,
                    "staged": 0,
                }
            )
        out["workers"].sort(key=lambda r: r["lane"])
        return out

    return view


def _promote_tailed(tailer, client, accountant, proc_server) -> None:
    """Lease acquired by a tailing standby: promote the warm mirror. The
    term bump is written as the promoted journal's FIRST frame — durable
    before anything serves — and the old leader's lingering socket is
    fenced by it. A mirror that never completed a tail round trip is
    empty, not warm, and a failed divergence check means a bad one:
    either way the cold state replayed at build time serves instead."""
    from yoda_tpu_torch.journal.tail import TailDiverged

    try:
        if not tailer.synced:
            print(
                "yoda-tpu-scheduler: standby tail never synced; "
                "serving from cold-replayed state",
                file=sys.stderr,
            )
            return
        try:
            new_term = tailer.promote_into(accountant, accountant.journal)
        except TailDiverged as exc:
            print(
                f"yoda-tpu-scheduler: tailed mirror unusable ({exc}); "
                "serving from cold-replayed state",
                file=sys.stderr,
            )
            return
        if proc_server is not None:
            proc_server.set_term(new_term)
        print(
            f"yoda-tpu-scheduler: promoted warm from tailed journal (term "
            f"{new_term}, {len(tailer.claims)} claims, lag "
            f"{tailer.lag_frames} frames)",
            file=sys.stderr,
        )
    finally:
        client.close()


def _run_scheduler(args, stop: threading.Event) -> int:
    """In-cluster scheduler: KubeCluster backend + full plugin stacks +
    metrics endpoint, running until SIGTERM/SIGINT (or ``stop`` is set by
    an embedding caller). With ``--leader-elect``, the scheduling loops only
    run while this replica holds the Lease (the standby keeps its informer
    caches warm for fast takeover); losing leadership exits nonzero so the
    Deployment restarts the pod into standby."""
    from yoda_tpu_torch import standalone
    from yoda_tpu_torch.metrics_server import MetricsServer

    config = _config_on_device(_load_config(args.config), args.device)
    remote_specs = None
    if args.federate_url:
        remote_specs = _federate_specs(args.federate_url)
        if remote_specs is None:
            return 2
    build_s = _init_device(config.kernel_platform)
    if build_s is not None:
        print(
            f"yoda-tpu-scheduler: kernels built in {build_s:.2f} s",
            file=sys.stderr,
        )
    t_sync = time.perf_counter()
    cluster = _build_kube_cluster()
    print(
        f"yoda-tpu-scheduler: informer sync "
        f"{(time.perf_counter() - t_sync) * 1e3:.1f} ms",
        file=sys.stderr,
    )
    clusters = [cluster]
    federation = None
    shard_set = None
    proc_server = None
    try:
        # `stop` doubles as the bind executors' stop event: a SIGTERM or a
        # lost lease aborts pending bind-retry backoff sleeps immediately
        # instead of draining up to bind_retry_cap_s per attempt.
        if remote_specs is not None:
            # Federated multi-cluster mode: the env-configured cluster is
            # the HOME front; each --federate-url NAME=URL adds a secondary
            # cluster front behind this one scheduler. Remotes are
            # best-effort at boot — a dead remote degrades instead of
            # blocking startup. The federation owns per-member fencing and
            # warm-start resyncs, so profiles are not combined with it
            # (the base profile serves every member).
            if config.profiles:
                print(
                    "yoda-tpu-scheduler: config profiles are ignored in "
                    "federated mode (base profile serves every cluster)",
                    file=sys.stderr,
                )
            if config.shard_count > 1:
                print(
                    "yoda-tpu-scheduler: shard_count > 1 is ignored in "
                    "federated mode (each cluster front serves one loop; "
                    "shard within a cluster by running it unfederated)",
                    file=sys.stderr,
                )
            remotes = []
            for name, url in remote_specs:
                remote = _build_kube_cluster(url=url, required=False)
                clusters.append(remote)
                remotes.append((name, remote))
            federation = standalone.build_federation(
                [("home", cluster), *remotes], config, stop_event=stop
            )
            stacks = [m.stack for m in federation.members]
        elif config.shard_count > 1 and config.shard_mode == "process":
            # Multi-process shard serve: THIS process is the control
            # plane — global lane, journal-owning accountant, repair
            # loops, metrics. Each shard lane is a supervised worker
            # process (framework/procserve.py) with its own informer,
            # queue, bind executor and (on the card) CUDA context,
            # reaching the commit point through the commit RPC; workers
            # fence on leadership AND parent liveness, so they may start
            # (and warm their caches) now.
            shard_set, proc_server = _start_process_lanes(args, config, cluster, stop)
            stacks = shard_set.stacks
        elif config.shard_count > 1:
            # Scheduler shard-out: N parallel serve loops over rendezvous-
            # partitioned slices/pools + the serialized global lane
            # (stacks[0], which owns resync and the background repair
            # loops), sharing one accountant through the optimistic
            # claim->validate->commit protocol.
            shard_set = standalone.build_sharded_stacks(
                cluster, config, stop_event=stop
            )
            stacks = shard_set.stacks
        else:
            # Profiles: one process can serve several schedulerNames, each
            # with its own plugin config (config `profiles:`). The base
            # profile's stack owns the metrics endpoint and the leader
            # gate.
            stacks = standalone.build_profile_stacks(
                cluster, config, stop_event=stop
            )
    except BaseException:
        if shard_set is not None and shard_set.supervisor is not None:
            shard_set.supervisor.stop()
        if proc_server is not None:
            proc_server.stop()
        for c in clusters:
            c.stop()
        raise
    stack = stacks[0]

    # Readiness (/readyz, distinct from /healthz liveness): ready =
    # leadership held (the gate is swapped in below when --leader-elect is
    # on) AND every profile's warm-start resync has completed (sharded:
    # the global lane's, the only one) AND we are not draining. The
    # informer-sync half is implied: _build_kube_cluster() blocked on
    # wait_for_sync above. Federated mode swaps in the DEGRADED-READINESS
    # contract (Federation.ready): ready once the HOME cluster has resynced
    # even while a remote is PARTITIONED/LOST — an all-stacks-resynced
    # gate would wedge the standby forever on a dead remote.
    leader_gate: list = [lambda: True]

    def _ready() -> bool:
        if stop.is_set() or not leader_gate[0]():
            return False
        if federation is not None:
            return federation.ready()
        if shard_set is not None:
            return stacks[0].reconciler.resynced.is_set()
        return all(st.reconciler.resynced.is_set() for st in stacks)

    # /debug/shards: process mode serves the commit RPC server's worker
    # registry (heartbeat-fed) merged with the supervisor's
    # liveness/restart rows; thread mode the in-process lanes under the
    # shared pid; unsharded it reports {"enabled": false}.
    shards_fn = None
    if proc_server is not None:
        shards_fn = _proc_shards_view(proc_server, shard_set)
    elif shard_set is not None:

        def _thread_shards_view(ss=shard_set) -> dict:
            staged_by_lane: dict = {}
            for _uid, lane in ss.accountant.staged_uids().items():
                staged_by_lane[lane] = staged_by_lane.get(lane, 0) + 1
            rows = [
                {
                    "lane": st.scheduler.shard,
                    "pid": os.getpid(),
                    "alive": True,
                    "queue_depth": len(st.queue),
                    "cycles": len(st.scheduler.stats.results),
                    "binds": st.scheduler.stats.binds,
                    "staged": staged_by_lane.get(st.scheduler.shard, 0),
                }
                for st in ss.stacks[1:]
            ]
            return {"enabled": True, "mode": "thread", "workers": rows}

        shards_fn = _thread_shards_view

    # Warm-start resync: each profile's serve loop runs its reconciler's
    # resync pass ONCE, after the fence first admits leadership and before
    # the first queue pop — cluster truth is re-listed, bound pods'
    # reservations charged, and every partially-bound gang adopted or
    # rolled back whole BEFORE any post-promotion bind can happen (/readyz
    # flips only once this completes). Sharded: ONLY the global lane
    # resyncs (its informer sees the whole fleet), then reroutes the
    # resync's requeues home; the shard loops stay fenced until it ran.
    # Federated: the federation's control loop owns resyncs instead (each
    # member's fence stays closed until its resync completes, and a
    # rejoining cluster re-runs the pass) — an on_serve_start hook that
    # raised on a dead remote would kill that member's serve loop for good.
    if federation is None and shard_set is None:
        for st in stacks:
            st.scheduler.on_serve_start = st.reconciler.resync
    elif shard_set is not None:
        g_resynced = stacks[0].reconciler.resynced

        def _sharded_serve_start(rec=stacks[0].reconciler, ss=shard_set):
            rec.resync()
            ss.reroute()

        stacks[0].scheduler.on_serve_start = _sharded_serve_start
        shard_set.shard_fence_fn = g_resynced.is_set
        for st in stacks[1:]:
            st.scheduler.fence_fn = g_resynced.is_set

    metrics_srv = None
    elector_thread = None
    lost_leadership = threading.Event()
    try:
        if args.metrics_port >= 0:
            metrics_srv = MetricsServer(
                stack.metrics,
                port=args.metrics_port,
                ready_fn=_ready,
                # /debug/journal: the durable claim journal's summary
                # (None = journal_path unset, served as {"enabled": false}).
                journal_fn=lambda: stack.accountant.journal,
                shards_fn=shards_fn,
            )
            metrics_srv.start()
            print(f"metrics on :{metrics_srv.port}/metrics", file=sys.stderr)
        _install_stop_handlers(stop)

        if args.leader_elect:
            import socket

            from yoda_tpu_torch.cluster.lease import LeaderElector

            identity = (
                args.lease_identity
                or os.environ.get("HOSTNAME")
                or socket.gethostname()
            )
            elector = LeaderElector(
                cluster.api,
                identity=identity,
                namespace=args.lease_namespace,
                name=args.lease_name,
            )
            # Leader fencing: every scheduler checks the lease BEFORE each
            # bind API write (and the binder again on its worker) and parks
            # its queue while not leading — the exit-on-loss below is
            # seconds-grained, and an in-flight permit release in that
            # window must not race the new leader's binds. Federated members
            # compose the lease with their per-cluster health fence
            # (Federation.set_leader_gate); overwriting fence_fn directly
            # would drop the health half.
            if federation is not None:
                federation.set_leader_gate(elector.is_leader)
            elif shard_set is not None:
                # Lane fences compose the lease with the global lane's
                # resync gate (a promoted replica's lanes must not bind
                # before ITS resync ran); recorded on the shard set too,
                # so lanes added by a live resize inherit it.
                g_resynced = stacks[0].reconciler.resynced
                stacks[0].scheduler.fence_fn = elector.is_leader
                shard_set.shard_fence_fn = (
                    lambda: elector.is_leader() and g_resynced.is_set()
                )
                for st in stacks[1:]:
                    st.scheduler.fence_fn = shard_set.shard_fence_fn
            else:
                for st in stacks:
                    st.scheduler.fence_fn = elector.is_leader
            leader_gate[0] = elector.is_leader  # /readyz follows the lease
            became_leader = threading.Event()

            def _on_lost() -> None:
                print(
                    f"yoda-tpu-scheduler: lost leadership ({identity}); exiting",
                    file=sys.stderr,
                )
                lost_leadership.set()
                stop.set()

            elector_thread = threading.Thread(
                target=elector.run,
                args=(stop,),
                kwargs={
                    "on_started_leading": became_leader.set,
                    "on_stopped_leading": _on_lost,
                },
                name="leader-elector",
                daemon=True,
            )
            elector_thread.start()
            print(
                f"yoda-tpu-scheduler: standby, waiting for lease "
                f"{args.lease_namespace}/{args.lease_name} as {identity}",
                file=sys.stderr,
            )
            # Journal-tailing hot standby: with a `commit_endpoint`
            # configured, stream the live leader's committed journal
            # frames into a warm mirror WHILE waiting on the lease, so
            # promotion is a term bump + state handover instead of a cold
            # re-replay of the whole journal.
            standby_tailer = None
            tail_client = None
            if config.commit_endpoint:
                from yoda_tpu_torch.framework.procserve import CommitRPCClient
                from yoda_tpu_torch.journal.tail import JournalTailer

                tail_client = CommitRPCClient(
                    config.commit_endpoint, shard="standby", stop_event=stop
                )
                standby_tailer = JournalTailer(tail_client, metrics=stack.metrics)
                standby_tailer.start()
                print(
                    f"yoda-tpu-scheduler: tailing leader journal at "
                    f"{config.commit_endpoint}",
                    file=sys.stderr,
                )
            while not stop.is_set() and not became_leader.wait(0.2):
                pass
            if standby_tailer is not None:
                standby_tailer.stop()
            if stop.is_set() and not became_leader.is_set():
                if tail_client is not None:
                    tail_client.close()
                return 0  # stopped while standby
            if standby_tailer is not None:
                _promote_tailed(standby_tailer, tail_client, stack.accountant, proc_server)

        names = [config.scheduler_name] + [
            p.scheduler_name for p in config.profiles
        ]
        print(
            f"yoda-tpu-scheduler: serving (mode={config.mode}, "
            f"device={stack.batch.device if stack.batch else 'host (loop mode)'}, "
            f"profiles={names}, "
            f"lanes={1 + config.shard_count if shard_set else 1}, "
            f"clusters={[m.name for m in federation.members] if federation else ['home']}, "
            f"nodes={len(cluster.list_tpu_metrics())}, "
            f"pods={len(cluster.list_pods())})",
            file=sys.stderr,
        )
        # Every other profile's (or lane's) serve loop on a thread of its
        # own; the first stack's runs on this thread below.
        extra_threads = [
            threading.Thread(
                target=st.scheduler.serve_forever,
                args=(stop,),
                name=(
                    f"scheduler-{st.scheduler.shard}"
                    if st.scheduler.shard is not None
                    else f"scheduler-{st.informer.scheduler_name}"
                ),
                daemon=True,
            )
            for st in stacks[1:]
        ]
        # Background drift reconciler, rebalancer and node health monitor,
        # started with (or after) leadership — never on a standby, whose
        # repairs would fight the live leader's state. Their per-tick gates
        # re-check the live fence and the resync. Sharded: on the GLOBAL
        # lane only — its informer sees the whole fleet; per-lane copies
        # would each repair (and fight over) the same gangs.
        bg_stacks = stacks[:1] if shard_set is not None else stacks
        if config.reconcile_period_s > 0:
            extra_threads.extend(
                threading.Thread(
                    target=st.reconciler.run_forever,
                    args=(stop,),
                    kwargs={"period_s": config.reconcile_period_s},
                    name=f"reconciler-{st.informer.scheduler_name}",
                    daemon=True,
                )
                for st in bg_stacks
            )
        if config.rebalance_period_s > 0:
            extra_threads.extend(
                threading.Thread(
                    target=st.rebalancer.run_forever,
                    args=(stop,),
                    kwargs={"period_s": config.rebalance_period_s},
                    name=f"rebalance-{st.informer.scheduler_name}",
                    daemon=True,
                )
                for st in bg_stacks
            )
        if config.node_health_period_s > 0:
            extra_threads.extend(
                threading.Thread(
                    target=st.nodehealth.run_forever,
                    args=(stop,),
                    kwargs={"period_s": config.node_health_period_s},
                    name=f"nodehealth-{st.informer.scheduler_name}",
                    daemon=True,
                )
                for st in bg_stacks
            )
        # Shard-set maintenance: the attempts-based rescue backstop
        # (starved work to the global lane); reroutes ride the
        # structural-event watcher registered at build time.
        if shard_set is not None:
            extra_threads.append(
                threading.Thread(
                    target=shard_set.run_forever,
                    args=(stop,),
                    name="shard-maintenance",
                    daemon=True,
                )
            )
        # Overload brownout ladder: one evaluation loop for the shared
        # monitor. Not leadership-gated — a standby's ladder just reads
        # empty queues. Started unconditionally: the loop idles at
        # overload_period_s <= 0, and the knob is hot-reloadable.
        extra_threads.append(
            threading.Thread(
                target=stack.metrics.overload.run_forever,
                args=(stop,),
                name="overload-monitor",
                daemon=True,
            )
        )
        # Config hot-reload: SIGHUP + ConfigMap-watch. Live (RELOADABLE)
        # knobs apply atomically via apply_reloadable; shard_count goes
        # through ShardSet.resize (sharded mode); requires-drain and
        # immutable changes are reported and kept.
        from yoda_tpu_torch.overload import ConfigReloader, LiveConfig

        reload_event = threading.Event()
        _install_reload_handler(reload_event)

        def _start_resized_shard(st) -> None:
            t = threading.Thread(
                target=st.scheduler.serve_forever,
                args=(stop,),
                name=f"scheduler-{st.scheduler.shard}",
                daemon=True,
            )
            t.start()
            extra_threads.append(t)

        reloader = ConfigReloader(
            lambda: _load_config(args.config),
            LiveConfig(config),
            lambda cfg: standalone.apply_reloadable(stacks, cfg),
            resize_fn=(
                (lambda n: shard_set.resize(n, start_fn=_start_resized_shard))
                # Process mode: lanes are OS processes, not stacks a live
                # resize can build — shard_count changes report as
                # requires-drain like any other topology change.
                if shard_set is not None and proc_server is None
                else None
            ),
        )
        extra_threads.append(
            threading.Thread(
                target=_config_reload_loop,
                args=(args.config, reload_event, reloader, stop),
                name="config-reload",
                daemon=True,
            )
        )
        # Federation control loop: health probes, rejoin resyncs, and
        # spillover migration — ONE background thread, so degradation
        # never serializes against any member's serve loop.
        if federation is not None:
            extra_threads.append(
                threading.Thread(
                    target=federation.run_forever,
                    args=(stop,),
                    kwargs={"period_s": config.federation_probe_period_s},
                    name="federation",
                    daemon=True,
                )
            )
        for t in extra_threads:
            t.start()
        stack.scheduler.serve_forever(stop)
        for t in extra_threads:
            t.join(timeout=10)
    finally:
        # Process mode: workers first (SIGTERM, wait, SIGKILL), then the
        # RPC server — a worker mid-commit gets its reply or a clean
        # socket death, never a half-written frame; any staged residue
        # is the journal's to recover on the next start.
        if shard_set is not None and shard_set.supervisor is not None:
            shard_set.supervisor.stop()
        if proc_server is not None:
            proc_server.stop()
        for st in stacks:
            # Release the bind-pipeline executor without waiting on a
            # possibly stalled bind round trip (GangPlugin.close sets the
            # shared stop event, aborting pending retry sleeps too), and
            # stop the ingest drain thread (its buffered residue applied).
            st.gang.close()
            if st.ingestor is not None:
                st.ingestor.stop()
        for st in stacks:
            if st.events is not None:
                # Drain pending Events so a SIGTERM right after a decision
                # does not lose its trail.
                st.events.close(timeout_s=5.0)
        # Graceful journal close AFTER every bind pipeline stopped: under
        # journal_sync=batch this flushes + fsyncs the pending tail
        # frames, so a clean shutdown never drops staged/commit records a
        # crash would have recovered from the previous fsync. Federation
        # members each have their own accountant (and journal).
        for journal in {id(st.accountant.journal): st.accountant.journal
                        for st in stacks}.values():
            if journal is not None:
                journal.close()
        if metrics_srv is not None:
            metrics_srv.stop()
        if elector_thread is not None:
            elector_thread.join(timeout=5.0)  # lets the elector release the lease
        for c in clusters:
            c.stop()
    return 1 if lost_leadership.is_set() else 0


def _run_agent(args, stop: threading.Event) -> int:
    """Node-agent mode (the DaemonSet): publish this node's TpuNodeMetrics
    CR every ``--interval-s``, via the native reader when available, else —
    only if ``--allow-fake`` — a synthetic host profile. No device work:
    the CR feeds the scheduler, whose stack evaluates on the card."""
    from yoda_tpu_torch.agent.native import (
        NativeTpuAgent,
        collection_source,
        load_library,
    )

    # Validate everything local BEFORE touching the API server: a
    # misconfigured DaemonSet pod should fail with the actionable message
    # immediately, not after a (up to 60 s) informer sync, and the refusal
    # path must not leave watch threads running.
    node_name = args.node_name or os.environ.get("NODE_NAME")
    if not node_name:
        print(
            "yoda-tpu-scheduler --agent: --node-name or $NODE_NAME required",
            file=sys.stderr,
        )
        return 2
    lib = load_library(args.tpuinfo_lib)
    if lib is None and not args.allow_fake and not args.runtime_probe:
        print(
            "yoda-tpu-scheduler --agent: libyoda_tpuinfo.so not found "
            "(no g++ to build native/ or pass --tpuinfo-lib); refusing to "
            "publish without --runtime-probe or --allow-fake",
            file=sys.stderr,
        )
        return 2

    # The agent reads only Pods (to charge bound pods' claims into the CR);
    # it never list/watches TpuNodeMetrics or Nodes, so its RBAC needs just
    # pod reads + the tpunodemetrics write verbs.
    cluster = _build_kube_cluster(kinds=("Pod",))
    try:
        runtime_fn = None
        if args.runtime_probe:
            from yoda_tpu_torch.agent.runtime import probe_devices

            runtime_fn = probe_devices
        libtpu_fn = None
        if args.libtpu_metrics:
            from yoda_tpu_torch.agent.tpu_metrics import query_hbm

            addr = args.libtpu_metrics_addr
            # duty_cycle: one extra unary RPC per scrape, consumed as the
            # per-chip duty_cycle_pct CR field -> /metrics fleet gauge.
            libtpu_fn = lambda: query_hbm(addr, duty_cycle=True)  # noqa: E731
        agent = NativeTpuAgent(
            cluster,
            node_name,
            lib=lib,
            runtime_devices_fn=runtime_fn,
            libtpu_query_fn=libtpu_fn,
        )
        # Synthetic fallback, used per-iteration only when neither the
        # native library nor the runtime probe yields anything — real data
        # always wins over fake.
        fake = None
        if args.allow_fake and lib is None:
            from yoda_tpu_torch.agent.fake_publisher import FakeTpuAgent

            fake = FakeTpuAgent(cluster)
            fake.add_host(
                node_name, generation=args.fake_generation, chips=args.fake_chips
            )

        _install_stop_handlers(stop)
        print(
            f"yoda-tpu-agent: publishing {node_name} every {args.interval_s}s "
            f"(native={collection_source(lib) if lib else 'unavailable'}"
            f" runtime-probe={'on' if runtime_fn else 'off'}"
            f" libtpu-metrics={args.libtpu_metrics_addr if libtpu_fn else 'off'}"
            f" fake-fallback={'on' if fake else 'off'})",
            file=sys.stderr,
        )
        while not stop.is_set():
            try:
                published = agent.run_once()
                if published is None and fake is not None:
                    fake.publish_all()
            except Exception as e:  # keep the DaemonSet loop alive across blips
                print(f"yoda-tpu-agent: publish failed: {e}", file=sys.stderr)
            stop.wait(args.interval_s)
    finally:
        cluster.stop()
    return 0


def _run_explain(argv: "list[str]") -> int:
    """``explain <pod|gang>`` — the why-pending CLI: queries a running
    scheduler's ``/debug/pending/<key>`` endpoint (metrics_server.py) and
    renders the aggregated rejection summary — verdict kind, attempt count,
    and the top per-node reasons."""
    import json
    import urllib.error
    import urllib.parse
    import urllib.request

    p = argparse.ArgumentParser(
        prog="yoda-tpu-scheduler explain",
        description="explain why a pod (ns/name) or gang is still pending",
    )
    p.add_argument(
        "key",
        nargs="?",
        default=None,
        help="pod key (namespace/name) or gang name",
    )
    p.add_argument(
        "--list",
        action="store_true",
        dest="list_pending",
        help="list every currently-pending pod/gang key with its verdict "
        "class instead of explaining one key",
    )
    p.add_argument(
        "--url",
        default="http://127.0.0.1:10259",
        help="scheduler metrics endpoint base URL",
    )
    args = p.parse_args(argv)
    if args.list_pending:
        return _explain_list(args.url)
    if not args.key:
        p.error("a pod/gang key is required (or pass --list)")
    url = (
        f"{args.url.rstrip('/')}/debug/pending/"
        f"{urllib.parse.quote(args.key, safe='/')}"
    )
    try:
        data = json.loads(urllib.request.urlopen(url, timeout=10).read())
    except urllib.error.HTTPError as e:
        if e.code == 404:
            print(
                f"{args.key}: nothing pending under this key (bound, never "
                "seen by this scheduler, or aged out)"
            )
            return 1
        print(f"explain: {url} -> HTTP {e.code}", file=sys.stderr)
        return 2
    except (urllib.error.URLError, OSError) as e:
        print(f"explain: cannot reach {args.url}: {e}", file=sys.stderr)
        return 2
    import datetime

    age = ""
    if data.get("last_wall_unix"):
        dt = datetime.datetime.fromtimestamp(data["last_wall_unix"])
        age = f" (last verdict {dt.isoformat(sep=' ', timespec='seconds')})"
    shard = f" [shard {data['shard']}]" if data.get("shard") else ""
    print(
        f"{data['key']}: {data['kind']} after {data['attempts']} "
        f"attempt(s){age}{shard}"
    )
    print(f"  last: {data['last_message']}")
    if data.get("members"):
        print(f"  members seen: {', '.join(data['members'])}")
    reasons = data.get("top_reasons") or []
    if reasons:
        print("  top rejection reasons:")
        for r in reasons:
            nodes = f" [{', '.join(r['nodes'])}]" if r.get("nodes") else ""
            print(f"    {r['count']:>4}x {r['reason']}{nodes}")
    return 0


def _explain_list(base_url: str) -> int:
    """``explain --list`` — every currently-pending pod/gang key with its
    verdict class, from ``GET /debug/pending``."""
    import json
    import urllib.error
    import urllib.request

    url = f"{base_url.rstrip('/')}/debug/pending"
    try:
        data = json.loads(urllib.request.urlopen(url, timeout=10).read())
    except (urllib.error.URLError, OSError) as e:
        print(f"explain: cannot reach {base_url}: {e}", file=sys.stderr)
        return 2
    if not data.get("count"):
        print("nothing pending (no rejection verdicts recorded)")
        return 0
    by_kind = data.get("by_kind") or {}
    print(
        f"{data['count']} pending key(s): "
        + ", ".join(f"{k}={n}" for k, n in sorted(by_kind.items()))
    )
    for e in data.get("pending", []):
        members = f" ({e['members']} member(s))" if e.get("members") else ""
        print(
            f"  {e['key']}: {e['kind']} after {e['attempts']} "
            f"attempt(s){members}"
        )
    return 0


def _run_slo(argv: "list[str]") -> int:
    """``slo`` — the fleet SLO CLI: queries a running scheduler's
    ``GET /debug/slo`` and renders the per-tenant and fleet SLIs, targets,
    burn rates and firing alerts."""
    import json
    import urllib.error
    import urllib.request

    p = argparse.ArgumentParser(
        prog="yoda-tpu-scheduler slo",
        description="per-tenant/fleet SLO status from a running scheduler",
    )
    p.add_argument(
        "--url",
        default="http://127.0.0.1:10259",
        help="scheduler metrics endpoint base URL",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="dump the raw /debug/slo JSON instead of the table",
    )
    args = p.parse_args(argv)
    url = f"{args.url.rstrip('/')}/debug/slo"
    try:
        data = json.loads(urllib.request.urlopen(url, timeout=10).read())
    except (urllib.error.URLError, OSError) as e:
        print(f"slo: cannot reach {args.url}: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(data, indent=1))
        return 1 if data.get("alerts") else 0
    if not data.get("enabled", False):
        print("SLO engine disabled (slo_enabled: false)")
        return 0
    t = data.get("targets", {})
    w = data.get("windows", {})
    print(
        f"targets: admission p99 <= {t.get('admission_wait_p99_s', 0)}s "
        f"(goal {t.get('admission_wait_slo', 0):.0%}), starved windows <= "
        f"{t.get('starved_windows', 0)} "
        f"(window {w.get('starvation_s', 0):.0f}s); burn alert needs both "
        f"{w.get('burn_fast_s', 0):.0f}s and {w.get('burn_slow_s', 0):.0f}s "
        f"windows >= {w.get('burn_threshold', 0)}x"
    )
    fleet = data.get("fleet", {})
    goodput = fleet.get("goodput")
    print(
        f"fleet: admission p99 {fleet.get('admission_wait_p99_s', 0):.3f}s "
        f"over {fleet.get('admissions_window', 0)} admission(s), "
        f"starved windows {fleet.get('starved_windows', 0)}, "
        f"preemptions/min {fleet.get('preemption_rate_per_min', 0):.2f}, "
        f"repairs/min {fleet.get('repair_rate_per_min', 0):.2f}, "
        f"goodput {goodput if goodput is not None else 'n/a'}"
    )
    tenants = data.get("tenants", {})
    if tenants:
        print(
            f"{'tenant':<20} {'p99_s':>8} {'admits':>7} {'pending':>8} "
            f"{'starved':>8} {'burn_f':>7} {'burn_s':>7} alert"
        )
        for name in sorted(tenants):
            row = tenants[name]
            print(
                f"{(name or '(default)'):<20} "
                f"{row['admission_wait_p99_s']:>8.3f} "
                f"{row['admissions_window']:>7} {row['pending']:>8} "
                f"{row['starved_windows']:>8} {row['burn_fast']:>7.2f} "
                f"{row['burn_slow']:>7.2f} {row['alert']}"
            )
    alerts = data.get("alerts", [])
    for a in alerts:
        detail = ", ".join(
            f"{k}={v}" for k, v in sorted(a.items()) if k not in ("sli",)
        )
        print(f"ALERT {a['sli']}: {detail}")
    if not alerts:
        print("no SLO alerts firing")
    return 1 if alerts else 0


def main(
    argv: list[str] | None = None, *, stop: threading.Event | None = None
) -> int:
    """``stop`` lets an embedding caller (tests, chip_smoke, a supervising
    process) terminate the scheduler loop; standalone runs get
    SIGTERM/SIGINT handlers instead."""
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "explain":
        # An operator query against a RUNNING scheduler, not a serving
        # mode, so it short-circuits before the main parser.
        return _run_explain(argv[1:])
    if argv and argv[0] == "slo":
        return _run_slo(argv[1:])
    parser = argparse.ArgumentParser(
        prog="yoda-tpu-scheduler",
        description="TPU-native Kubernetes scheduler (yoda-tpu), PyTorch/CUDA port",
    )
    parser.add_argument("--config", help="scheduler configuration YAML", default=None)
    parser.add_argument("-v", "--verbosity", type=int, default=3)
    parser.add_argument(
        "--metrics-port",
        type=int,
        default=10259,
        help="port for /metrics, /healthz, /readyz, /trace (-1 disables)",
    )
    parser.add_argument(
        "--demo",
        action="store_true",
        help="run against an in-memory fake cluster with a synthetic TPU fleet",
    )
    parser.add_argument(
        "--device",
        choices=sorted(_DEVICE_PLATFORM),
        default=None,
        help="where the fleet evaluation runs: 'cuda' (the card; raises "
        "without one) or 'cpu' (the host). Default: the config's "
        "kernel_platform, whose default 'auto' means the card",
    )
    fedg = parser.add_argument_group("federation")
    fedg.add_argument(
        "--federate-url",
        action="append",
        default=None,
        metavar="NAME=URL",
        help="add a secondary cluster front (repeatable): NAME labels the "
        "cluster in metrics/logs, URL is its API server (authenticated "
        "with the same YODA_KUBE_TOKEN/CA env as the home cluster). The "
        "env-configured cluster becomes the HOME front; gangs the home "
        "cluster cannot fit whole spill over to healthy secondaries, and "
        "a partitioned or lost secondary degrades to local-only placement "
        "instead of blocking the scheduler",
    )
    ha = parser.add_argument_group("leader election")
    ha.add_argument(
        "--leader-elect",
        action="store_true",
        help="run scheduling only while holding the coordination.k8s.io Lease",
    )
    ha.add_argument("--lease-namespace", default="kube-system")
    ha.add_argument("--lease-name", default="yoda-tpu-scheduler")
    ha.add_argument(
        "--lease-identity", default=None, help="defaults to $HOSTNAME"
    )
    agent = parser.add_argument_group("agent mode")
    agent.add_argument(
        "--agent",
        action="store_true",
        help="run the node-agent publisher loop instead of the scheduler",
    )
    agent.add_argument("--node-name", default=None, help="defaults to $NODE_NAME")
    agent.add_argument("--interval-s", type=float, default=10.0)
    agent.add_argument(
        "--tpuinfo-lib",
        default=None,
        help="path to libyoda_tpuinfo.so (default: $YODA_TPUINFO_SO, else "
        "native/tpuinfo.cc built at first use into build/native/)",
    )
    agent.add_argument(
        "--allow-fake",
        action="store_true",
        help="publish a synthetic host profile when no TPU reader is available",
    )
    agent.add_argument(
        "--runtime-probe",
        action="store_true",
        help="overlay per-chip values read through a live TPU runtime onto "
        "the native inventory (the CR's source field records what was "
        "hardware-read); this package reads no TPU runtime, so the probe "
        "finds no devices and the native inventory stands",
    )
    agent.add_argument(
        "--libtpu-metrics",
        action="store_true",
        help="read per-chip HBM total/usage with a typed GetRuntimeMetric "
        "query against the libtpu runtime-metrics gRPC service (the "
        "tpu-info endpoint) and overlay it onto the CR; the service is "
        "served by whichever process owns the chips, so this initializes "
        "no runtime; falls back silently when the service is unreachable",
    )
    agent.add_argument(
        "--libtpu-metrics-addr",
        default="127.0.0.1:8431",
        help="address of the libtpu runtime-metrics gRPC service",
    )
    agent.add_argument("--fake-generation", default="v5e")
    agent.add_argument("--fake-chips", type=int, default=4)
    args = parser.parse_args(argv)

    if args.demo:
        from yoda_tpu_torch.demo import run_demo

        return run_demo(
            verbosity=args.verbosity,
            platform=_DEVICE_PLATFORM[args.device] if args.device else "auto",
        )
    stop = stop if stop is not None else threading.Event()
    if args.agent:
        return _run_agent(args, stop)
    return _run_scheduler(args, stop)


if __name__ == "__main__":
    raise SystemExit(main())
