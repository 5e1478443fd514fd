"""The commit RPC server's connection fence, held against yoda_tpu.

A worker's call that reaches its deadline drops its connection, but the
network may still deliver the request it had sent. If that request is a
``stage`` and it lands after the worker reconnected and shipped its
staged-intent log (``residue_sync``), the parent applies a claim that no
worker holds and nothing releases: the staged-claim leak of
``tests/test_multihost.py::TestChaosSweep`` (seed 23).

The port's ``CommitRPCServer`` numbers its connections in accept order
and refuses a lane's mutating op from a connection older than the one
that lane last synced on. The reference has no such fence; its side of
every case here records that it applies the late request, as its
behaviour, not as a pass. The wire is the same for both packages.
"""

from __future__ import annotations

import importlib
import json
import socket
import threading
import time
import types

import pytest

PACKAGES = ("yoda_tpu", "yoda_tpu_torch")
PORT = "yoda_tpu_torch"


def _side(pkg: str) -> types.SimpleNamespace:
    mod = importlib.import_module
    return types.SimpleNamespace(
        pkg=pkg,
        FakeCluster=mod(f"{pkg}.cluster.fake").FakeCluster,
        FakeTpuAgent=mod(f"{pkg}.agent").FakeTpuAgent,
        accounting=mod(f"{pkg}.plugins.yoda.accounting"),
        procserve=mod(f"{pkg}.framework.procserve"),
    )


def _parent(s, hosts=2, chips=8):
    cluster = s.FakeCluster()
    acc = s.accounting.ChipAccountant()
    acc.track_capacity = True
    cluster.add_watcher(acc.handle)
    agent = s.FakeTpuAgent(cluster)
    for i in range(hosts):
        agent.add_host(f"host-{i}", generation="v5e", chips=chips)
    agent.publish_all()
    return acc


class Wire:
    """One raw connection speaking the commit RPC's frames: a request
    written on it after a newer connection's sync is what the parent sees
    when the network delivers a held request late."""

    def __init__(self, s, endpoint: str, shard: str) -> None:
        self.transport = s.procserve.make_transport(endpoint)
        self.sock = self.transport.connect(5.0)
        self.rfile = self.sock.makefile("rb")
        self.shard = shard

    def call(self, op: str, **fields) -> dict:
        req = {"op": op, "shard": self.shard, "term": 0}
        req.update(fields)
        self.transport.send(self.sock, req)
        return json.loads(self.transport.recv(self.rfile))

    def close(self) -> None:
        self.rfile.close()
        self.sock.close()


@pytest.fixture(params=PACKAGES)
def server(request):
    s = _side(request.param)
    acc = _parent(s)
    srv = s.procserve.CommitRPCServer(acc, "127.0.0.1:0")
    srv.start()
    wires: list = []

    def wire(shard="s0"):
        w = Wire(s, srv.endpoint, shard)
        w.call("hello", pid=1)  # accepted and served before the next one
        wires.append(w)
        return w

    yield types.SimpleNamespace(side=s, acc=acc, srv=srv, wire=wire)
    for w in wires:
        w.close()
    srv.stop()


def _stage(w, uid, node="host-0", chips=1, gang=""):
    return w.call("stage", uid=uid, node=node, chips=chips, gang=gang)


class TestLateStage:
    def test_late_stage_after_resync_leaves_no_claim(self, server):
        old = server.wire()          # the connection the worker abandons
        new = server.wire()          # its reconnect
        assert new.call("residue_sync", staged=[])["ok"]
        resp = _stage(old, "default/late")  # the held request lands
        if server.side.pkg == PORT:
            assert not resp["ok"]
            assert "stale connection" in resp["error"]
            assert server.acc.staged_uids() == {}
            assert server.srv.stale_conn_refusals == 1
        else:
            # The reference applies it: the claim stays staged for a lane
            # whose worker never holds it.
            assert resp["ok"]
            assert server.acc.staged_uids() == {"default/late": "s0"}

    @pytest.mark.parametrize("op", ["commit", "release", "residue", "residue_sync"])
    def test_other_mutating_ops_from_the_old_connection(self, server, op):
        old = server.wire()
        new = server.wire()
        assert _stage(new, "default/a")["ok"]
        assert new.call("residue_sync", staged=[
            {"uid": "default/a", "node": "host-0", "chips": 1, "gang": ""}
        ])["verdicts"] == {"default/a": "staged"}
        fields = {
            "commit": {"uids": ["default/a"]},
            "release": {"uid": "default/a"},
            "residue": {"uid": "default/a"},
            "residue_sync": {"staged": []},
        }[op]
        resp = old.call(op, **fields)
        if server.side.pkg == PORT:
            # Refused, in the shape each op's caller already handles, and
            # the live connection's staged claim is untouched.
            if op == "commit":
                assert resp["ok"] and resp["committed"] is False
            else:
                assert not resp["ok"]
            assert server.acc.staged_uids() == {"default/a": "s0"}
        else:
            assert resp["ok"]
            if op in ("release", "residue_sync"):
                assert server.acc.staged_uids() == {}
            elif op == "commit":
                assert resp["committed"] is True
                assert server.acc.staged_uids() == {}

    def test_live_connection_and_other_lanes_are_not_fenced(self, server):
        other = server.wire("s1")    # lane s1, older than s0's sync
        old = server.wire()
        new = server.wire()
        assert _stage(old, "default/before")["ok"]  # before any sync
        assert new.call("residue_sync", staged=[])["ok"]
        assert server.acc.staged_uids() == {}      # abandoned: released
        assert _stage(new, "default/b")["ok"]       # the live connection
        assert _stage(other, "default/c", node="host-1")["ok"]
        ok = new.call("commit", uids=["default/b"])
        assert ok["committed"] is True
        assert server.acc.staged_uids() == {"default/c": "s1"}
        newer = server.wire()        # a later reconnect, no sync yet
        assert _stage(newer, "default/d")["ok"]
        assert server.acc.staged_uids() == {"default/c": "s1", "default/d": "s0"}

    def test_a_commit_at_the_resize_barrier_holds_up_no_other_op(self, server):
        """A commit waiting at the resize barrier (``hold_commits``)
        waits under no lock of the server's: another lane, and the same
        lane on another connection, are served meanwhile."""
        waiting = server.wire()
        same = server.wire()
        other = server.wire("s1")
        assert _stage(waiting, "default/a")["ok"]
        server.acc.hold_commits()
        out: dict = {}
        t = threading.Thread(
            target=lambda: out.update(waiting.call("commit", uids=["default/a"]))
        )
        t.start()
        try:
            time.sleep(0.2)  # the commit reaches the barrier
            assert _stage(other, "default/b", node="host-1")["ok"]
            assert _stage(same, "default/c")["ok"]
            assert t.is_alive()  # still at the barrier
        finally:
            server.acc.resume_commits()
            t.join(10.0)
        assert out["committed"] is True
        assert server.acc.staged_uids() == {"default/b": "s1", "default/c": "s0"}


class HoldingProxy:
    """A loopback TCP proxy that holds what the client sends on its FIRST
    connection until :meth:`deliver`, and forwards every later connection
    at once: the held request outlives the client's deadline, as on a
    network that delivers late."""

    def __init__(self, upstream: str) -> None:
        host, _, port = upstream.rpartition(":")
        self._up = (host, int(port))
        self._release = threading.Event()
        self.answered = threading.Event()  # the parent replied to the held one
        self._first = True
        self._socks: list = []
        self._listener = socket.socket()
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(8)
        self.endpoint = f"127.0.0.1:{self._listener.getsockname()[1]}"
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            up = socket.create_connection(self._up, timeout=5.0)
            self._socks += [conn, up]
            hold, self._first = self._first, False
            for src, dst, h, seen in (
                (conn, up, hold, None),
                (up, conn, False, self.answered if hold else None),
            ):
                threading.Thread(
                    target=self._pump, args=(src, dst, h, seen), daemon=True
                ).start()

    def _pump(self, src, dst, hold: bool, seen) -> None:
        while True:
            try:
                data = src.recv(65536)
            except OSError:
                break
            if not data:
                break
            if seen is not None:
                seen.set()
            if hold:
                self._release.wait()
            try:
                dst.sendall(data)
            except OSError:
                break
        if hold:
            return  # keep the upstream open: the late request is served
        for s in (src, dst):
            try:
                s.close()
            except OSError:
                pass

    def deliver(self) -> None:
        self._release.set()

    def close(self) -> None:
        self._release.set()
        self._listener.close()
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass


@pytest.mark.parametrize("pkg", PACKAGES)
def test_worker_stage_past_its_deadline(pkg):
    """End to end with each package's own worker client and accountant:
    the stage times out on a held connection, the worker rolls back,
    reconnects and ships its (empty) staged log, then the held stage
    lands on the parent."""
    s = _side(pkg)
    acc = _parent(s)
    srv = s.procserve.CommitRPCServer(acc, "127.0.0.1:0")
    srv.start()
    proxy = HoldingProxy(srv.endpoint)
    cl = s.procserve.CommitRPCClient(proxy.endpoint, shard="s0", timeout_s=0.3)
    worker = s.accounting.RemoteAccountant(cl)
    try:
        with pytest.raises(s.procserve.CommitRPCError):
            worker._claim("default/p24", "host-0", 1, shard="s0", gang="g")
        worker.release("default/p24")
        assert worker.staged_uids() == {}
        worker.apply_residue_verdicts(cl.residue_sync(worker.staged_intents()))
        assert acc.staged_uids() == {}
        proxy.deliver()
        assert proxy.answered.wait(10.0)  # the parent served the late stage
        if pkg == PORT:
            assert acc.staged_uids() == {}
            assert srv.stale_conn_refusals == 1
        else:
            # The reference's leak: what the chaos sweep's drain finds.
            assert acc.staged_uids() == {"default/p24": "s0"}
    finally:
        cl.close()
        proxy.close()
        srv.stop()
