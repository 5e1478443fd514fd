"""A pod re-LIST racing the pod watch in ``KubeCluster``, held against
yoda_tpu.

``KubeCluster.resync_pods`` (the reconciler's warm-start resync and drift
pass) LISTs pods while the watch goes on applying events. When the watch
applies a change that is newer than the LIST's snapshot, the reference's
diff undoes it: a pod created after the snapshot is reported deleted and
dropped from the scheduling queue, one modified after it is set back, and
one deleted after it comes back. That is how
``tests/test_cli.py::TestSchedulerMode::test_gang_binds_atomically_over_the_wire``
lost a gang member at start-up under load: the member was dequeued, its
siblings waited at Permit, and the hosts turned SUSPECT before the next
drift pass re-added it.

Each case takes the LIST's snapshot, lets the watch apply a newer change
(``_apply``, the watch loop's own entry), then reconciles the stale LIST
(``_list_rv``). The port keeps the newer change; the reference's side
records what the reference does with the same input, as its behaviour.
"""

from __future__ import annotations

import importlib
import types

import pytest

PACKAGES = ("yoda_tpu", "yoda_tpu_torch")
PORT = "yoda_tpu_torch"


def _side(pkg: str) -> types.SimpleNamespace:
    mod = importlib.import_module
    return types.SimpleNamespace(
        pkg=pkg,
        kube=mod(f"{pkg}.cluster.kube"),
        PodSpec=mod(f"{pkg}.api.types").PodSpec,
        FakeKubeApiServer=mod(f"{pkg}.testing").FakeKubeApiServer,
    )


@pytest.fixture(params=PACKAGES)
def wire(request):
    s = _side(request.param)
    server = s.FakeKubeApiServer().start()
    k = s.kube
    cluster = k.KubeCluster(k.KubeApiClient(k.KubeApiConfig(base_url=server.base_url)))
    seed = k.KubeCluster(k.KubeApiClient(k.KubeApiConfig(base_url=server.base_url)))
    events: list = []
    cluster.add_watcher(events.append)
    target = next(t for t in cluster._targets if t.kind == "Pod")

    def watch_delivers(etype: str) -> None:
        """The watch loop applies the server's latest pod event."""
        _rv, ev = server.state.events["Pod"][-1]
        cluster._apply(target, etype, ev["object"])

    def relist_during(change) -> None:
        """One pod re-LIST (_list_rv) whose answer the server has given
        when ``change()`` runs (the watch applying newer events), before
        the answer is reconciled."""
        real = cluster.api.request

        def request(method, path, **kw):
            answer = real(method, path, **kw)
            if (method, path) == ("GET", k.PODS_PATH):
                change()
            return answer

        cluster.api.request = request
        try:
            cluster._list_rv(target)
        finally:
            cluster.api.request = real

    yield types.SimpleNamespace(
        side=s, server=server, cluster=cluster, seed=seed, events=events,
        watch_delivers=watch_delivers, relist_during=relist_during,
    )
    server.stop()


def _kinds(events) -> list:
    return [(e.type, e.obj.key) for e in events if e.kind == "Pod"]


def test_pod_created_after_the_list_is_kept(wire):
    def change():
        wire.seed.create_pod(wire.side.PodSpec("wg-0", labels={"tpu/chips": "4"}))
        wire.watch_delivers("ADDED")

    wire.relist_during(change)
    if wire.side.pkg == PORT:
        assert _kinds(wire.events) == [("added", "default/wg-0")]
        assert wire.cluster.get_pod("default/wg-0") is not None
    else:
        # The reference reports the new pod deleted: its stack's queue
        # drops it until a drift pass re-adds it.
        assert _kinds(wire.events) == [("added", "default/wg-0"),
                                       ("deleted", "default/wg-0")]
        assert wire.cluster.get_pod("default/wg-0") is None


def test_pod_modified_after_the_list_is_not_set_back(wire):
    wire.seed.create_pod(wire.side.PodSpec("p", labels={"tpu/chips": "1"}))
    wire.watch_delivers("ADDED")

    def change():
        obj = wire.server.get_object("Pod", "default/p")
        obj["metadata"].setdefault("labels", {})["tpu/chips"] = "2"
        wire.server.put_object("Pod", "default/p", obj)
        wire.watch_delivers("MODIFIED")

    wire.relist_during(change)
    chips = wire.cluster.get_pod("default/p").labels["tpu/chips"]
    if wire.side.pkg == PORT:
        assert chips == "2"
        assert [t for t, _ in _kinds(wire.events)] == ["added", "modified"]
    else:
        assert chips == "1"  # set back to the LIST's older version
        assert [t for t, _ in _kinds(wire.events)] == ["added", "modified", "modified"]


def test_pod_deleted_after_the_list_stays_deleted(wire):
    wire.seed.create_pod(wire.side.PodSpec("p", labels={"tpu/chips": "1"}))
    wire.watch_delivers("ADDED")

    def change():
        wire.server.delete_object("Pod", "default/p")
        wire.watch_delivers("DELETED")

    wire.relist_during(change)
    if wire.side.pkg == PORT:
        assert wire.cluster.get_pod("default/p") is None
        assert [t for t, _ in _kinds(wire.events)] == ["added", "deleted"]
    else:
        assert wire.cluster.get_pod("default/p") is not None  # back again
        assert [t for t, _ in _kinds(wire.events)] == ["added", "deleted", "added"]


def test_changes_the_watch_missed_still_reconcile(wire):
    """A LIST newer than the store still repairs what the watch dropped,
    on both packages: a deletion and a creation the watch never saw."""
    wire.seed.create_pod(wire.side.PodSpec("gone", labels={"tpu/chips": "1"}))
    wire.watch_delivers("ADDED")
    wire.server.delete_object("Pod", "default/gone")     # the watch misses it
    wire.seed.create_pod(wire.side.PodSpec("new", labels={"tpu/chips": "1"}))
    wire.relist_during(lambda: None)
    assert wire.cluster.get_pod("default/gone") is None
    assert wire.cluster.get_pod("default/new") is not None
    assert _kinds(wire.events)[1:] == [("added", "default/new"),
                                       ("deleted", "default/gone")]


@pytest.mark.parametrize("wire", [PORT], indirect=True)
def test_no_deletion_record_outlives_the_lists_in_flight(wire):
    """The port records a deletion the watch applies only while a pod
    LIST is in flight, and drops the record when that LIST ends: in
    steady state the map is empty."""
    for name in ("a", "b", "c"):
        wire.seed.create_pod(wire.side.PodSpec(name, labels={"tpu/chips": "1"}))
        wire.watch_delivers("ADDED")
    wire.server.delete_object("Pod", "default/a")
    wire.watch_delivers("DELETED")           # no LIST in flight
    assert wire.cluster._gone_rvs == {}
    seen = {}

    def change():
        wire.server.delete_object("Pod", "default/b")
        wire.watch_delivers("DELETED")
        seen.update(wire.cluster._gone_rvs)

    wire.relist_during(change)
    assert list(seen) == [("Pod", "default/b")]
    assert wire.cluster._gone_rvs == {} and wire.cluster._lists_in_flight == {"Pod": 0}
    assert wire.cluster.get_pod("default/b") is None
    assert wire.cluster.get_pod("default/c") is not None
