"""Batched watch ingest (``cluster/ingest.py`` and the informer's
``handle_batch``), held against yoda_tpu.

Every case of ``tests/test_ingest.py`` runs on both packages from the
reference's own source (``torch_refcases.run_case``), with its exact
assertions; none is left out.

Beside them, one numpy-seeded event script (3 seeds) goes through both
packages' ``EventBatcher`` + ``InformerCache`` + ``TenantLedger`` + DRF
``SchedulingQueue``, at windows 0 (per-event batches) and 2 ms (a chunk
per batch, flushed explicitly): the coalesced batches, the pop order, the
dominant shares and the informer's and queue's state after every chunk
must be equal, tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest
from torch_refcases import PACKAGES, cases, run_case

REF = "test_ingest.py"
SKIP: "dict[str, str]" = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


# --- one seeded event script through both packages' ingest + tenancy -----

MIB = 1 << 20
TENANTS = ("flood", "team-a", "team-b", "team-c")


def event_script(seed: int, n: int = 360) -> "list[list[tuple]]":
    """A seeded stream of plain tuples, cut into chunks: TPU hosts added,
    republished with new free HBM, republished unchanged and deleted; pods
    of four tenants added pending (1-4 chips, some with an HBM ask), bound
    to a host, unbound and deleted. Each chunk ends with how many pops the
    scheduler takes after it."""
    rng = np.random.default_rng(seed)
    hosts: "dict[str, int]" = {}
    pods: "dict[str, tuple]" = {}  # uid -> (name, tenant, chips, hbm)
    ctr = n_host = n_pod = 0
    chunks, chunk = [], []
    for _ in range(n):
        op = rng.choice(["tpu_add", "tpu_mod", "tpu_hb", "tpu_del", "pod_add",
                         "pod_add", "pod_add", "pod_bind", "pod_unbind", "pod_del"])
        if op == "tpu_add" or (op.startswith("tpu") and not hosts):
            name = f"h{n_host:03d}"
            n_host += 1
            ctr += 1
            hosts[name] = ctr
            chunk.append(("tpu", "added", name, int(rng.choice([4, 8])), ctr))
        elif op in ("tpu_mod", "tpu_hb"):
            name = sorted(hosts)[int(rng.integers(len(hosts)))]
            if op == "tpu_mod":
                ctr += 1
                hosts[name] = ctr
            chunk.append(("tpu", "modified", name, 8, hosts[name]))
        elif op == "tpu_del":
            name = sorted(hosts)[int(rng.integers(len(hosts)))]
            del hosts[name]
            chunk.append(("tpu", "deleted", name, 8, 0))
        elif op == "pod_add" or not pods:
            uid = f"u{n_pod}"
            n_pod += 1
            tenant = TENANTS[int(rng.choice(4, p=[0.55, 0.15, 0.15, 0.15]))]
            spec = (f"p{uid}", tenant, int(rng.integers(1, 5)),
                    int(rng.choice([0, 0, 4096, 12288])))
            pods[uid] = spec
            chunk.append(("pod", "added", uid, *spec, None))
        else:
            uid = sorted(pods)[int(rng.integers(len(pods)))]
            node = f"h{int(rng.integers(max(n_host, 1))):03d}"
            if op == "pod_del":
                chunk.append(("pod", "deleted", uid, *pods.pop(uid), None))
            else:
                chunk.append(("pod", "modified", uid, *pods[uid],
                              node if op == "pod_bind" else None))
        if rng.random() < 1 / 24:
            chunks.append((chunk, int(rng.integers(0, 6))))
            chunk = []
    chunks.append((chunk, 4))
    return chunks


class IngestWorld:
    """One package's watch path as build_stack wires it with tenant
    fairness and batched ingest: an EventBatcher applying each batch to the
    accountant and the TenantLedger per event, then to the informer in one
    handle_batch (pending pods enqueued into a DRF queue whose shares are
    the ledger's, deletions removed, one reactivation decision per
    batch)."""

    def __init__(self, pkg: str, window_s: float) -> None:
        mod = _side(pkg)
        self.mod = mod
        self.ledger = mod.tenancy.TenantLedger()
        self.queue = mod.queue.SchedulingQueue(
            clock=lambda: 0.0,
            tenant_of=mod.tenancy.tenant_of,
            share_fn=self.ledger.dominant_share,
        )
        self.accountant = mod.accounting.ChipAccountant()

        def on_change_batch(events):
            for e in events:
                if e.kind == "Pod" and e.type == "deleted":
                    self.queue.remove(e.obj.uid)
            if any(e.kind == "TpuNodeMetrics" or e.type == "deleted"
                   for e in events) and self.queue.has_parked():
                self.queue.move_all_to_active()

        self.informer = mod.informer.InformerCache(
            on_pod_pending=self.queue.add, on_change_batch=on_change_batch
        )
        self.batches: list = []

        def apply(events):
            self.batches.append([
                (e.type, e.kind, getattr(e.obj, "uid", "") or e.obj.name)
                for e in events
            ])
            for e in events:
                self.accountant.handle(e)
                self.ledger.handle(e)
            self.informer.handle_batch(events)

        self.batcher = mod.ingest.EventBatcher(apply, batch_max=256, window_s=window_s)

    def event(self, row: tuple):
        mod = self.mod
        if row[0] == "tpu":
            _, typ, name, chips, ctr = row
            tpu = mod.types.make_node(
                name, chips=chips, hbm_free_per_chip=((ctr % 4096) + 1) * MIB, now=0.0
            )
            return mod.fake.Event(typ, "TpuNodeMetrics", tpu)
        _, typ, uid, name, tenant, chips, hbm, node = row
        labels = {"tpu/chips": str(chips)}
        if hbm:
            labels["tpu/hbm"] = str(hbm)
        pod = mod.types.PodSpec(name, namespace=tenant, uid=uid, node_name=node,
                                labels=labels)
        return mod.fake.Event(typ, "Pod", pod)

    def state(self) -> dict:
        inf = self.informer
        snap = inf.snapshot()
        return {
            "shares": self.ledger.shares(),
            "capacity": self.ledger.capacity(),
            "usage": {t: self.ledger.usage(t) for t in TENANTS},
            "nodes": {
                ni.name: (tuple(c.hbm_free for c in ni.tpu.chips),
                          tuple(sorted(p.uid for p in ni.pods)))
                for ni in snap.infos()
            },
            "live": sorted(inf.live_uid_set()),
            "claimed": {k: v for k, v in inf.claimed_hbm_mib_map().items() if v},
            "reserved": {k: v for k, v in self.accountant.chips_by_node().items() if v},
            "depths": self.queue.depths(),
            "waits": self.queue.tenant_wait_stats(),
        }


def _side(pkg: str):
    import importlib
    import types

    names = {
        "fake": "cluster.fake", "informer": "cluster.informer",
        "ingest": "cluster.ingest", "queue": "framework.queue",
        "tenancy": "framework.tenancy", "types": "api.types",
        "accounting": "plugins.yoda.accounting",
    }
    return types.SimpleNamespace(
        **{k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()}
    )


def drive(pkg: str, seed: int, window_ms: float) -> dict:
    """The script through one package: at window 0 every event is offered
    alone (a batch of one each); at 2 ms each chunk is offered as one run
    and flushed, so the batch boundaries are the script's on both sides
    whatever the drain thread does. After each chunk the chunk's pops are
    taken, lowest dominant share first."""
    w = IngestWorld(pkg, window_ms / 1000.0)
    pops, states = [], []
    try:
        for chunk, n_pops in event_script(seed):
            events = [w.event(row) for row in chunk]
            if window_ms == 0:
                for e in events:
                    w.batcher.offer(e)
            else:
                w.batcher.offer_batch(events)
                w.batcher.flush()
            for _ in range(n_pops):
                qpi = w.queue.pop(timeout=0)
                pops.append(None if qpi is None else qpi.pod.key)
            states.append(w.state())
    finally:
        w.batcher.stop()
    return {"pops": pops, "states": states, "batches": w.batches,
            "counts": (w.batcher.events_in, w.batcher.events_out, w.batcher.batches)}


class TestBatchedTenancySweep:
    @pytest.mark.parametrize("window_ms", [0.0, 2.0])
    @pytest.mark.parametrize("seed", [3, 17, 2024])
    def test_both_packages_agree(self, seed, window_ms):
        ref = drive("yoda_tpu", seed, window_ms)
        port = drive("yoda_tpu_torch", seed, window_ms)
        assert port["batches"] == ref["batches"]
        assert port["pops"] == ref["pops"]
        assert port["states"] == ref["states"]
        assert port["counts"] == ref["counts"]
        # The sweep reaches what it is for: several tenants with shares,
        # pops that found work, and (batched) coalescing that shrank runs.
        assert len(port["states"][-1]["shares"]) >= 2
        assert sum(p is not None for p in port["pops"]) >= 10
        events_in, events_out, batches = port["counts"]
        if window_ms:
            assert events_out < events_in and batches < events_in
        else:
            assert events_out == events_in == batches
