"""Per-tenant accounting for DRF fair queuing and quota admission.

A tenant is a namespace (overridable per pod via the ``tpu/tenant`` label,
so one namespace can host several billed tenants or several namespaces can
share one), and the :class:`TenantLedger` maintains each tenant's
*dominant resource share* (Ghodsi et al.'s DRF): usage over the two fleet
resources that matter — TPU chips and HBM — each as a fraction of fleet
capacity, the tenant's share being the max of the two. The scheduling
queue (``framework/queue.py``) pops from the lowest-share tenant first,
which is what makes a flooding tenant unable to starve anyone: every pod
it binds raises its share and pushes it behind the tenants it was
flooding past.

The ledger is watch-driven (exactly like ``ChipAccountant``): fleet
capacity comes from TpuNodeMetrics CRs, usage from bound-pod events, so
the whole thing reconstructs from a list+watch replay on scheduler
restart and costs nothing on the scheduling hot path beyond a dict read
per pop. It is host bookkeeping in plain ints and holds no tensors.

Counterpart of ``yoda_tpu/framework/tenancy.py``, whole.
"""

from __future__ import annotations

import threading

from yoda_tpu_torch.api.requests import LabelParseError, pod_request

TENANT_LABEL = "tpu/tenant"

MIB = 1 << 20


def tenant_of(pod) -> str:
    """The tenant a pod bills to: the ``tpu/tenant`` label when present,
    else the pod's namespace."""
    return pod.labels.get(TENANT_LABEL) or pod.namespace


def _pod_demand(pod) -> "tuple[int, int]":
    """(chips, hbm_mib) a pod occupies for share/quota accounting. Pods
    with no recognizable TPU ask charge their ``google.com/tpu`` resource
    limit (chips only) or nothing — non-TPU pods do not move TPU shares."""
    try:
        req = pod_request(pod)
    except LabelParseError:
        limit = getattr(pod, "tpu_resource_limit", 0)
        return (limit, 0) if limit > 0 else (0, 0)
    if not req.wants_tpu:
        limit = getattr(pod, "tpu_resource_limit", 0)
        return (limit, 0) if limit > 0 else (0, 0)
    chips = req.effective_chips
    return chips, (req.hbm_per_chip // MIB) * chips


class TenantLedger:
    """Watch-driven per-tenant usage + fleet capacity, and the DRF share
    and quota verdicts computed from them. Thread-safe; every reader is
    one lock acquisition over small dicts."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # node -> (healthy chips, total hbm MiB): fleet capacity.
        self._nodes: dict[str, tuple[int, int]] = {}
        self._cap_chips = 0
        self._cap_hbm = 0
        # pod uid -> (tenant, chips, hbm_mib): idempotent charge records.
        self._pods: dict[str, tuple[str, int, int]] = {}
        # tenant -> [chips, hbm_mib] in use (bound pods only).
        self._usage: dict[str, list[int]] = {}

    # --- watch sink (registration order does not matter: independent
    # state; standalone registers it alongside the accountant) ---

    def handle(self, event) -> None:
        if event.kind == "TpuNodeMetrics":
            tpu = event.obj
            with self._lock:
                if event.type == "deleted":
                    chips, hbm = self._nodes.pop(tpu.name, (0, 0))
                    self._cap_chips -= chips
                    self._cap_hbm -= hbm
                else:
                    healthy = tpu.healthy_chips()
                    cap = (
                        len(healthy),
                        sum(c.hbm_total for c in healthy) // MIB,
                    )
                    prev = self._nodes.get(tpu.name, (0, 0))
                    self._nodes[tpu.name] = cap
                    self._cap_chips += cap[0] - prev[0]
                    self._cap_hbm += cap[1] - prev[1]
            return
        if event.kind != "Pod":
            return
        pod = event.obj
        if event.type == "deleted" or not pod.node_name:
            # Deleted, or unbound (including a rollback's unbind — the
            # capacity returns to the pool the moment the modified event
            # lands).
            self.release(pod.uid)
        else:
            self.charge(pod)

    def handle_batch(self, events) -> None:
        for event in events:
            self.handle(event)

    # --- charging ---

    def charge(self, pod) -> None:
        chips, hbm = _pod_demand(pod)
        if chips == 0 and hbm == 0:
            return
        tenant = tenant_of(pod)
        with self._lock:
            if pod.uid in self._pods:
                return  # bind-event replay / reserve->bind: single charge
            self._pods[pod.uid] = (tenant, chips, hbm)
            use = self._usage.setdefault(tenant, [0, 0])
            use[0] += chips
            use[1] += hbm

    def release(self, uid: str) -> None:
        with self._lock:
            rec = self._pods.pop(uid, None)
            if rec is None:
                return
            tenant, chips, hbm = rec
            use = self._usage.get(tenant)
            if use is not None:
                use[0] = max(use[0] - chips, 0)
                use[1] = max(use[1] - hbm, 0)
                if use == [0, 0]:
                    del self._usage[tenant]

    # --- readers ---

    def capacity(self) -> "tuple[int, int]":
        with self._lock:
            return self._cap_chips, self._cap_hbm

    def usage(self, tenant: str) -> "tuple[int, int]":
        with self._lock:
            use = self._usage.get(tenant)
            return (use[0], use[1]) if use else (0, 0)

    def dominant_share(self, tenant: str) -> float:
        """max(chips share, HBM share) in [0, 1] — the DRF ordering key.
        An empty fleet puts every tenant at share 0 (pure FIFO)."""
        with self._lock:
            use = self._usage.get(tenant)
            if not use:
                return 0.0
            chip_share = use[0] / self._cap_chips if self._cap_chips else 0.0
            hbm_share = use[1] / self._cap_hbm if self._cap_hbm else 0.0
            return max(chip_share, hbm_share)

    def shares(self) -> "dict[str, float]":
        """Every tenant with nonzero usage -> dominant share (the
        yoda_tenant_dominant_share gauge)."""
        with self._lock:
            out: dict[str, float] = {}
            for tenant, use in self._usage.items():
                chip_share = (
                    use[0] / self._cap_chips if self._cap_chips else 0.0
                )
                hbm_share = use[1] / self._cap_hbm if self._cap_hbm else 0.0
                out[tenant] = max(chip_share, hbm_share)
            return out

    def quota_verdict(
        self, tenant: str, pod, *, chips_cap: int = 0, hbm_cap_mib: int = 0
    ) -> "str | None":
        """Why-pending verdict when admitting ``pod`` would push its
        tenant past a per-tenant quota, else None. Usage is BOUND usage,
        which only moves when binds land — so a gang gathered in one
        locked queue pass sees one consistent verdict for every member
        (all gather or all park; atomicity at gather granularity), and a
        gang admitted under-quota may finish binding past the cap: the
        overshoot is bounded by one admission's ask. 0 = unlimited."""
        chips, hbm = _pod_demand(pod)
        with self._lock:
            use = self._usage.get(tenant) or (0, 0)
            if chips_cap and use[0] + chips > chips_cap:
                return (
                    f"tenant {tenant} over chip quota: "
                    f"{use[0]} in use + {chips} asked > {chips_cap}"
                )
            if hbm_cap_mib and use[1] + hbm > hbm_cap_mib:
                return (
                    f"tenant {tenant} over HBM quota: "
                    f"{use[1]} MiB in use + {hbm} MiB asked > "
                    f"{hbm_cap_mib} MiB"
                )
        return None
