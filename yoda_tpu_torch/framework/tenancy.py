"""Which tenant a pod bills to.

Counterpart of ``yoda_tpu/framework/tenancy.py``, ported only as far as the
SLO engine needs it: ``tenant_of`` and its label constant. A tenant is a
namespace, overridable per pod via the ``tpu/tenant`` label. Left out until
a later slice: ``TenantLedger`` (the watch-driven per-tenant usage, DRF
dominant shares and quota verdicts) and the tenant-sharded queue it feeds.
"""

from __future__ import annotations

TENANT_LABEL = "tpu/tenant"


def tenant_of(pod) -> str:
    """The tenant a pod bills to: the ``tpu/tenant`` label when present,
    else the pod's namespace."""
    return pod.labels.get(TENANT_LABEL) or pod.namespace
