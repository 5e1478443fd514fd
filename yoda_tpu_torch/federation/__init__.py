"""Federated multi-cluster scheduling: several cluster fronts behind one
scheduler, with partition-tolerant degradation.

Every other robustness layer (chaos hardening, the bind pipeline,
crash-safe failover) assumes a single cluster front — one watch stream, one
reconciler, one failure domain — so a partitioned or dead API server still
would take the whole scheduler down with it. This package closes that gap:

- :mod:`yoda_tpu_torch.federation.health` — a per-cluster health state machine
  (``UP -> DEGRADED -> PARTITIONED -> LOST``) driven by watch-stream
  staleness (``InformerCache.last_event_age_s``), probe deadlines, and the
  transient-error classifier in ``cluster/retry.py``.
- :mod:`yoda_tpu_torch.federation.federation` — the ``Federation`` coordinator:
  one fully-wired stack (and therefore one warm-start ``Reconciler``) per
  cluster front, per-cluster fencing that keeps a sick cluster's binds off
  the API without blocking any serve loop, spillover routing that migrates
  a gang the home cluster cannot fit WHOLE onto exactly one secondary
  cluster (all-or-nothing, never split), and rejoin handling that
  warm-starts a healed cluster through its reconciler's resync while the
  other clusters keep serving.

Assemble one with ``standalone.build_federation``.
"""

from yoda_tpu_torch.federation.federation import Federation, FederationMember
from yoda_tpu_torch.federation.health import ClusterHealthMonitor, ClusterState

__all__ = [
    "ClusterHealthMonitor",
    "ClusterState",
    "Federation",
    "FederationMember",
]
