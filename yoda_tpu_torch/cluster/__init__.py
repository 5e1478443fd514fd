"""Cluster backends: the in-memory fake API server, the informer cache,
batched watch ingest and the Event recorder (counterpart of
yoda_tpu/cluster).

A watch-driven informer cache is the only reader: scheduling cycles see a
consistent snapshot and never touch the API server. ``FakeCluster`` plays
the API server for tests, demos and the card's smoke runs. Left out until
a later slice: ``KubeCluster``, ``KubeApiClient`` and ``KubeApiConfig``
(the real API server's list+watch client) and ``LeaderElector`` (the
Lease-based leader election), which wait for the process and the real API
server.
"""

from yoda_tpu_torch.cluster.fake import Event, FakeCluster
from yoda_tpu_torch.cluster.informer import InformerCache

__all__ = ["Event", "FakeCluster", "InformerCache"]
