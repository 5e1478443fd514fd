"""Cluster backends: the in-memory fake API server, the real API server's
client, the informer cache, leader election, batched watch ingest and the
Event recorder (counterpart of yoda_tpu/cluster).

A watch-driven informer cache is the only reader: scheduling cycles see a
consistent snapshot and never touch the API server. ``FakeCluster`` plays
the API server for tests, demos and the card's smoke runs; ``KubeCluster``
is the real-cluster client on the same watch surface (stdlib-HTTP
list+watch loops feeding the same Event stream, plus pods/binding, CR
publish, eviction, nomination and Event writes), and ``LeaderElector``
the Lease-based leader election the CLI fences its binds on.
"""

from yoda_tpu_torch.cluster.fake import Event, FakeCluster
from yoda_tpu_torch.cluster.informer import InformerCache
from yoda_tpu_torch.cluster.kube import KubeApiClient, KubeApiConfig, KubeCluster
from yoda_tpu_torch.cluster.lease import LeaderElector

__all__ = [
    "Event",
    "FakeCluster",
    "InformerCache",
    "KubeApiClient",
    "KubeApiConfig",
    "KubeCluster",
    "LeaderElector",
]
