"""ImageLocality scoring — upstream parity (inherited by the reference via
pkg/register/register.go:10).

Nodes that already hold the pod's container images score higher, weighted
by image size and damped by how widely each image is spread (an image on
most nodes is nearly free everywhere, so locality to it is worth little).
Upstream's exact shape:

    sum  = Σ over the pod's images present on the node:
              sizeBytes x (nodes holding the image / total nodes)
    score = clamp01((sum - minT) / (maxT - minT)) x 100
    minT  = 23 MB x numContainers,  maxT = 1000 MB x numContainers

For TPU workloads image pull time is usually dwarfed by checkpoint
restore, so the default weight is deliberately small relative to the
chip-metric weights — but the knob exists (config.Weights.image_locality)
and the data flows (K8sNode.images from status.images via the Node watch).

Counterpart of ``yoda_tpu/plugins/yoda/image_locality.py``, whole: the
batch path's half (``build_image_spread`` / ``image_locality_score``, read
by ``YodaBatch._preference_bonus``) and loop mode's ``ImageLocalityScore``
plugin, which reads the spread ``YodaPreFilter`` writes to CycleState.
"""

from __future__ import annotations

from typing import Mapping

from yoda_tpu_torch.api.types import PodSpec
from yoda_tpu_torch.config import Weights
from yoda_tpu_torch.framework.cyclestate import CycleState
from yoda_tpu_torch.framework.interfaces import NodeInfo, ScorePlugin, Status

MB = 1024 * 1024
MIN_THRESHOLD_MB = 23      # upstream minThreshold per container
MAX_THRESHOLD_MB = 1000    # upstream maxThreshold per container

IMAGE_SPREAD_KEY = "yoda-tpu/image-spread"


class ImageSpreadData:
    """Per-cycle fleet view for the pod's images: how many nodes hold
    each (the spread damping factor) and the fleet size. Built only when
    the pod names images AND any node reports image state — image-free
    pods and fleets pay nothing; in loop mode YodaPreFilter writes it to
    CycleState under ``IMAGE_SPREAD_KEY``."""

    def __init__(self, nodes_with: Mapping[str, int], total_nodes: int) -> None:
        self.nodes_with = dict(nodes_with)
        self.total_nodes = max(total_nodes, 1)

    def clone(self) -> "ImageSpreadData":
        return self


def image_size_on(images: Mapping[str, int], image: str) -> int | None:
    """Size of ``image`` on a node, or None. Upstream-style name
    normalization for the lookup: an untagged, undigested pod image also
    matches its ``:latest`` form (kubelet reports tagged names), so
    'gcr.io/app/server' finds 'gcr.io/app/server:latest'."""
    size = images.get(image)
    if size is not None:
        return size
    tail = image.rsplit("/", 1)[-1]
    if ":" not in tail and "@" not in tail:
        return images.get(f"{image}:latest")
    return None


def build_image_spread(snapshot, pod: PodSpec) -> ImageSpreadData | None:
    """One fleet walk for the pod's images (O(nodes), small constant);
    None when the pod names no images or no node reports any."""
    if not pod.container_images:
        return None
    wanted = set(pod.container_images)
    counts = dict.fromkeys(wanted, 0)
    any_images = False
    for ni in snapshot.infos():
        node = ni.node
        if node is None or not node.images:
            continue
        any_images = True
        for image in wanted:
            if image_size_on(node.images, image) is not None:
                counts[image] += 1
    if not any_images or not any(counts.values()):
        # No node holds ANY of the pod's images: every node scores 0, so
        # returning a spread object would only defeat the batch path's
        # O(N)-loop early exit (YodaBatch._preference_bonus).
        return None
    return ImageSpreadData(counts, len(snapshot))


def image_locality_score(
    pod: PodSpec, ni: NodeInfo, spread: ImageSpreadData
) -> int:
    """[0, 100] upstream ImageLocality score for one node."""
    node = ni.node
    if node is None or not node.images or not pod.container_images:
        return 0
    total = 0.0
    for image in pod.container_images:
        size = image_size_on(node.images, image)
        if size is None:
            continue
        total += size * (
            spread.nodes_with.get(image, 1) / spread.total_nodes
        )
    n = len(pod.container_images)
    min_t = MIN_THRESHOLD_MB * MB * n
    max_t = MAX_THRESHOLD_MB * MB * n
    frac = (total - min_t) / (max_t - min_t)
    return int(max(0.0, min(1.0, frac)) * 100)


class ImageLocalityScore(ScorePlugin):
    """Loop-mode Score plugin; the batch path adds the same value through
    YodaBatch._preference_bonus. Already on the final [0,100]-x-weight
    scale — ``normalize`` is the identity (the PreferredAffinityScore
    pattern)."""

    name = "yoda-image-locality"

    def __init__(self, weights: Weights | None = None) -> None:
        self.weights = weights or Weights()

    def score(
        self, state: CycleState, pod: PodSpec, node: NodeInfo
    ) -> tuple[int, Status]:
        if not self.weights.image_locality or not state.contains(
            IMAGE_SPREAD_KEY
        ):
            return 0, Status.ok()
        spread = state.read(IMAGE_SPREAD_KEY)
        assert isinstance(spread, ImageSpreadData)
        return (
            image_locality_score(pod, node, spread)
            * self.weights.image_locality,
            Status.ok(),
        )

    def normalize(
        self, state: CycleState, pod: PodSpec, scores: dict[str, int]
    ) -> Status:
        return Status.ok()
