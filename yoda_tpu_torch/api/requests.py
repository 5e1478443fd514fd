"""Pod-label request parsing: the user-facing constraint API.

The reference's entire user API is four pod labels (reference
readme.md:27-69, SURVEY.md §1 "User-facing API surface"):

    scv/number    -> tpu/chips       chips required on the node
    scv/memory    -> tpu/hbm         free HBM required PER CHIP (quantity)
    scv/clock     -> tpu/clock       minimum chip clock, MHz (>= semantics —
                                     the reference filtered on EXACT equality,
                                     filter/filter.go:57, rejecting faster
                                     cards; fixed here)
    scv/priority  -> tpu/priority    scheduling-queue priority (higher first)

Net-new labels (no reference analog; mandated by BASELINE.json north star):

    tpu/generation   minimum TPU generation, e.g. "v5e" (ordered by
                     GENERATION_RANK)
    tpu/gang         gang name: all pods sharing it are placed atomically
    tpu/gang-size    number of pods in the gang
                     (coscheduling compat: pod-group.scheduling.sigs.k8s.io/
                     name + /min-available and scheduling.x-k8s.io/pod-group
                     alias these two; explicit tpu/* labels win)
    tpu/topology     ICI slice shape "AxBxC" (hosts), e.g. "2x2x2"
    tpu/multislice   number of tpu/topology blocks the gang spans (the
                     Multislice pattern: ICI within each block, DCN
                     between blocks); gang size = multislice x prod(dims)

Parsing is strict: a malformed label raises ``LabelParseError`` and the pod is
reported Unschedulable with the message, instead of the reference's
silent-zero behavior (filter/filter.go:60-74, SURVEY.md §3.4 quirk 3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

from yoda_tpu_torch.api.quantity import (
    QuantityError,
    parse_int,
    parse_quantity,
    parse_signed_int,
)
from yoda_tpu_torch.api.types import GENERATION_RANK

# Label keys.
CHIPS = "tpu/chips"
HBM = "tpu/hbm"
CLOCK = "tpu/clock"
GENERATION = "tpu/generation"
PRIORITY = "tpu/priority"
GANG = "tpu/gang"
GANG_SIZE = "tpu/gang-size"
# Compat aliases for workloads written for the sig-scheduling coscheduling
# plugin: its PodGroup label conventions map onto gangs (min-available =
# all-or-nothing size). Explicit tpu/* labels win over aliases.
PG_NAME_LITE = "pod-group.scheduling.sigs.k8s.io/name"
PG_MIN_LITE = "pod-group.scheduling.sigs.k8s.io/min-available"
PG_NAME = "scheduling.x-k8s.io/pod-group"
TOPOLOGY = "tpu/topology"
MULTISLICE = "tpu/multislice"
# Elastic gangs (goodput-driven rebalancing): the gang may run with any
# member count in [min-members, max-members]; tpu/gang-size remains the
# DESIRED size. The background rebalancer shrinks an elastic gang toward
# min-members under contention (surplus members park) and grows it toward
# max-members into free capacity. Plain gangs only — a topology gang's
# size is pinned by its ICI block shape.
MIN_MEMBERS = "tpu/min-members"
MAX_MEMBERS = "tpu/max-members"


class LabelParseError(ValueError):
    """A tpu/* label failed strict validation."""


@dataclass(frozen=True)
class GangSpec:
    name: str
    size: int
    topology: tuple[int, ...] | None = None  # hosts per ICI dimension
    # Number of disjoint `topology` blocks the gang spans (Multislice:
    # data parallelism over DCN between blocks, ICI within each).
    # size == slices x prod(topology) when topology is set.
    slices: int = 1
    # Elastic bounds (tpu/min-members / tpu/max-members): None = rigid.
    # When set, the gang runs whole at any EFFECTIVE size in
    # [min_size, max_size]; the rebalancer owns the effective size
    # (GangPlugin.set_effective_size) and `size` stays the desired one.
    min_size: int | None = None
    max_size: int | None = None

    @property
    def hosts(self) -> int:
        return self.size

    @property
    def elastic(self) -> bool:
        return self.min_size is not None or self.max_size is not None

    @property
    def floor(self) -> int:
        """Smallest member count the gang may run at."""
        return self.min_size if self.min_size is not None else self.size

    @property
    def ceiling(self) -> int:
        """Largest member count the gang may grow to."""
        return self.max_size if self.max_size is not None else self.size


@dataclass(frozen=True)
class TpuRequest:
    """Parsed, validated scheduling constraints for one pod."""

    chips: int | None = None          # None: no explicit count (see effective_chips)
    hbm_per_chip: int = 0             # bytes of free HBM required per chip
    min_clock_mhz: int = 0
    min_generation_rank: int = 0
    priority: int = 0
    gang: GangSpec | None = None

    @property
    def effective_chips(self) -> int:
        """Chip count used for per-chip checks. The reference defaults to one
        qualifying card when ``scv/number`` is absent (filter/filter.go:14-15:
        requires CardNumber > 0, number = 1)."""
        return 1 if self.chips is None else self.chips

    @property
    def wants_tpu(self) -> bool:
        """True when the pod expresses any TPU constraint at all."""
        return (
            self.chips is not None
            or self.hbm_per_chip > 0
            or self.min_clock_mhz > 0
            or self.min_generation_rank > 0
            or self.gang is not None
        )


def parse_topology(text: str) -> tuple[int, ...]:
    """Parse ``"AxBxC"`` (1–3 dims) into a host-count-per-dimension tuple."""
    parts = text.strip().lower().split("x")
    if not 1 <= len(parts) <= 3:
        raise LabelParseError(f"{TOPOLOGY} must have 1-3 dims, got {text!r}")
    try:
        dims = tuple(parse_int(p, field=TOPOLOGY) for p in parts)
    except QuantityError as e:
        raise LabelParseError(f"malformed {TOPOLOGY} {text!r}") from e
    if any(d < 1 for d in dims):
        raise LabelParseError(f"{TOPOLOGY} dims must be >= 1, got {text!r}")
    return dims


def gang_name_label(labels: Mapping[str, str]) -> tuple[str | None, str]:
    """(gang name, the label key it came from) — the ONE place alias
    resolution lives. Every reader of gang membership (parse_request, the
    gang plugin's watch handler, preemption's bound-member pinning) must go
    through this, or pods ganged only via the coscheduling alias labels
    become invisible to that reader."""
    if GANG in labels:
        return labels[GANG], GANG
    for alias in (PG_NAME_LITE, PG_NAME):
        if alias in labels:
            return labels[alias], alias
    return None, GANG


def gang_name_of(labels: Mapping[str, str]) -> str | None:
    """The pod's gang name (alias-aware, stripped), or None."""
    raw, _ = gang_name_label(labels)
    if raw is None:
        return None
    return raw.strip() or None


def parse_request(
    labels: Mapping[str, str], *, tpu_limit: int = 0, spec_priority: int = 0
) -> TpuRequest:
    """Parse a pod's labels into a ``TpuRequest``. Strict: raises
    ``LabelParseError`` on any malformed ``tpu/*`` value.

    ``tpu_limit`` carries the pod's ``google.com/tpu`` container resource
    limit (the way unmodified GKE TPU workloads request chips — no
    reference analog, the reference was label-only): it becomes the chip
    count when no ``tpu/chips`` label is present; an explicit label wins."""
    try:
        chips = parse_int(labels[CHIPS], field=CHIPS) if CHIPS in labels else None
        hbm = parse_quantity(labels[HBM]) if HBM in labels else 0
        clock = parse_int(labels[CLOCK], field=CLOCK) if CLOCK in labels else 0
    except QuantityError as e:
        raise LabelParseError(str(e)) from e
    if chips is None and tpu_limit > 0:
        chips = tpu_limit

    gen_rank = 0
    if GENERATION in labels:
        gen = labels[GENERATION].strip().lower()
        if gen not in GENERATION_RANK:
            raise LabelParseError(
                f"unknown {GENERATION} {labels[GENERATION]!r}; "
                f"expected one of {sorted(GENERATION_RANK)}"
            )
        gen_rank = GENERATION_RANK[gen]

    priority = spec_priority
    if PRIORITY in labels:
        # Queue priority may be negative (the reference's strconv.Atoi accepts
        # negatives, sort/sort.go:14) — parse as a signed int, but strictly.
        try:
            priority = parse_signed_int(labels[PRIORITY], field=PRIORITY)
        except QuantityError as e:
            raise LabelParseError(str(e)) from e

    # Coscheduling-compat aliases resolve to the tpu/* fields; explicit
    # tpu/* labels win (an unmodified PodGroup workload gangs correctly,
    # a migrated one can override).
    gang_raw, gang_key = gang_name_label(labels)
    size_raw = labels.get(GANG_SIZE)
    size_key = GANG_SIZE
    if size_raw is None and PG_MIN_LITE in labels:
        size_raw, size_key = labels[PG_MIN_LITE], PG_MIN_LITE

    gang = None
    if (
        gang_raw is not None
        or size_raw is not None
        or TOPOLOGY in labels
        or MULTISLICE in labels
        or MIN_MEMBERS in labels
        or MAX_MEMBERS in labels
    ):
        if gang_raw is None:
            present = [
                k
                for k in (size_key, TOPOLOGY, MULTISLICE, MIN_MEMBERS, MAX_MEMBERS)
                if k in labels
            ]
            raise LabelParseError(
                f"{'/'.join(present)} require {GANG} "
                f"(or the {PG_NAME_LITE} / {PG_NAME} alias)"
            )
        name = gang_raw.strip()
        if not name:
            raise LabelParseError(f"{gang_key} must be non-empty")
        topology = parse_topology(labels[TOPOLOGY]) if TOPOLOGY in labels else None
        n_slices = 1
        if MULTISLICE in labels:
            if topology is None:
                raise LabelParseError(f"{MULTISLICE} requires {TOPOLOGY}")
            try:
                n_slices = parse_int(labels[MULTISLICE], field=MULTISLICE)
            except QuantityError as e:
                raise LabelParseError(str(e)) from e
            if n_slices < 1:
                raise LabelParseError(f"{MULTISLICE} must be >= 1")
        if size_raw is not None:
            try:
                size = parse_int(size_raw, field=size_key)
            except QuantityError as e:
                raise LabelParseError(str(e)) from e
            if size < 1:
                raise LabelParseError(f"{size_key} must be >= 1")
        elif topology is not None:
            size = n_slices * math.prod(topology)
        else:
            raise LabelParseError(
                f"{gang_key} requires {GANG_SIZE} (or {PG_MIN_LITE}) "
                f"or {TOPOLOGY}"
            )
        if topology is not None:
            expected = n_slices * math.prod(topology)
            if expected != size:
                what = f"{TOPOLOGY} {labels[TOPOLOGY]!r}"
                if MULTISLICE in labels:
                    what += f" x {MULTISLICE} {n_slices}"
                raise LabelParseError(
                    f"{what} implies {expected} hosts but {GANG_SIZE} is {size}"
                )
        min_size = max_size = None
        if MIN_MEMBERS in labels or MAX_MEMBERS in labels:
            if topology is not None:
                raise LabelParseError(
                    f"{MIN_MEMBERS}/{MAX_MEMBERS} apply to plain gangs only "
                    f"(a {TOPOLOGY} gang's size is pinned by its ICI block)"
                )
            if MIN_MEMBERS in labels:
                try:
                    min_size = parse_int(labels[MIN_MEMBERS], field=MIN_MEMBERS)
                except QuantityError as e:
                    raise LabelParseError(str(e)) from e
                if not 1 <= min_size <= size:
                    raise LabelParseError(
                        f"{MIN_MEMBERS} must be in [1, {GANG_SIZE}={size}], "
                        f"got {min_size}"
                    )
            if MAX_MEMBERS in labels:
                try:
                    max_size = parse_int(labels[MAX_MEMBERS], field=MAX_MEMBERS)
                except QuantityError as e:
                    raise LabelParseError(str(e)) from e
                if max_size < size:
                    raise LabelParseError(
                        f"{MAX_MEMBERS} must be >= {GANG_SIZE}={size}, "
                        f"got {max_size}"
                    )
        gang = GangSpec(
            name=name, size=size, topology=topology, slices=n_slices,
            min_size=min_size, max_size=max_size,
        )

    return TpuRequest(
        chips=chips,
        hbm_per_chip=hbm,
        min_clock_mhz=clock,
        min_generation_rank=gen_rank,
        priority=priority,
        gang=gang,
    )


def pod_request(pod) -> TpuRequest:
    """Parse a pod's scheduling constraints: ``tpu/*`` labels plus the GKE
    ``google.com/tpu`` container resource limit as the chip-count fallback
    (api.types.PodSpec.tpu_resource_limit). Use this — not bare
    ``parse_request(pod.labels)`` — wherever a whole pod is in hand, so
    label pods and resource-limit pods are accounted identically.

    Memoized per pod object (TpuRequest is frozen): snapshot pods stored by
    the informer are re-parsed every scheduling cycle (scoring, accounting,
    claims, fleet lowering) — those repeats hit the memo. Watch events
    decode fresh PodSpec objects, so they always miss. In-place label edits
    are re-detected by the input-key comparison, so the memo can never
    serve stale constraints."""
    key = (
        tuple(sorted(pod.labels.items())),
        getattr(pod, "tpu_resource_limit", 0),
        getattr(pod, "spec_priority", 0),
    )
    memo = getattr(pod, "_req_memo", None)
    if memo is not None and memo[0] == key:
        return memo[1]
    req = parse_request(pod.labels, tpu_limit=key[1], spec_priority=key[2])
    try:
        pod._req_memo = (key, req)
    except Exception:  # noqa: BLE001 — slots/frozen pods just skip the memo
        pass
    return req
