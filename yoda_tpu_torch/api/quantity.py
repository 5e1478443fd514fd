"""Kubernetes-style quantity parsing for HBM requests.

The reference parses its ``scv/memory`` label with ``strconv.Atoi`` and
silently maps any parse error to 0 (reference pkg/yoda/filter/filter.go:60-74),
so ``scv/memory: "8GB"`` meant "0 MB required" — a pod would land on a node
with no free memory at all. Here parsing is strict: malformed quantities raise
``QuantityError``, which the filter turns into an Unschedulable status with a
human-readable message instead of a silent misplacement.

Units are the Kubernetes resource.Quantity suffixes relevant to memory:
binary (Ki, Mi, Gi, Ti, Pi, Ei) and decimal (k/K, M, G, T, P, E). Milli
("m") and exponent notation are not supported — they are meaningless for
HBM sizes. A bare number is mebibytes, for parity with the reference's
``scv/memory`` MB convention (reference readme.md:27-40).
"""

from __future__ import annotations

import math
import re
from decimal import Decimal

_BINARY = {
    "Ki": 1 << 10,
    "Mi": 1 << 20,
    "Gi": 1 << 30,
    "Ti": 1 << 40,
    "Pi": 1 << 50,
    "Ei": 1 << 60,
}
_DECIMAL = {
    "k": 10**3,
    "K": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}

_QUANTITY_RE = re.compile(r"^(\d+(?:\.\d+)?)([A-Za-z]*)$")
_INT_RE = re.compile(r"^-?\d+$")


class QuantityError(ValueError):
    """Raised for malformed quantity strings (strict, unlike the reference)."""


def parse_quantity(text: str, *, default_unit: int = 1 << 20) -> int:
    """Parse ``text`` into bytes. Bare numbers are scaled by ``default_unit``
    (MiB by default, mirroring the reference's MB-denominated ``scv/memory``).

    Raises ``QuantityError`` on anything that is not a non-negative quantity.
    """
    if not isinstance(text, str):
        raise QuantityError(f"quantity must be a string, got {type(text).__name__}")
    m = _QUANTITY_RE.match(text.strip())
    if not m:
        raise QuantityError(f"malformed quantity {text!r}")
    value, suffix = m.group(1), m.group(2)
    if suffix == "":
        scale = default_unit
    elif suffix in _BINARY:
        scale = _BINARY[suffix]
    elif suffix in _DECIMAL:
        scale = _DECIMAL[suffix]
    else:
        raise QuantityError(f"unknown unit suffix {suffix!r} in quantity {text!r}")
    return int(float(value) * scale)


def parse_cpu(text: str) -> int:
    """Parse a Kubernetes CPU quantity into millicores: ``"500m"`` -> 500,
    ``"2"`` -> 2000, ``"1.5"`` -> 1500, ``"100.5m"`` -> 101 (fractional
    milli rounds UP, as upstream resource.Quantity does), ``"1e3"`` -> 10^6,
    ``"100e-3"`` -> 100. Negative results are rejected. Strict
    (QuantityError on anything else) — callers that must tolerate wild pod
    specs wrap this."""
    if not isinstance(text, str):
        raise QuantityError(f"cpu must be a string, got {type(text).__name__}")
    s = text.strip()
    if s.endswith("m"):
        body = s[:-1]
        if not re.match(r"^\d+(?:\.\d+)?$", body):
            raise QuantityError(f"malformed cpu quantity {text!r}")
        return math.ceil(Decimal(body))
    m = re.match(r"^\d+(?:\.\d+)?(?:[eE]([+-]?)(\d+))?$", s)
    if not m:
        raise QuantityError(f"malformed cpu quantity {text!r}")
    # Bounded POSITIVE exponent: Decimal parses "9e999999999" lazily but
    # ceil() materializes a billion-digit int — a one-pod-spec DoS.
    # Upstream resource.Quantity likewise caps magnitude (int64 + scale
    # limits). Negative exponents are cheap (they just round up to 1m).
    if m.group(2) is not None and m.group(1) != "-" and int(m.group(2)) > 18:
        raise QuantityError(f"cpu quantity exponent out of range in {text!r}")
    return math.ceil(Decimal(s) * 1000)


def parse_int(text: str, *, field: str = "value") -> int:
    """Parse a non-negative integer strictly (no silent-zero, see module doc)."""
    if not isinstance(text, str):
        raise QuantityError(f"{field} must be a string, got {type(text).__name__}")
    s = text.strip()
    if not _INT_RE.match(s):
        raise QuantityError(f"malformed {field} {text!r}")
    value = int(s)
    if value < 0:
        raise QuantityError(f"{field} must be non-negative, got {value}")
    return value


def parse_signed_int(text: str, *, field: str = "value") -> int:
    """Strict signed-integer parse (no underscores, no leading '+')."""
    if not isinstance(text, str):
        raise QuantityError(f"{field} must be a string, got {type(text).__name__}")
    s = text.strip()
    if not _INT_RE.match(s):
        raise QuantityError(f"malformed {field} {text!r}")
    return int(s)
