"""Verbosity-leveled operational logging — the klog ``--v`` analog.

The reference follows every scheduling decision from its stdout: per-pod
filter entry, collection, and final scores log at ``klog.V(3)`` (reference
pkg/yoda/scheduler.go:58,67,143) and the Deployment runs ``--v=3``
(reference deploy/yoda-scheduler.yaml:62). This module maps that model onto
stdlib ``logging`` for the whole ``yoda_tpu_torch`` logger tree:

    --v=0   WARNING  (failures and anomalies only)
    --v=1   INFO     (one line per scheduling outcome, gang/lease
                      transitions, preemption victims)
    --v>=3  DEBUG    (per-node filter rejections and score detail — the
                      reference's V(3) decision logs)

Loggers stay cheap when disabled: decision-detail call sites guard with
``isEnabledFor`` before building per-node strings.
"""

from __future__ import annotations

import logging
import sys

ROOT = "yoda_tpu_torch"


def level_for(verbosity: int) -> int:
    if verbosity >= 3:
        return logging.DEBUG
    if verbosity >= 1:
        return logging.INFO
    return logging.WARNING


def configure_logging(verbosity: int = 0, stream=None) -> None:
    """Configure the ``yoda_tpu_torch`` logger tree for a CLI process. Idempotent:
    re-running adjusts the level without stacking handlers (tests and
    embedded callers may call main() repeatedly)."""
    root = logging.getLogger(ROOT)
    root.setLevel(level_for(verbosity))
    if not any(isinstance(h, _YodaHandler) for h in root.handlers):
        handler = _YodaHandler(stream or sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s.%(msecs)03d %(levelname).1s %(name)s] %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        root.addHandler(handler)


class _YodaHandler(logging.StreamHandler):
    """Marker subclass so configure_logging can recognize its own handler."""
