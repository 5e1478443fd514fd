"""Per-cycle scratch state shared across extension points.

The analog of the upstream ``framework.CycleState`` the reference writes its
max-collection data into under key ``"Max"`` with explicit Lock/Unlock
(reference pkg/yoda/collection/collection.go:53-55) and whose entries must
implement ``Clone`` (collection.go:23-28). Same contract here; the lock is a
real RLock because binding and Permit approval run off the cycle thread.

Counterpart of ``yoda_tpu/framework/cyclestate.py``; the shard tag waits
for the port of scheduler shard-out.
"""

from __future__ import annotations

import threading
from typing import Protocol, runtime_checkable


@runtime_checkable
class StateData(Protocol):
    def clone(self) -> "StateData": ...


class CycleState:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._data: dict[str, StateData] = {}

    def write(self, key: str, value: StateData) -> None:
        with self._lock:
            self._data[key] = value

    def read(self, key: str) -> StateData:
        with self._lock:
            try:
                return self._data[key]
            except KeyError:
                raise KeyError(f"no state for key {key!r} in CycleState") from None

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def clone(self) -> "CycleState":
        c = CycleState()
        with self._lock:
            for k, v in self._data.items():
                c._data[k] = v.clone()
        return c
