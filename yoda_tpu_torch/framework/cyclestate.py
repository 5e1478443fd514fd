"""Per-cycle scratch state shared across extension points.

The analog of the upstream ``framework.CycleState`` the reference writes its
max-collection data into under key ``"Max"`` with explicit Lock/Unlock
(reference pkg/yoda/collection/collection.go:53-55) and whose entries must
implement ``Clone`` (collection.go:23-28). Same contract here; the lock is a
real RLock because binding and Permit approval run off the cycle thread.

Counterpart of ``yoda_tpu/framework/cyclestate.py``, whole (with the
scheduler lanes' shard tag).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Protocol, runtime_checkable


@runtime_checkable
class StateData(Protocol):
    def clone(self) -> "StateData": ...


# Scheduler shard-out (framework/shards.py): the cycle's owning shard,
# written by a sharded Scheduler at cycle start and read by the shared
# ChipAccountant's Reserve hook — a claim made under a shard tag is
# STAGED (pending the optimistic commit validation) instead of final.
# Absent on unsharded stacks, so shard_count=1 never stages anything.
SHARD_STATE_KEY = "yoda-shard/id"


@dataclass(frozen=True)
class ShardTag:
    shard: str

    def clone(self) -> "ShardTag":
        return self


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
