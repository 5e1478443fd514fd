"""Every case of ``tests/test_chaos.py`` on both packages: the seeded
fault plans, bind retry and gang rollback, leader fencing, the bind
pipeline under faults, metric staleness, the crash and contention sweeps,
each over the package's own ``testing.chaos`` (``ChaosCluster`` wraps that
package's ``FakeCluster``; the contention mode builds its ``ShardSet``).
The reference's ``slow`` sweeps stay slow.

Each case runs from the reference's own source through
``torch_refcases.run_case`` (imports pointed at the port, the port's
``kernel_platform: auto`` mapped to the host), with its exact assertions,
``TestDispatchFallback``'s degraded-mode chain included. No case is left
out (``SKIP`` is empty).
"""

from __future__ import annotations

import pytest
from torch_refcases import PACKAGES, cases, run_case

REF = "test_chaos.py"
SKIP: "dict[str, str]" = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)
