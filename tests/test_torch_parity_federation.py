"""Every case of ``tests/test_federation.py`` on both packages: the
informer's watch-staleness clock, the cluster health ladder (silence,
non-retryable probe errors, watch events as contact, threshold checks),
per-member fencing and degraded readiness, whole-gang spillover with the
shared consumption ledger and its rollback on a partition, and the rejoin
resync that recovers partition-era work, each over the package's own
``federation``, ``standalone.build_federation`` and ``testing.chaos``
(``ChaosCluster`` wraps that package's ``FakeCluster``).

Each case runs from the reference's own source through
``torch_refcases.run_case`` (imports pointed at the port, the port's
``kernel_platform: auto`` mapped to the host), with its exact assertions.
None is left out.
"""

from __future__ import annotations

import pytest
from torch_refcases import PACKAGES, cases, run_case

REF = "test_federation.py"
SKIP: dict = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)
