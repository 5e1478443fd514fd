"""The port's Lease-based leader election (yoda_tpu_torch/cluster/lease.py),
held against yoda_tpu.

Every case of ``tests/test_lease.py`` runs on both packages from the
reference's own source (``torch_refcases.run_case``) against each
package's own fake API server: acquire, renew, expiry takeover, orderly
release, margin validation, the run loop's failover and loss report, and
``TestCliFailover`` — two CLI replicas (``cli.main`` on threads, the
port's with its stack on the host) where exactly one schedules and the
standby takes over after the holder stops. None is left out.
"""

from __future__ import annotations

import pytest
from torch_refcases import PACKAGES, cases, run_case

REF = "test_lease.py"
SKIP: "dict[str, str]" = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)
