"""Every case of ``tests/test_burst.py`` on both packages: the multi-pod
burst dispatch; its loop-mode case runs in test_torch_loop.py.

Each case runs from the reference's own source through
``torch_refcases.run_case`` (imports pointed at the port, the port's
``kernel_platform: auto`` mapped to the host), with its exact assertions.
Left out, each with where it runs or the part it waits for: see ``SKIP``.
"""

from __future__ import annotations

import pytest
from torch_refcases import PACKAGES, cases, run_case

REF = "test_burst.py"
SKIP = {
    "TestBurstConfig::test_batch_requests_requires_batch_mode":
        "run by test_torch_loop.py",
}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)
