"""Every case of ``tests/test_gang.py`` on both packages: gangs: atomic
placement, Permit, topology and coscheduling gangs, in both modes.

Each case runs from the reference's own source through
``torch_refcases.run_case`` (imports pointed at the port, the port's
``kernel_platform: auto`` mapped to the host), with its exact assertions.
Nothing is left out.
"""

from __future__ import annotations

import pytest
from torch_refcases import PACKAGES, cases, run_case

REF = "test_gang.py"
SKIP: dict = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)
