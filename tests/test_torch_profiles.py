"""Scheduler profiles (``standalone.build_profile_stacks``: one stack per
schedulerName over one accountant, one cycle lock, one post-filter lock
and one metrics registry), held against yoda_tpu.

Every case of ``tests/test_profiles.py`` runs on both packages from the
reference's own source (``torch_refcases.run_case``), with its exact
assertions; none is left out.
"""

from __future__ import annotations

import pytest
from torch_refcases import PACKAGES, cases, run_case

REF = "test_profiles.py"
SKIP: "dict[str, str]" = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)
