"""Every case of ``tests/test_ops.py`` on both packages:
``TestDeviceFleetKernel``, the reference's single-device kernel by its own
name (F3); the file's other cases run in test_torch_loop.py.

Each case runs from the reference's own source through
``torch_refcases.run_case`` (imports pointed at the port, the port's
``kernel_platform: auto`` mapped to the host), with its exact assertions.
Left out, each with where it runs or the part it waits for: see ``SKIP``.
"""

from __future__ import annotations

import pytest
from torch_refcases import PACKAGES, cases, run_case

REF = "test_ops.py"
# test_torch_loop.py runs every other case of the file.
_HERE = {
    "TestDeviceFleetKernel": None,
    "TestBatchPlatformPolicy": "the TPU-measured auto platform policy, not "
    "carried over (ROADMAP B7)",
}
SKIP = {
    c[0].split("[")[0]: _HERE.get(c[1], "run by test_torch_loop.py")
    for c in cases(REF, {})
    if _HERE.get(c[1], "") is not None
}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)
