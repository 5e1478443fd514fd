"""Every case of ``tests/test_native_agent.py`` on both packages: the C++
host metrics reader (``native/tpuinfo.cc``) through each package's ctypes
binding, the native agent publishing a CR a stack binds against, bound-pod
HBM attribution, the runtime reader and its overlays over device
stand-ins, the HBM source probe, the typed libtpu metrics client against
each package's fake gRPC service, and the libtpu overlay with external
usage and duty cycle.

Each case runs from the reference's own source through
``torch_refcases.run_case`` (imports pointed at the port, the port's
``kernel_platform: auto`` mapped to the host), with its exact assertions.
The ``lib`` fixture is the reference's own: it builds ``native/``'s
library through the reference's Makefile when it is missing and loads it
(``$YODA_TPUINFO_SO`` overrides the path), so both packages read the same
library. ``TestRealChip`` skips on both packages unless
``YODA_REAL_TPU_TEST`` is set, as the reference's own file does. None is
left out.
"""

from __future__ import annotations

import pytest
from torch_refcases import PACKAGES, cases, run_case

REF = "test_native_agent.py"
SKIP: dict = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)
