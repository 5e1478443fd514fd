"""The port's API-server client (yoda_tpu_torch/cluster/kube.py), held
against yoda_tpu.

Every case of ``tests/test_kube.py`` runs on both packages from the
reference's own source (``torch_refcases.run_case``) against each
package's own in-process fake API server (``yoda_tpu_torch.testing`` on
the port side), with its exact assertions: list/watch with
resourceVersion resume, 410-Gone relists (in-band and HTTP), relist
diffs, the pods/binding subresource, evictions, nomination patches, the
Node / Namespace / PVC / PV / PDB watches with their "synced" sentinels
and RBAC degradation, and ``TestKubeE2E`` (a whole stack serving through
``Scheduler.serve_forever`` over HTTP). None is left out.
"""

from __future__ import annotations

import pytest
from torch_refcases import PACKAGES, cases, run_case

REF = "test_kube.py"
SKIP: "dict[str, str]" = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)
