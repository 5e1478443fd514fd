"""The port's bind pipeline (the gang plugin's pipelined release on the
``BindExecutor``, the executor's completion bookkeeping and stop event, the
scheduler's drain barrier and deferred rollbacks, the binder's
interruptible backoff and worker-side fencing), held against yoda_tpu.

Every case of ``tests/test_bind_pipeline.py`` runs on both packages from
the reference's own source (``torch_refcases.run_case``, the port's stacks
on the host). None is left out.

Beside them: chip_smoke.py's run (l3) at its small size, a seeded drive
over ``FakeCluster(bind_latency_s=0.002)`` at the default 8 workers (so
``bind_pipeline: auto`` pipelines it) of gang waves and singletons with one
injected bind failure inside a gang, run on both packages: bindings (gang
members as each gang's hosts, since a rolled-back gang's members requeue
in the order their binds settled), the pods each rollback unbound and the
Events must be equal, tolerance 0.
"""

from __future__ import annotations

import pytest
from torch_refcases import PACKAGES, cases, run_case

REF = "test_bind_pipeline.py"
SKIP: "dict[str, str]" = {}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", cases(REF, SKIP), ids=lambda c: c[0])
def test_reference_case(pkg, case, request, monkeypatch):
    run_case(pkg, REF, case, request, monkeypatch)


def _ref_modules() -> dict:
    from yoda_tpu import standalone
    from yoda_tpu.agent import fake_publisher
    from yoda_tpu.api import requests, types
    from yoda_tpu.cluster import fake
    from yoda_tpu.config import SchedulerConfig

    return dict(standalone=standalone, agent=fake_publisher, types=types, fake=fake,
                requests=requests, SchedulerConfig=SchedulerConfig)


class TestRunL3:
    def test_pipelined_drive_equals_the_reference(self):
        """chip_smoke's run (l3) at its small size: pipelined by ``auto``
        (``bind_latency_s`` 0.002 s, 8 workers) on both packages; a gang
        whose first member's bind fails once rolls back whole (every
        sibling had landed) and binds again. Bindings, gang hosts, the
        unbound pods and the Events are equal; each run holds its own
        checks."""
        from chip_smoke import (
            PIPELINE_PARITY, PIPELINE_SMALL, check_pipeline_run, run_pipeline,
        )

        port = run_pipeline("cpu", PIPELINE_SMALL)
        ref = run_pipeline("cpu", PIPELINE_SMALL, mods=_ref_modules())
        check_pipeline_run(port)
        check_pipeline_run(ref)
        assert {k: port[k] for k in PIPELINE_PARITY} == {k: ref[k] for k in PIPELINE_PARITY}
        assert port["rollbacks"] == [
            f"default/w1-fail-{i:02d}" for i in range(1, PIPELINE_SMALL["plain_size"])]
        reasons = {}
        for reason, pod, count in port["events"]:
            reasons.setdefault(reason, {})[pod] = count
        # Every member of the failing gang carries the gang-level reason.
        assert {p for p in reasons["GangRollback"]} == {
            f"default/w1-fail-{i:02d}" for i in range(PIPELINE_SMALL["plain_size"])}

    def test_rerun_in_a_second_process_equals_the_run(self):
        """chip_smoke reruns (l3) on the CPU in a spawned process beside
        the card's phases: that run equals the same run in this process."""
        from chip_smoke import PIPELINE_PARITY, PIPELINE_SMALL, SpawnedRerun, run_pipeline

        rerun = SpawnedRerun("run_pipeline", PIPELINE_SMALL, "run (l3)")
        try:
            got = rerun.result(timeout_s=300)
        finally:
            rerun.stop()
        want = run_pipeline("cpu", PIPELINE_SMALL)
        assert {k: got[k] for k in PIPELINE_PARITY} == {k: want[k] for k in PIPELINE_PARITY}
