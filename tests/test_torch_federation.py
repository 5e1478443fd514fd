"""chip_smoke's run (r) at its small size on the CPU, held against
yoda_tpu where both packages can drive it.

(r1), the federation: two ``ChaosCluster`` fronts of the run's fleet
layout, ``build_federation`` on a held clock, run (c)'s first wave at
home, federated plain and topology gangs spilling whole to the
secondary, a partition injected at a migration's first create (that gang
rolls back whole), the ladder walked to LOST while home serves run (b)'s
singletons, the heal and the rejoin resync, a second spillover pass that
the shared ledger holds back. Run on both packages (each its own
``federation``, ``standalone``, ``testing.chaos`` and agents), the
bindings of each cluster, the member states after every health pass, the
passes' migrations, the federation's metric series, the gangs the ledger
kept home, the resync's report and every gang's cluster are equal, and
each run holds (r1)'s gates.

(r3), the native agents: each package's ``NativeTpuAgent`` over one
library built from ``native/tpuinfo.cc`` publishes the v5e pool under
``YODA_TPUINFO_SPEC``, a stack binds run (b)'s singletons, the agents'
next publish charges the bound pods' HBM, a second round binds; the CRs
(timestamps masked) and the bindings are equal across packages.

(r2), the federated CLI with a dead remote and an agent process, runs on
the port only (a process of the port's CLI over the port's fake API
server) and holds its gates: ``/readyz`` 200, every singleton bound at
home, the remote at LOST with nothing written to it, the agent's pod on
its host.
"""

from __future__ import annotations

import pytest

from chip_smoke import (
    FEDERATION_SMALL,
    R1_PARITY,
    R3_PARITY,
    check_federation_run,
    run_federation,
)


def reference_modules() -> dict:
    import yoda_tpu.agent.fake_publisher as fake_publisher
    import yoda_tpu.agent.native as native
    import yoda_tpu.api.requests as requests
    import yoda_tpu.api.types as types
    import yoda_tpu.config as config
    import yoda_tpu.federation as federation
    import yoda_tpu.federation.federation as fed_impl
    import yoda_tpu.standalone as standalone
    from yoda_tpu.testing import chaos

    return {"standalone": standalone, "config": config, "types": types, "chaos": chaos,
            "requests": requests, "fake_publisher": fake_publisher, "native": native,
            "federation": federation, "fed_impl": fed_impl}


def port_modules() -> dict:
    from chip_smoke import port_federation

    return port_federation()


@pytest.fixture(scope="module")
def tpuinfo_lib() -> str:
    from yoda_tpu_torch.agent import native

    lib = native.build_library()
    if lib is None:
        pytest.skip("no g++ toolchain to build native/tpuinfo.cc")
    return str(lib)


class TestRunR:
    @pytest.mark.parametrize("part,keys", [("r1", R1_PARITY), ("r3", R3_PARITY)])
    def test_part_equals_the_reference(self, part, keys, tpuinfo_lib):
        runs = {}
        for pkg, mods in (("yoda_tpu", reference_modules()),
                          ("yoda_tpu_torch", port_modules())):
            mods["tpuinfo_lib"] = tpuinfo_lib
            runs[pkg] = run_federation("cpu", FEDERATION_SMALL, mods=mods, parts=(part,))
            check_federation_run(runs[pkg], FEDERATION_SMALL, card=False)
        ref, port = runs["yoda_tpu"][part], runs["yoda_tpu_torch"][part]
        assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}

    def test_the_port_run_holds_every_gate(self):
        """The whole run as chip_smoke drives it on the card, here on the
        host: (r1) and (r3) with their kept-launch counts (none on the
        host) and (r2)'s processes."""
        run = run_federation("cpu", FEDERATION_SMALL)
        assert set(run) == {"r1", "r2", "r3"}
        check_federation_run(run, FEDERATION_SMALL, card=False)
        for part in ("r1", "r2", "r3"):
            assert run[part]["kernels"]["launches"] == {
                "fleet_eval": 0, "joint_fit": 0, "update_rows": 0}
