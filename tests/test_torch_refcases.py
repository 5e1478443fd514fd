"""Self-test of the parity harness (``tests/torch_refcases.py``) on a small
synthetic module written in the reference's style:

- ``cases()`` crosses a class-level ``pytest.mark.parametrize`` with the
  method's own parameter sets, with the ids and the order pytest gives the
  same module when it collects it (a subprocess of ``pytest
  --collect-only``); a ``SKIP`` may name a whole class;
- ``run_case()`` calls the class's ``setup_method`` before the case and
  its ``teardown_method`` after it, also when the case fails.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap

import pytest
import torch_refcases
from torch_refcases import cases, run_case

SYNTHETIC = textwrap.dedent('''
    from pathlib import Path

    import pytest

    MODES = ["batch", "loop"]


    def log(line):
        with open(Path(__file__).with_name("calls.log"), "a") as f:
            f.write(line + "\\n")


    @pytest.mark.parametrize("mode", MODES)
    class TestCrossed:
        @pytest.mark.parametrize("n", [1, 2, 3])
        def test_sized(self, n, mode):
            log(f"sized {n} {mode}")

        def test_plain(self, mode):
            log(f"plain {mode}")


    class TestSetup:
        def setup_method(self):
            self.docs = ["a", "b"]
            log("setup")

        def teardown_method(self, method):
            log(f"teardown {method.__name__}")

        def test_reads_docs(self):
            assert self.docs == ["a", "b"]
            log("reads")

        def test_fails(self):
            log("fails")
            assert self.docs == []


    class TestSkipped:
        def test_one(self):
            raise AssertionError("a skipped class ran")
''')


@pytest.fixture
def ref_module(tmp_path, monkeypatch):
    (tmp_path / "test_synthetic.py").write_text(SYNTHETIC)
    monkeypatch.setattr(torch_refcases, "TESTS", tmp_path)
    return tmp_path


def ids(params) -> list:
    return [c[0] if isinstance(c, tuple) else c.values[0][0] for c in params]


class TestCases:
    def test_ids_and_order_follow_pytest(self, ref_module):
        out = subprocess.run(
            [sys.executable, "-m", "pytest", "--collect-only", "-q", "-p", "no:randomly",
             "-p", "no:cacheprovider", str(ref_module / "test_synthetic.py")],
            capture_output=True, text=True, cwd=ref_module, timeout=120,
        ).stdout
        collected = [line.split("::", 1)[1] for line in out.splitlines() if "::" in line]
        assert len(collected) == 11
        assert ids(cases("test_synthetic.py", {})) == collected
        assert collected[:2] == ["TestCrossed::test_sized[1-batch]",
                                 "TestCrossed::test_sized[1-loop]"]

    def test_params_cross_the_class_and_the_method(self, ref_module):
        got = {c[0]: c[3] for c in cases("test_synthetic.py", {})}
        assert got["TestCrossed::test_sized[3-loop]"] == {"n": 3, "mode": "loop"}
        assert got["TestCrossed::test_plain[batch]"] == {"mode": "batch"}

    def test_skip_names_a_class(self, ref_module):
        kept = ids(cases("test_synthetic.py", {"TestSkipped": "waits for a part"}))
        assert not [c for c in kept if c.startswith("TestSkipped")]
        assert len(kept) == 10


class TestRunCase:
    @pytest.mark.parametrize("pkg", torch_refcases.PACKAGES)
    def test_setup_and_teardown_around_the_case(self, ref_module, pkg, request,
                                                monkeypatch):
        by_id = {c[0]: c for c in cases("test_synthetic.py", {})}
        run_case(pkg, "test_synthetic.py", by_id["TestSetup::test_reads_docs"], request,
                 monkeypatch)
        with pytest.raises(AssertionError):
            run_case(pkg, "test_synthetic.py", by_id["TestSetup::test_fails"], request,
                     monkeypatch)
        run_case(pkg, "test_synthetic.py", by_id["TestCrossed::test_sized[2-loop]"],
                 request, monkeypatch)
        assert (ref_module / "calls.log").read_text().splitlines() == [
            "setup", "reads", "teardown test_reads_docs",
            "setup", "fails", "teardown test_fails",
            "sized 2 loop",
        ]
