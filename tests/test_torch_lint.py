"""The project's invariant gate (``tools.yodalint``) over the port.

Every pass of ``tools.yodalint`` runs over ``yoda_tpu_torch`` through the
same ``Project`` / ``run_all`` machinery that gates the JAX package
(``tests/test_yodalint.py``); ``tools/`` is not edited. A pass whose
constants name ``yoda_tpu/`` paths gets a port-side copy of them here:
``lock-discipline``'s module lock levels (``MODULE_LEVELS``) and
``journal-discipline``'s exempt journal package (``TERM_EXEMPT`` /
``APPEND_EXEMPT``). Each pass must read at least one port module, so a
pass keyed to a reference path cannot report zero without looking.

The port must have no finding at all. The last two, the ``reload-safety``
entries for ``journal_sync`` and ``journal_segment_bytes`` (RELOADABLE
knobs ``apply_reloadable`` skipped while the port had no journal), closed
with the durable journal; ``journal-discipline`` now reads the port's
journal package and its one writer, the accountant.
"""

from __future__ import annotations

from pathlib import Path

import pytest

from tools.yodalint import PASS_NAMES, Project, apply_suppressions
from tools.yodalint.callgraph import CallGraph, FunctionInfo
from tools.yodalint.core import Module
from tools.yodalint.passes import ALL_PASSES, journal_discipline, lock_discipline

REPO = Path(__file__).resolve().parent.parent
PORT = "yoda_tpu_torch"

# (pass, file, message) of every finding the port is allowed today.
EXPECTED: set = set()


def _port_path(path: str) -> str:
    return PORT + path[len("yoda_tpu"):] if path.startswith("yoda_tpu/") else path


def _visits(log: set):
    """Module / FunctionInfo subclasses that record which module a pass
    read: a module's source (``tree``, ``text``, ``lines``) or one of its
    functions' AST (``node``)."""

    class TrackedModule(Module):
        def __getattribute__(self, name):
            if name in ("tree", "text", "lines"):
                log.add(object.__getattribute__(self, "relpath"))
            return object.__getattribute__(self, name)

    class TrackedFunction(FunctionInfo):
        def __getattribute__(self, name):
            if name == "node":
                log.add(object.__getattribute__(self, "module").relpath)
            return object.__getattribute__(self, name)

    return TrackedModule, TrackedFunction


@pytest.fixture(scope="module")
def lint():
    """Run every pass over the port once: (findings after suppressions,
    pass name -> port modules it read, the project)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(
        lock_discipline, "MODULE_LEVELS",
        {_port_path(k): v for k, v in lock_discipline.MODULE_LEVELS.items()},
    )
    mp.setattr(journal_discipline, "TERM_EXEMPT",
               tuple(_port_path(p) for p in journal_discipline.TERM_EXEMPT))
    mp.setattr(journal_discipline, "APPEND_EXEMPT",
               tuple(_port_path(p) for p in journal_discipline.APPEND_EXEMPT))
    try:
        project = Project(REPO, package=PORT)
        graph = CallGraph(project)
        log: set = set()
        tracked_module, tracked_function = _visits(log)
        for mod in project.modules:
            mod.__class__ = tracked_module
        for fn in graph.functions.values():
            fn.__class__ = tracked_function
        findings, visited = [], {}
        for p in ALL_PASSES:
            log.clear()
            findings.extend(p.run(project, graph))
            visited[p.NAME] = {rel for rel in log if rel.startswith(PORT + "/")}
        findings = apply_suppressions(project, findings, PASS_NAMES)
    finally:
        mp.undo()
    return findings, visited, project


class TestPortLint:
    def test_every_port_module_is_loaded(self, lint):
        _findings, _visited, project = lint
        files = sorted(str(p.relative_to(REPO)) for p in (REPO / PORT).rglob("*.py"))
        assert [m.relpath for m in project.modules] == files

    @pytest.mark.parametrize("name", sorted(p.NAME for p in ALL_PASSES))
    def test_pass_reads_port_modules(self, lint, name):
        _findings, visited, _project = lint
        assert visited[name], f"{name} read no module of {PORT}"

    def test_findings_are_the_journal_knobs_alone(self, lint):
        """No finding at all (the journal knobs' two closed with the
        journal)."""
        findings, _visited, _project = lint
        got = {(f.pass_name, f.file, f.message) for f in findings}
        assert got == EXPECTED, "\n".join(sorted(f.render() for f in findings))

    @pytest.mark.parametrize(
        "name,where",
        [
            ("lock-discipline", "ops/cuda_kernel.py"),
            ("snapshot-immutability", "plugins/yoda/batch.py"),
            ("reload-safety", "standalone.py"),
            ("journal-discipline", "plugins/yoda/accounting.py"),
        ],
    )
    def test_repaired_findings_stay_gone(self, lint, name, where):
        findings, visited, _project = lint
        assert f"{PORT}/{where}" in visited[name]
        assert not [f for f in findings if f.pass_name == name]
