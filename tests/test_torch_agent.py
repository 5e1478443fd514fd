"""The port's native metrics reader loader (yoda_tpu_torch/agent/native.py).

The reference loads a library built in ``native/`` by its Makefile; the
port builds the same source itself at first use, into ``build/native/``,
and never writes into ``native/``. Checked here: the build lands in the
build directory with the Makefile's flags and leaves ``native/`` as it
was, a fresh source rebuilds a stale library, no compiler and no library
give None (the reference's answer), an explicit path or
``$YODA_TPUINFO_SO`` is the only candidate when given, and the chip-limit
guard refuses a library built with another limit. The agent's behaviour
over the library is held against the reference in
``tests/test_torch_parity_native_agent.py``.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from yoda_tpu_torch.agent import native

REPO = Path(__file__).resolve().parent.parent
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ toolchain")


def _tree(d: Path) -> dict:
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in d.iterdir()}


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    d = tmp_path / "build" / "native"
    monkeypatch.setattr(native, "BUILD_DIR", d)
    monkeypatch.delenv("YODA_TPUINFO_SO", raising=False)
    monkeypatch.delenv("CXX", raising=False)
    return d


def test_defaults_name_the_repo_source_and_build_directory():
    assert native.SOURCE == REPO / "native" / "tpuinfo.cc"
    assert native.BUILD_DIR == REPO / "build" / "native"
    makefile = (REPO / "native" / "Makefile").read_text()
    flags = re.search(r"^CXXFLAGS \?= (.*)$", makefile, re.M).group(1).split()
    assert list(native.CXXFLAGS) == flags + ["-shared"]


@needs_gxx
def test_builds_into_the_build_directory_and_never_into_native(build_dir, monkeypatch):
    before = _tree(REPO / "native")
    lib = native.load_library()
    assert lib is not None
    assert Path(lib._name) == build_dir / native.LIB_NAME
    assert lib.yoda_tpuinfo_max_chips() == native.MAX_CHIPS
    assert _tree(REPO / "native") == before
    # Built once: a second load reuses the library.
    mtime = (build_dir / native.LIB_NAME).stat().st_mtime_ns
    assert native.load_library() is not None
    assert (build_dir / native.LIB_NAME).stat().st_mtime_ns == mtime
    assert not list(build_dir.glob("*.tmp"))


@needs_gxx
def test_a_newer_source_rebuilds(build_dir, tmp_path, monkeypatch):
    source = tmp_path / "tpuinfo.cc"
    shutil.copy(native.SOURCE, source)
    monkeypatch.setattr(native, "SOURCE", source)
    first = native.build_library()
    os.utime(first, (1, 1))  # older than the source
    second = native.build_library()
    assert second == first and second.stat().st_mtime > 1


def test_no_compiler_and_no_library_give_none(build_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setattr(native, "INSTALLED", tmp_path / "absent.so")
    assert native.build_library() is None
    assert native.load_library() is None
    assert not build_dir.exists()


def test_an_explicit_path_or_the_env_is_the_only_candidate(build_dir, tmp_path,
                                                          monkeypatch):
    assert native.load_library(tmp_path / "nope.so") is None
    monkeypatch.setenv("YODA_TPUINFO_SO", str(tmp_path / "nope.so"))
    assert native.load_library() is None
    assert not build_dir.exists()


@needs_gxx
def test_a_library_of_another_chip_limit_is_refused(tmp_path):
    stub = tmp_path / "stub.cc"
    stub.write_text(
        'extern "C" { int yoda_tpuinfo_collect(void*) { return 0; }\n'
        'const char* yoda_tpuinfo_source(void) { return "none"; }\n'
        "int yoda_tpuinfo_max_chips(void) { return 8; } }\n"
    )
    so = tmp_path / "libstub.so"
    subprocess.run(["g++", *native.CXXFLAGS, "-o", str(so), str(stub)], check=True)
    with pytest.raises(RuntimeError, match="max_chips=8"):
        native.load_library(so)
