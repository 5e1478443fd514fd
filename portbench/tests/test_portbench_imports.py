"""No module a run loads has the top-level name of JAX or of the JAX
package (compared whole: the port's name begins with the JAX package's),
and the reference imports nothing of the program."""

import subprocess
import sys

from small import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "yoda_tpu"}


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
    )
    return set(out.stdout.split())


def test_a_runs_imports_load_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, '.'); sys.path.insert(0, 'portbench')\n"
        "import run\n"
        "from portbench.harness import runner, port, trace, readers\n"
        "import yoda_tpu_torch.standalone, yoda_tpu_torch.ops.cuda_kernel\n"
        "from pathlib import Path\n"
        "import json\n"
        "bench = json.loads(Path('BENCHMARK.json').read_text())\n"
        "for w in bench['workloads']:\n"
        "    runner.find_cell(Path('.'), bench, w['name'])\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    runner.load_module(Path('portbench/metrics') / (m['name'] + '.py'))\n"
    )
    loaded = _loaded_after(code)
    assert "yoda_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_check_compares_whole_top_level_names():
    from portbench.harness import runner

    before = dict(sys.modules)
    try:
        sys.modules["yoda_tpu_torch_x"] = sys
        assert "yoda_tpu" not in runner.forbidden_modules()
        sys.modules["yoda_tpu.ops"] = sys
        assert "yoda_tpu" in runner.forbidden_modules()
    finally:
        for name in set(sys.modules) - set(before):
            del sys.modules[name]


def test_the_reference_imports_nothing_of_the_program():
    loaded = _loaded_after(
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench.harness import reference, fleet, stats, roofline\n"
    )
    assert not {m for m in loaded if m.startswith("yoda_tpu")}
    assert "torch" not in loaded
