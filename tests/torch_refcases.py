"""Run the JAX package's own test cases against either package.

A reference test module (``tests/test_observability.py`` and its
siblings) is compiled from its source once per package: for
``yoda_tpu_torch`` every ``yoda_tpu`` import is pointed at the port
(``yoda_tpu.testing``'s fake API server, ``wait_until``, chaos harness,
trace generator and fake libtpu metrics service included: the port has its
own copy of every one, so no reference import survives the rewrite), and
the port's
``build_stack`` runs its kernels on the host (``kernel_platform: cpu``)
where the case leaves the platform at "auto", as every port test does on
a machine without a card; so do the port's other entry points that pick a
device (``ops.kernel.resolve_device`` and its importers: the batch plugin
a case builds itself, ``fused_filter_score``, ``parallel.default_mesh``,
which then gives the host shards) and the assemblies built from
``build_stack`` (``build_sharded_stacks``, ``build_profile_stacks``), in
the case's own process and in a script it runs in a fresh interpreter
(the port's chaos module's ``DriveWorker`` resolves its "auto" device
through the same mapping, so it spawns the port's worker with ``--device
cpu``). A worker process that a case spawns itself as ``python -m
yoda_tpu.framework.procserve`` is the port's worker, given ``--device
cpu``. A case's ``kernel_backend: pallas`` config keeps "auto" (the
port refuses another platform beside it) and runs on the host through the
same ``resolve_device`` mapping; a case that hands a kernel JAX's host
device (``jax.devices("cpu")[0]``) hands the port's ``"cpu"``. The case
body, its inputs and its assertions
are the reference's own, unchanged, so a case passing on both packages
holds the port to exactly what the reference is held to.

``cases(path, skip)`` lists ``(case id, class, method, params)`` for
``pytest.mark.parametrize``, one per parameter set of a case the
reference parametrizes, on the method or on its class (its id
``method[v1-v2]``, the method's values before the class's, as pytest
orders them), a case the reference marks ``slow`` (on its class or on
itself) wrapped in ``pytest.param`` with the same mark, so it stays out of
the tier-1 run as it does in the reference;
``run_case(pkg, path, case, request, monkeypatch)`` runs one between its
class's ``setup_method`` and ``teardown_method``, resolving the method's
fixtures through ``request``; a case whose class or method the reference
marks ``skipif`` with a condition that holds here (or ``skip``) skips with
the reference's reason on both packages, as it does under pytest.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import inspect
import re
import sys
import types
from pathlib import Path

import pytest

PACKAGES = ("yoda_tpu", "yoda_tpu_torch")
TESTS = Path(__file__).resolve().parent

# Reference modules the port side keeps: test harness helpers the port
# has no copy of. The port has a copy of every one, so none is kept.
_KEEP: "tuple[str, ...]" = ()


def _slow(node: "ast.ClassDef | ast.FunctionDef") -> bool:
    """Whether the reference decorates ``node`` with ``pytest.mark.slow``."""
    return any(ast.unparse(d) == "pytest.mark.slow" for d in node.decorator_list)


def _constants(body: list) -> dict:
    """The plain constants a module or class body assigns (``NAME =
    literal``), which a parametrize argument may name."""
    out = {}
    for stmt in body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            try:
                out[stmt.targets[0].id] = ast.literal_eval(stmt.value)
            except ValueError:
                pass
    return out


def _param_sets(node: "ast.FunctionDef | ast.ClassDef",
                scope: "dict | None" = None) -> "list[dict]":
    """The argument sets of the reference's ``pytest.mark.parametrize``
    decorators on ``node``, a method or its class (their cross product;
    one empty set when there are none). Argument values are evaluated with
    builtins and the plain constants of ``scope`` (the module's and the
    case's class's) only."""
    sets: list[dict] = [{}]
    for d in node.decorator_list:
        if not (isinstance(d, ast.Call) and ast.unparse(d.func) == "pytest.mark.parametrize"):
            continue
        names = ast.literal_eval(d.args[0])
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        values = eval(compile(ast.Expression(d.args[1]), "<parametrize>", "eval"),
                      dict(scope or {}))
        rows = [v if len(names) > 1 else (v,) for v in values]
        sets = [{**s, **dict(zip(names, row))} for s in sets for row in rows]
    return sets


def _expand(base: str, cls: str, node: ast.FunctionDef, slow: bool,
            scope: dict, class_sets: "list[dict] | None" = None) -> list:
    """One case per parameter set: the method's own sets crossed with its
    class's (``class_sets``), in pytest's order: the method's values first
    in the id and in the outer loop, the class's after them."""
    out = []
    for own in _param_sets(node, scope):
        for cls_params in class_sets or [{}]:
            params = {**own, **cls_params}
            case_id = base
            if params:
                case_id += "[" + "-".join(str(v) for v in params.values()) + "]"
            out.append(((case_id, cls, node.name, params), slow))
    return out


def cases(name: str, skip: "dict[str, str]") -> list:
    """Every test case of ``tests/<name>`` as (id, class, method, params),
    minus ``skip`` (id, the id of a parametrized case without its
    parameters, or a test class's name -> the unported part it needs or
    where it runs instead); a case the reference marks slow comes as a
    ``pytest.param`` carrying that mark."""
    tree = ast.parse((TESTS / name).read_text())
    module_scope = _constants(tree.body)
    out = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            scope = {**module_scope, **_constants(node.body)}
            class_sets = _param_sets(node, module_scope)
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and item.name.startswith("test"):
                    out += _expand(f"{node.name}::{item.name}", node.name, item,
                                   _slow(node) or _slow(item), scope, class_sets)
        elif isinstance(node, ast.FunctionDef) and node.name.startswith("test"):
            out += _expand(node.name, "", node, _slow(node), module_scope)
    known = ({c[0] for c, _ in out} | {c[0].split("[")[0] for c, _ in out}
             | {c[1] for c, _ in out if c[1]})
    unknown = set(skip) - known
    assert not unknown, f"skip names no case of {name}: {sorted(unknown)}"
    return [
        pytest.param(c, marks=pytest.mark.slow) if slow else c
        for c, slow in out
        if c[0] not in skip and c[0].split("[")[0] not in skip and c[1] not in skip
    ]


def _port_source(src: str) -> str:
    def swap(m: re.Match) -> str:
        mod = m.group(2)
        if mod.startswith(_KEEP):
            return m.group(0)
        return m.group(1) + "yoda_tpu_torch" + mod[len("yoda_tpu"):]

    src = re.sub(
        r"(\bfrom\s+)(yoda_tpu(?:\.[\w.]+)?)(?=\s+import\b)", swap, src
    )
    # A case that hands a kernel JAX's host device gives the port's the
    # host's torch device name.
    return src.replace('jax.devices("cpu")[0]', '"cpu"')


def _cpu_build_stack(real):
    def build_stack(cluster=None, config=None, **kw):
        from yoda_tpu_torch.config import SchedulerConfig

        config = config or SchedulerConfig()
        # A "pallas" config must leave the platform at "auto" (the port
        # refuses any other); its batch plugin's resolve_device is the
        # host mapping below, so it runs on the host all the same.
        if config.kernel_platform == "auto" and config.kernel_backend != "pallas":
            config = dataclasses.replace(config, kernel_platform="cpu")
        return real(cluster, config, **kw)

    return build_stack


def _cpu_resolve_device(real):
    def resolve_device(platform: str):
        return real("cpu" if platform == "auto" else platform)

    return resolve_device


# Prepended to a reference module's script strings that a case runs in a
# fresh interpreter (``python -c``): the same "auto" -> "cpu" mapping of
# ``build_stack`` as in-process.
_CPU_PREAMBLE = """\
import dataclasses as _dc
import yoda_tpu_torch.standalone as _st
from yoda_tpu_torch.config import SchedulerConfig as _Cfg
_real_build_stack = _st.build_stack
def _cpu_build_stack(cluster=None, config=None, **kw):
    config = config or _Cfg()
    if config.kernel_platform == "auto":
        config = _dc.replace(config, kernel_platform="cpu")
    return _real_build_stack(cluster, config, **kw)
_st.build_stack = _cpu_build_stack
"""


# The reference's worker entry, as a case spawns it in its own argv
# (``python -m yoda_tpu.framework.procserve``).
_REF_WORKER = "yoda_tpu.framework.procserve"


def port_worker_argv(args):
    """``args`` with the reference's worker entry replaced by the port's,
    given ``--device cpu`` (the port's worker runs on the card by
    default); any other command unchanged."""
    if isinstance(args, (list, tuple)):
        args = list(args)
        for i in range(len(args) - 1):
            if args[i] == "-m" and args[i + 1] == _REF_WORKER:
                args[i + 1] = "yoda_tpu_torch.framework.procserve"
                return args + ["--device", "cpu"]
    return args


def _port_popen(real):
    class Popen(real):
        def __init__(self, args, *a, **kw):
            super().__init__(port_worker_argv(args), *a, **kw)

    return Popen


def load(pkg: str, name: str, monkeypatch) -> types.ModuleType:
    path = TESTS / name
    src = path.read_text()
    if pkg == "yoda_tpu_torch":
        import yoda_tpu_torch.ops.kernel as kernel
        import yoda_tpu_torch.parallel.sharded  # noqa: F401 — patched below
        import yoda_tpu_torch.standalone as standalone

        monkeypatch.setattr(
            standalone, "build_stack", _cpu_build_stack(standalone.build_stack)
        )
        # A worker process a case spawns as the reference's entry is the
        # port's, on the host.
        import subprocess

        monkeypatch.setattr(subprocess, "Popen", _port_popen(subprocess.Popen))
        real = kernel.resolve_device
        for mod_name, mod in list(sys.modules.items()):
            if mod_name.startswith("yoda_tpu_torch") and getattr(
                mod, "resolve_device", None
            ) is real:
                monkeypatch.setattr(mod, "resolve_device", _cpu_resolve_device(real))
        src = _port_source(src)
    mod = types.ModuleType(f"{path.stem}__{pkg}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    if pkg == "yoda_tpu_torch":
        for key, value in list(mod.__dict__.items()):
            if isinstance(value, str) and "from yoda_tpu_torch.standalone import" in value:
                setattr(mod, key, _CPU_PREAMBLE + value)
    return mod


def _fixture_function(obj):
    """The function behind a ``pytest.fixture`` defined in a compiled
    reference module (pytest does not collect those), or None."""
    fn = getattr(obj, "_fixture_function", None)  # pytest >= 8.4
    if fn is None and hasattr(obj, "_pytestfixturefunction"):
        fn = getattr(obj, "__wrapped__", None)
    return fn


def _xunit(owner, hook: str, fn) -> None:
    """Call the case's class's ``setup_method`` / ``teardown_method`` as
    pytest does: with the test method when the hook takes it."""
    method = getattr(owner, hook, None)
    if method is None:
        return
    if inspect.signature(method).parameters:
        method(fn)
    else:
        method()


def _skip_reason(*targets) -> "str | None":
    """The reason of the first ``skip`` mark, or ``skipif`` mark whose
    (evaluated) condition holds, on ``targets`` (a case's class and
    method, as compiled); None when the case runs."""
    for target in targets:
        for mark in getattr(target, "pytestmark", ()):
            if mark.name == "skip" or (mark.name == "skipif" and mark.args
                                       and mark.args[0] is True):
                return mark.kwargs.get("reason", mark.name)
    return None


def run_case(pkg: str, name: str, case, request, monkeypatch) -> None:
    """Run one case. Its class's ``setup_method`` runs first and its
    ``teardown_method`` last, as under pytest. Its arguments resolve
    through ``request``, except the fixtures the reference module or the
    case's class defines itself (a fake API server, a synced client, a CLI
    runner): those are built from the compiled module's own definitions,
    their dependencies first, and torn down in reverse order after the
    case, generator fixtures run to their end."""
    _id, cls, meth, *rest = case
    params = rest[0] if rest else {}
    mod = load(pkg, name, monkeypatch)
    owner = getattr(mod, cls)() if cls else mod
    fn = getattr(owner, meth)
    reason = _skip_reason(getattr(mod, cls) if cls else None, fn)
    if reason is not None:
        pytest.skip(reason)
    with contextlib.ExitStack() as teardown:
        if cls:
            _xunit(owner, "setup_method", fn)
            teardown.callback(_xunit, owner, "teardown_method", fn)
        values: dict = {}

        def value(arg: str):
            if arg in values:
                return values[arg]
            bound = ()
            fixture = _fixture_function(getattr(type(owner), arg, None)) if cls else None
            if fixture is not None:
                bound = (owner,)  # a fixture method of the case's class
            else:
                fixture = _fixture_function(mod.__dict__.get(arg))
            if fixture is None:
                v = request.getfixturevalue(arg)
            else:
                params = list(inspect.signature(fixture).parameters)[len(bound):]
                res = fixture(*bound, **{a: value(a) for a in params})
                if inspect.isgenerator(res):
                    v = next(res)
                    teardown.callback(next, res, None)
                else:
                    v = res
            values[arg] = v
            return v

        # Arguments with a default (a case's own ``seed=11``) keep it.
        fn(**{
            a: params[a] if a in params else value(a)
            for a, prm in inspect.signature(fn).parameters.items()
            if a in params or prm.default is inspect.Parameter.empty
        })
