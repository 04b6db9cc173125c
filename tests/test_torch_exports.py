"""The port's package surface against the JAX package's: every name that a
``gauss_tpu`` package ``__init__`` imports is re-exported by the matching
``gauss_tpu_torch`` package, or is listed here as still to be ported."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
# Names whose modules are not ported yet, and the ROADMAP queue-1 item
# that brings each.
_OBS_COST = "obs/compile's XLA cost half, which has no counterpart"
# The collective budgets are exported: obs/collectives counts what a call
# issues through dist/comm, and compiled_collective_budget, which reads
# XLA's HLO in the JAX package, is bound to that same issued count.
PENDING = {"gauss_tpu.obs": {
               "cost_summary": _OBS_COST,
               "record_cost": _OBS_COST,
               "record_vmem_estimate": _OBS_COST},
           "gauss_tpu.resilience": {
               "FleetError": "item 10, resilience/fleet's supervisor",
               "solve_supervised": "item 10, resilience/fleet's supervisor"},
           "gauss_tpu.serve": {
               "CacheView": "item 11, serve/cache's mesh-lane view",
               "shared_cache": "item 11, serve/cache's process cache",
               "Lane": "item 11, serve/lanes",
               "LaneSet": "item 11, serve/lanes",
               "compat_sig": "item 11, serve/lanes"}}
PACKAGES = ["", ".io", ".core", ".structure", ".obs", ".tune", ".resilience",
            ".serve", ".outofcore", ".dist"]


def _reference_exports(pkg: str) -> set:
    """The names ``gauss_tpu<pkg>/__init__.py`` binds by import, read from
    its source, and those its module ``__getattr__`` serves lazily
    (``if name == "..."``)."""
    path = REPO / "gauss_tpu" / pkg.lstrip(".").replace(".", "/") / "__init__.py"
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            names |= {c.comparators[0].value for c in ast.walk(node)
                      if isinstance(c, ast.Compare)
                      and isinstance(c.left, ast.Name) and c.left.id == "name"
                      and isinstance(c.ops[0], ast.Eq)
                      and isinstance(c.comparators[0], ast.Constant)}
    return names


@pytest.mark.parametrize("pkg", PACKAGES)
def test_port_reexports_reference_names(pkg):
    ref = _reference_exports(pkg)
    pending = PENDING.get(f"gauss_tpu{pkg}", {})
    assert ref and set(pending) <= ref
    port = importlib.import_module(f"gauss_tpu_torch{pkg}")
    jax_pkg = importlib.import_module(f"gauss_tpu{pkg}")
    for name in sorted(ref - set(pending)):
        assert name in port.__all__, (pkg, name)
        got, want = getattr(port, name), getattr(jax_pkg, name)
        # The same kind of object under the same name (a function stays a
        # function: no submodule shadows it).
        assert callable(got) == callable(want), (pkg, name)
        assert isinstance(got, type) == isinstance(want, type), (pkg, name)
    assert not set(pending) & set(port.__all__), (pkg, pending)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_port_all_names_resolve(pkg):
    port = importlib.import_module(f"gauss_tpu_torch{pkg}")
    for name in port.__all__:
        assert getattr(port, name) is not None
        assert name in dir(port)


def test_core_matmul_is_the_function():
    import gauss_tpu_torch
    from gauss_tpu_torch import core
    from gauss_tpu_torch.core.matmul import matmul

    assert core.matmul is matmul and gauss_tpu_torch.matmul is matmul


def test_package_import_is_light():
    """``import gauss_tpu_torch`` loads no torch (the top-level names load
    at first use), nor does ``import gauss_tpu_torch.obs``, and the
    subpackage re-exports load no JAX and build no kernel."""
    code = ("import sys\n"
            "import gauss_tpu_torch\n"
            "assert 'torch' not in sys.modules\n"
            "import gauss_tpu_torch.io, gauss_tpu_torch.structure\n"
            "import gauss_tpu_torch.resilience, gauss_tpu_torch.serve\n"
            "assert 'torch' not in sys.modules\n"
            "import gauss_tpu_torch.obs\n"
            "assert 'torch' not in sys.modules\n"
            "gauss_tpu_torch.gauss_solve\n"
            "import gauss_tpu_torch.core\n"
            "from gauss_tpu_torch.kernels import _build\n"
            "assert not _build._libs\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'gauss_tpu')]\n"
            "assert not bad, bad\n"
            "print('light')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "light" in r.stdout
