"""The port stands alone: importing every module of ``uresnet_tpu_torch``,
in a fresh interpreter, loads neither jax nor anything of the JAX package
``uresnet_tpu``; and no import statement of the port's modules or of
chip_smoke.py names ``uresnet_tpu`` (an AST check, which also covers what
only runs on the card)."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "uresnet_tpu_torch")


def _port_files():
    out = []
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _module_name(path):
    rel = os.path.relpath(path, ROOT)[:-3].split(os.sep)
    return ".".join(rel[:-1] if rel[-1] == "__init__" else rel)


MODULES = [_module_name(p) for p in _port_files()]


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'uresnet_tpu') "
            "or m.startswith(('jax.', 'jaxlib', 'uresnet_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize(
    "path", _port_files() + [os.path.join(ROOT, "chip_smoke.py")],
    ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_names_the_jax_package(path):
    bad = [n for n in _imported_names(path)
           if n.split(".")[0] in ("uresnet_tpu", "jax", "jaxlib")]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_walk_covers_parallel():
    """The walk above reaches the parallel package and the integration
    hooks, so their modules are imported in the fresh interpreter and their
    AST checked too."""
    assert {"uresnet_tpu_torch.parallel", "uresnet_tpu_torch.parallel.mesh",
            "uresnet_tpu_torch.parallel.tp", "uresnet_tpu_torch.parallel.halo",
            "uresnet_tpu_torch.graft_entry"} <= set(MODULES)
    for name in ("mesh.py", "tp.py", "halo.py"):
        assert os.path.join(PKG, "parallel", name) in _port_files()
    assert os.path.join(PKG, "graft_entry.py") in _port_files()
