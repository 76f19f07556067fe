"""The port imports neither ``jax`` nor anything of the JAX package.

Every module under ``src/repro_torch`` is imported in a fresh interpreter
whose ``sys.meta_path`` starts with a finder that raises on ``jax``,
``jaxlib`` and ``repro`` (the port's own ``repro_torch`` is allowed).
``chip_smoke.py`` exits before its imports where there is no card, so
its import statements (at any depth) are checked from its syntax tree.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "repro")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"repro_torch imported {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_no_jax_and_no_reference_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=SRC,
                          capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": str(SRC),
                               "PATH": "/usr/local/bin:/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # every package and module of the two slices was imported (the zoo
    # slice added configs/mixtral_8x22b, models/{attention,moe,
    # transformer} and kernels/moe_gmm/{__init__,kernel,ops,ref})
    assert int(proc.stdout.strip().splitlines()[-1]) >= 49


def test_port_sources_never_name_the_reference_imports():
    """A static guard beside the runtime one: no import statement in the
    port mentions ``jax`` or the ``repro`` package."""
    bad = []
    for path in (SRC / "repro_torch").rglob("*.py"):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                if mod in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(SRC)}:{n}: {s}")
    assert not bad, bad


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax_and_no_reference_package():
    roots = _imported_roots(SRC.parent / "chip_smoke.py")
    assert "repro_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_port_sources_import_no_reference_at_any_depth():
    """The syntax-tree form of the static guard, over every port module
    (imports inside functions included)."""
    bad = {str(p.relative_to(SRC)): _imported_roots(p)
           & {"jax", "jaxlib", "repro"}
           for p in (SRC / "repro_torch").rglob("*.py")}
    assert not {k: v for k, v in bad.items() if v}, bad
