"""The port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of ``traceml_tpu_torch`` and
``chip_smoke``, then no ``jax``/``jax.*`` and no ``traceml_tpu``/
``traceml_tpu.*`` module may be loaded (names matched exactly, since
``traceml_tpu_torch`` starts with ``traceml_tpu``).  An AST scan of the
same files finds no such import statement either.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "traceml_tpu")


def _forbidden(name: str) -> bool:
    return any(name == root or name.startswith(root + ".") for root in FORBIDDEN)


def _port_files():
    return sorted((REPO / "traceml_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_forbidden_matches_exact_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("traceml_tpu") and _forbidden("traceml_tpu.ops.attention")
    assert not _forbidden("traceml_tpu_torch") and not _forbidden("traceml_tpu_torch.ops")
    assert not _forbidden("jaxlib_like") and not _forbidden("jaxtyping")


def test_importing_the_port_loads_no_jax_and_no_jax_package():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import traceml_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(traceml_tpu_torch.__path__, 'traceml_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "import chip_smoke\n"
        "for attr in traceml_tpu_torch.__all__: getattr(traceml_tpu_torch, attr)\n"
        "print(json.dumps({'imported': names, 'loaded': sorted(sys.modules)}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["imported"]) >= 30
    assert [m for m in out["loaded"] if _forbidden(m)] == []


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                found.append(node.module)
    assert found == []
