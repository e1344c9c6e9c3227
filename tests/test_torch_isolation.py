"""The port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of ``traceml_tpu_torch`` (those
of each slice named, the transport tier's and the collectives domain's
too) and ``chip_smoke``, then no ``jax``/``jax.*`` and no ``traceml_tpu``/
``traceml_tpu.*`` module may be loaded (names matched exactly, since
``traceml_tpu_torch`` starts with ``traceml_tpu``).  An AST scan of the
same files finds no such import statement either, and the two C sources
of ``native/`` include only system and Python headers.
"""

import ast
import json
import os
import re
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
    live_display = {  # the modules of the cli mode
        "traceml_tpu_torch.runtime.stdout_capture", "traceml_tpu_torch.samplers.stdout_stderr_sampler",
        "traceml_tpu_torch.aggregator.sqlite_writers.stdout_writer", "traceml_tpu_torch.reporting.snapshot_store",
        "traceml_tpu_torch.diagnostics.model_diagnostics", "traceml_tpu_torch.renderers.views",
        "traceml_tpu_torch.renderers.compute", "traceml_tpu_torch.renderers.panels",
        "traceml_tpu_torch.renderers.cli.dashboard", "traceml_tpu_torch.aggregator.display_drivers.cli",
    }
    assert live_display <= set(out["imported"])
    dashboard = {  # the modules of the dashboard mode and the HTML report
        "traceml_tpu_torch.reporting.html.style", "traceml_tpu_torch.reporting.html.svg",
        "traceml_tpu_torch.reporting.html.sections", "traceml_tpu_torch.reporting.html.writer",
        "traceml_tpu_torch.renderers.web_payload", "traceml_tpu_torch.renderers.serving",
        "traceml_tpu_torch.aggregator.display_drivers.browser",
    } | {
        f"traceml_tpu_torch.aggregator.display_drivers.browser_sections.{m}"
        for m in ("theme", "hero", "summary", "step_time", "memory", "system", "process", "diagnostics",
                  "cluster", "pages")
    }
    assert dashboard <= set(out["imported"])
    bounded_runs = {  # --trace-max-steps, retention and rollups, --disk-backup, view and inspect
        "traceml_tpu_torch.runtime.state", "traceml_tpu_torch.database.database_writer",
        "traceml_tpu_torch.aggregator.rollup", "traceml_tpu_torch.reporting.tiers",
        "traceml_tpu_torch.reporting.view.command", "traceml_tpu_torch.launcher.inspect_cmd",
    }
    assert bounded_runs <= set(out["imported"])
    transport_tier = {  # the shm ring, the Unix socket, compression, selection, the C extensions' loader
        "traceml_tpu_torch.transport.compression", "traceml_tpu_torch.transport.shm_ring",
        "traceml_tpu_torch.transport.select", "traceml_tpu_torch.native", "traceml_tpu_torch.dev.transport_bench",
    }
    assert transport_tier <= set(out["imported"])
    collectives_domain = {  # the mesh, the topology and the collectives domain
        "traceml_tpu_torch.parallel.mesh", "traceml_tpu_torch.utils.topology",
        "traceml_tpu_torch.diagnostics.attribution", "traceml_tpu_torch.instrumentation.collectives",
        "traceml_tpu_torch.samplers.collectives_sampler",
        "traceml_tpu_torch.aggregator.sqlite_writers.collectives_writer",
        "traceml_tpu_torch.aggregator.sqlite_writers.mesh_topology_writer",
        "traceml_tpu_torch.diagnostics.collectives.api", "traceml_tpu_torch.diagnostics.collectives.policy",
        "traceml_tpu_torch.diagnostics.collectives.rules", "traceml_tpu_torch.diagnostics.collectives.vector",
    }
    assert collectives_domain <= set(out["imported"])
    assert [m for m in out["loaded"] if _forbidden(m)] == []


SYSTEM_HEADERS = {"Python.h", "stdint.h", "string.h"}


@pytest.mark.parametrize("name", ["framing.c", "ring.c"])
def test_c_sources_include_only_system_and_python_headers(name):
    """The port keeps its own copies of the C sources: nothing of the JAX
    package, no header of the repo."""
    text = (REPO / "traceml_tpu_torch" / "native" / name).read_text()
    includes = re.findall(r'^\s*#\s*include\s*([<"])([^>"]+)[>"]', text, re.MULTILINE)
    assert includes and all(kind == "<" and header in SYSTEM_HEADERS for kind, header in includes), includes
    assert "traceml_tpu/" not in text.replace("traceml_tpu_torch/", "")


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
