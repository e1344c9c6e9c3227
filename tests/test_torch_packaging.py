"""The port as an installed package and in CI.

* A wheel built offline from the checkout carries the CUDA kernel and C
  sources the port builds from at first use (``csrc/*.cu``,
  ``csrc/*.cuh``, ``native/*.c``).
* The build directory resolves to the package tree's
  ``build/traceml_tpu_torch`` when that is writable, else
  ``TRACEML_TORCH_BUILD_DIR``, else the user cache directory.
* A checkout without torch collects ``tests/`` with no collection error:
  every port test file that imports torch at module level skips, naming
  torch.
* ``.github/workflows/ci.yml`` has the port's job, the port in the lint
  paths, and the installed-package checks.
"""

import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest
import yaml

REPO = Path(__file__).resolve().parent.parent
SOURCES = ("traceml_tpu_torch/csrc/flash_attention_fwd.cu", "traceml_tpu_torch/csrc/hopper.cuh",
           "traceml_tpu_torch/native/framing.c", "traceml_tpu_torch/native/ring.c")


def test_an_offline_wheel_carries_the_kernel_and_c_sources(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    ignore = shutil.ignore_patterns("__pycache__", "*.so", "*.pyc")
    for name in ("traceml_tpu", "traceml_tpu_torch"):
        shutil.copytree(REPO / name, src / name, ignore=ignore)
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src / name)
    out = tmp_path / "wheel"
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-build-isolation", "--no-deps", "--no-index", "-q",
         "-w", str(out), str(src)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (wheel,) = out.glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    assert set(SOURCES) <= names
    assert "traceml_tpu_torch/ops/_build.py" in names and "traceml_tpu_torch/native/__init__.py" in names
    assert not [n for n in names if n.startswith("traceml_tpu/") and n.endswith((".cu", ".cuh"))]


def test_the_build_dir_falls_back_when_the_package_tree_is_read_only(monkeypatch, tmp_path):
    from traceml_tpu_torch import native
    from traceml_tpu_torch.ops import _build

    tree = REPO / "build" / "traceml_tpu_torch"
    assert _build.BUILD_DIR == tree == _build.resolve_build_dir()  # a writable checkout: as before
    assert native.BUILD_DIR == _build.BUILD_DIR
    monkeypatch.setattr(_build, "_writable", lambda path: False)
    monkeypatch.setenv(_build.ENV_BUILD_DIR, str(tmp_path / "builds"))
    assert _build.resolve_build_dir() == tmp_path / "builds"
    monkeypatch.delenv(_build.ENV_BUILD_DIR)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert _build.resolve_build_dir() == tmp_path / "xdg" / "traceml_tpu_torch"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.resolve_build_dir() == tmp_path / "home" / ".cache" / "traceml_tpu_torch"


def test_writable_probe_reads_the_nearest_existing_directory(tmp_path):
    from traceml_tpu_torch.ops._build import _writable

    assert _writable(tmp_path / "a" / "b")
    blocker = tmp_path / "site-packages"
    blocker.write_text("a file where the tree's directory would be")
    assert not _writable(blocker / "build" / "traceml_tpu_torch")


def test_a_checkout_without_torch_collects_every_test(tmp_path):
    blocker = tmp_path / "blocked" / "torch"
    blocker.mkdir(parents=True)
    (blocker / "__init__.py").write_text('raise ImportError("torch is not installed here")\n')
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"PYTHONPATH": str(blocker.parent), "JAX_PLATFORMS": "cpu"})
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-p", "no:cacheprovider", "-rs", "tests"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert "Interrupted" not in out and "ERROR collecting" not in out and "error" not in out.splitlines()[-1]
    skipped = [line for line in out.splitlines() if line.startswith("SKIPPED")]
    assert skipped and all("torch" in line for line in skipped)


def test_ci_has_the_port_job_lint_paths_and_install_checks():
    ci = yaml.safe_load((REPO / ".github" / "workflows" / "ci.yml").read_text())
    jobs = ci["jobs"]
    port = jobs["test-port"]
    runs = [s.get("run", "") for s in port["steps"]]
    assert any("download.pytorch.org/whl/cpu" in r for r in runs)
    assert any("pytest tests/test_torch_*.py" in r and "-m 'not cuda'" in r for r in runs)
    assert any("TRACEML_NO_NATIVE=1" in r and "tests/test_torch_shm_ring.py" in r for r in runs)
    lint = " ".join(s.get("run", "") for s in jobs["lint"]["steps"])
    assert "traceml_tpu_torch/" in lint and "chip_smoke.py" in lint and "E9,F63,F7,F82" in lint
    smoke = " ".join(s.get("run", "") for s in jobs["smoke-install"]["steps"])
    assert "python -m traceml_tpu_torch --help" in smoke
    for src in SOURCES:
        assert src.split("traceml_tpu_torch/", 1)[1] in smoke
    # the lanes that were there keep their steps
    assert {"lint", "test-fast", "test-e2e", "smoke-install"} <= set(jobs)
