"""Shared by the port's scenario e2e tests: one ``python -m
traceml_tpu_torch run --mode summary`` of ``dev/demo/scenarios.py`` (or a
stress scenario) on the CPU, as ``tests/launcher/test_scenarios_e2e.py``
runs the JAX scenarios; returns the final summary.  Imports no JAX."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DEV = REPO / "traceml_tpu_torch" / "dev"


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = str(REPO)
    e["OMP_NUM_THREADS"] = "1"  # the tiny models; the ranks share the cores
    return e


def run(tmp_path, name, steps, nprocs=1, script="demo/scenarios.py", script_args=None, timeout=300):
    logs = tmp_path / "logs"
    args = script_args if script_args is not None else [name, str(steps)]
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary", "--logs-dir", str(logs),
         "--run-name", name, "--sampler-interval", "0.25", "--finalize-timeout", "45", "--nprocs", str(nprocs),
         str(DEV / script), "--", *args, "--device", "cpu"],
        env=env(), capture_output=True, text=True, timeout=timeout, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    # the logs dir holds session dirs and the cross-run baseline store
    session = next(p for p in logs.iterdir() if p.is_dir())
    payload = json.loads((session / "final_summary.json").read_text())
    payload["_stdout"] = proc.stdout
    return payload


def run_module(module, *args, timeout=240):
    """``python -m module args`` on the CPU, outside ``run``."""
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                          timeout=timeout, env=env())
