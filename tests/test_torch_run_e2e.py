"""End to end: ``python -m traceml_tpu_torch run --mode summary`` on the CPU.

Modelled on ``tests/launcher/test_run_e2e.py``: the launcher spawns the
aggregator and the ranks (one, then two), each the executor running
``traceml_tpu_torch/dev/forward_script.py`` on the 2-layer, 128-wide
DecoderLM with ``device="cpu"`` and a 30 ms host input delay; each rank
ships its rows over TCP, the aggregator stores them in SQLite and writes
the final summary, which must say INPUT_BOUND, as must the launcher's
stdout.  ``--disable-traceml`` passes a script through untraced; any mode
but ``summary`` is refused.
"""

import json
import os
import sqlite3
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "traceml_tpu_torch" / "dev" / "forward_script.py"
STEPS = 60


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"  # keep the tiny forward small beside the delay
    return env


@pytest.mark.parametrize("nprocs", [1, 2])
def test_run_summary_mode_input_bound(tmp_path, nprocs):
    logs = tmp_path / "logs"
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary", "--nprocs", str(nprocs),
         "--logs-dir", str(logs), "--run-name", "cpu", "--sampler-interval", "0.25",
         "--finalize-timeout", "30", str(SCRIPT), "--",
         "--device", "cpu", "--tiny", "--delay-ms", "30", "--steps", str(STEPS)],
        env=_env(), capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    (session,) = [p for p in logs.iterdir() if p.is_dir()]
    payload = json.loads((session / "final_summary.json").read_text())
    assert payload["primary_diagnosis"]["kind"] == "INPUT_BOUND"
    st = payload["sections"]["step_time"]
    assert st["status"] == "OK"
    assert st["global"]["n_steps"] == STEPS and st["global"]["clock"] == "host"
    assert st["global"]["ranks"] == list(range(nprocs))
    assert payload["meta"]["topology"]["world_size"] == nprocs
    assert payload["meta"]["run_name"] == "cpu" and payload["meta"]["mode"] == "summary"
    manifest = json.loads((session / "manifest.json").read_text())
    assert (manifest["status"], manifest["telemetry_status"]) == ("completed", "ok")
    assert manifest["finalize_sec"] > 0
    stats = json.loads((session / "ingest_stats.json").read_text())
    assert stats["final"] and stats["finished_ranks"] == list(range(nprocs))
    assert (stats["decode_errors"], stats["rows_dropped"]) == (0, 0)
    assert sorted(stats["producers"]) == [str(r) for r in range(nprocs)]
    for producer in stats["producers"].values():
        assert producer["codec"] in ("msgpack", "json")
        assert producer["transport"]["batches_dropped"] == 0
        assert producer["samplers"]["step_time"]["envelopes"] >= 1
    assert payload["meta"]["telemetry_stats"]["producers"] == stats["producers"]
    conn = sqlite3.connect(session / "telemetry.sqlite")
    try:
        rows = conn.execute(
            "SELECT global_rank, step FROM step_time_samples ORDER BY global_rank, step").fetchall()
    finally:
        conn.close()
    assert rows == [(r, s) for r in range(nprocs) for s in range(1, STEPS + 1)]
    assert (session / "final_summary.txt").exists()
    assert "INPUT_BOUND" in proc.stdout
    assert "flash_attention.launches 0" in proc.stdout  # S=64 < the kernel's threshold
    assert not (session / "finalization_warning.json").exists()


def test_run_disabled_passthrough(tmp_path):
    script = tmp_path / "noop.py"
    script.write_text("print('hello untraced')\n")
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--disable-traceml",
         "--logs-dir", str(tmp_path / "logs"), str(script)],
        env=_env(), capture_output=True, text=True, timeout=90, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "hello untraced" in proc.stdout


def test_other_modes_are_refused(tmp_path, capsys):
    from traceml_tpu_torch.launcher.cli import main

    script = tmp_path / "noop.py"
    script.write_text("print('never runs')\n")
    assert main(["run", "--mode", "cli", "--logs-dir", str(tmp_path / "logs"), str(script)]) == 2
    assert "use --mode summary" in capsys.readouterr().out
    assert not (tmp_path / "logs").exists()
