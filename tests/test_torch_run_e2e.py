"""End to end: ``python -m traceml_tpu_torch run --mode summary`` on the CPU.

Modelled on ``tests/launcher/test_run_e2e.py``: the launcher spawns the
aggregator and the ranks (one, then two), each the executor running
``traceml_tpu_torch/dev/forward_script.py`` on the 2-layer, 128-wide
DecoderLM with ``device="cpu"`` and a host input delay of 3x the step's
own host time (``--delay-x 3``, so it holds on a loaded host); each rank
ships its rows over its shm ring (the default transport), the aggregator
stores them in SQLite and writes
the final summary, which must say INPUT_BOUND, as must the launcher's
stdout.  Its ``system`` section holds the host rows of rank 0 alone (the
node's primary rank) and its ``process`` section every rank's rows; on
the CPU no GPU row is written.  Every run writes ``final_summary.html``
beside the ``.json`` and ``.txt``, the killed one too.
``--disable-traceml`` passes a script through untraced; ``--mode`` takes
the three JAX modes, and ``cli`` is the default, as in JAX (its runs are
held in ``test_torch_live_display.py``, the ``dashboard`` runs in
``test_torch_dashboard.py``).  ``traceml_tpu_torch/dev/train_script.py``
on the same model under ``run`` (one rank): its rows carry forward,
backward and optimizer phases from the auto-patches, the summary has an
``efficiency`` section with the FLOPs its warm-up step counted and no MFU
(a CPU has no peak), and an input delay of 3x the step's own host time
(``--delay-x 3``, so it holds on a loaded host) makes it INPUT_BOUND.

A bounded run: ``train_script.py`` under ``run --mode cli
--trace-max-steps 3 --summary-window-rows 4 --disk-backup
--no-capture-stderr``: the rank's disk backup holds every step once (the
post-cap ones from the final drain, as in JAX), the database keeps 6 raw
step rows and folds the rest into the rollup tiers, the report has the
``history`` block and its "History:" line, ``view`` prints the stored
summary (text and JSON) and ``inspect`` decodes the backup and lists the
tiers; the script's stderr line reaches the launcher's stderr and not
the captured output.

Liveness and the summary call: every healthy run's ``liveness`` section
is OK with each rank finished; a ``--nprocs 2`` forward run whose rank 1
sends itself SIGKILL mid-loop, under the settings of the JAX chaos test
``test_rank_sigkill_reported_lost_with_data_gap`` (heartbeat 0.5 s,
stale 1 s, lost 3 s, an 8 s settle window), gives that test's
assertions; ``train_script.py --remat --h2d to --tokens --final-summary``
gets the summary from ``final_summary()`` inside the script, with the
final artifact's verdict, declares its tokens (tokens/s in
``efficiency``), and ``summary()`` flattens the artifact as the JAX one
does.

The transport tier: the tiny forward run over the default (the shm ring),
``TRACEML_TRANSPORT=uds`` and ``tcp`` stores the same (rank, step)
coverage, with the rank's ``transport_hello``, the frames by path and the
``transports`` block of ``ingest_stats.json`` shaped as the JAX
aggregator's, and the launcher leaves no ring segment, descriptor or
socket of the session.

Cross-run baselines: a healthy and a delayed ``train_script.py`` run
under one logs dir and run name give ``no_baseline`` and then a
PERF_REGRESSION in ``regressions``, each session its
``code_manifest.json``, and ``python -m traceml_tpu_torch compare`` of the
two a REGRESSION.
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
TRAIN_SCRIPT = REPO / "traceml_tpu_torch" / "dev" / "train_script.py"
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
         "--device", "cpu", "--tiny", "--delay-x", "3", "--steps", str(STEPS)],
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
    system, process = payload["sections"]["system"], payload["sections"]["process"]
    assert system["status"] == process["status"] == "OK"
    assert list(system["global"]["nodes"]) == ["0"] and system["global"]["devices"] == {}
    assert system["global"]["nodes"]["0"]["cpu_pct_mean"] is not None
    assert sorted(process["global"]["per_rank"]) == [str(r) for r in range(nprocs)]
    assert all(v["rss_bytes"] > 0 for v in process["global"]["per_rank"].values())
    assert (session / "final_summary.txt").exists()
    assert "INPUT_BOUND" in (session / "final_summary.html").read_text()
    assert "INPUT_BOUND" in proc.stdout
    assert "flash_attention.launches 0" in proc.stdout  # S=64 < the kernel's threshold
    assert not (session / "finalization_warning.json").exists()
    liveness = payload["sections"]["liveness"]
    assert liveness["status"] == "OK" and liveness["diagnosis"]["kind"] == "HEALTHY"
    assert {r: v["state"] for r, v in liveness["ranks"].items()} == {str(r): "finished" for r in range(nprocs)}


def test_run_train_script_input_bound(tmp_path):
    logs = tmp_path / "logs"
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary",
         "--logs-dir", str(logs), "--sampler-interval", "0.25", "--finalize-timeout", "30",
         str(TRAIN_SCRIPT), "--", "--device", "cpu", "--tiny", "--delay-x", "3", "--steps", str(STEPS)],
        env=_env(), capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    (session,) = [p for p in logs.iterdir() if p.is_dir()]
    payload = json.loads((session / "final_summary.json").read_text())
    assert payload["primary_diagnosis"]["kind"] == "INPUT_BOUND"
    g = payload["sections"]["step_time"]["global"]
    assert g["n_steps"] == STEPS
    assert {"input", "h2d", "forward", "backward", "optimizer"} <= set(g["phases"])
    assert "compute" not in g["phases"]
    eff = g["efficiency"]
    # the tiny model on (2, 65) tokens: 6 x 425,984 matmul parameters x 128
    # tokens, attention at S=64 through the einsum reference
    assert eff["flops_per_step"] == 352321536.0 and eff["flops_source"] == "flop_counter"
    assert eff["device_kind"] == "cpu" and eff["mfu_median"] is None and eff["peak_tflops"] is None
    manifest = json.loads((session / "manifest.json").read_text())
    assert (manifest["status"], manifest["telemetry_status"]) == ("completed", "ok")
    conn = sqlite3.connect(session / "telemetry.sqlite")
    try:
        steps = [r[0] for r in conn.execute("SELECT step FROM step_time_samples ORDER BY step")]
        stats = conn.execute("SELECT flops_per_step, device_kind FROM model_stats_samples").fetchall()
    finally:
        conn.close()
    assert steps == list(range(1, STEPS + 1))
    assert stats == [(352321536.0, "cpu")]
    first, last = (float(proc.stdout.split(word)[1].split()[0]) for word in ("loss first", " last "))
    assert last < first
    assert "flash_attention.launches 0" in proc.stdout  # S=64 < the kernel's threshold


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


def _mode_choices(parser):
    run = next(a for a in parser._actions if a.dest == "command").choices["run"]
    return next(a for a in run._actions if a.dest == "mode").choices


def test_supported_modes_are_the_jax_modes_and_cli_is_the_default(tmp_path, capsys, monkeypatch):
    """The launcher takes the JAX launcher's three modes (``cli``,
    ``summary``, ``dashboard``) and, as the JAX launcher, defaults to
    ``cli`` on a single node; any other mode is refused before a session
    is made."""
    from traceml_tpu.launcher.cli import _build_parser as jax_parser
    from traceml_tpu.launcher.commands import resolve_settings as jax_resolve_settings
    from traceml_tpu_torch.launcher.cli import _build_parser, main
    from traceml_tpu_torch.launcher.commands import SUPPORTED_MODES, resolve_settings

    assert SUPPORTED_MODES == ("cli", "summary", "dashboard")
    assert tuple(_mode_choices(_build_parser())) == tuple(_mode_choices(jax_parser())) == SUPPORTED_MODES
    script = tmp_path / "noop.py"
    script.write_text("print('never runs')\n")
    monkeypatch.setenv("TRACEML_MODE", "bogus")
    assert main(["run", "--logs-dir", str(tmp_path / "logs"), str(script)]) == 2
    assert "unknown --mode bogus" in capsys.readouterr().out
    assert not (tmp_path / "logs").exists()
    monkeypatch.delenv("TRACEML_MODE", raising=False)
    monkeypatch.chdir(tmp_path)  # no yaml config for the JAX launcher to find
    assert resolve_settings({}).mode == jax_resolve_settings({}).mode == "cli"


def test_rank_sigkill_reported_lost_with_data_gap(tmp_path):
    """The JAX chaos test's assertions on the port: rank 1 of 2 kills
    itself after 20 of 400 steps."""
    logs = tmp_path / "logs"
    env = _env()
    env.update({"TRACEML_HEARTBEAT_INTERVAL_SEC": "0.5", "TRACEML_LIVENESS_STALE_SEC": "1",
                "TRACEML_LIVENESS_LOST_SEC": "3"})
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary", "--nprocs", "2",
         "--logs-dir", str(logs), "--run-name", "rankkill", "--sampler-interval", "0.25",
         "--finalize-timeout", "8", str(SCRIPT), "--",
         "--device", "cpu", "--tiny", "--delay-ms", "30", "--steps", "400", "--kill-after", "20",
         "--kill-rank", "1"],
        env=env, capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
    )
    assert proc.returncode != 0  # a SIGKILLed rank is a failed run
    (session,) = [p for p in logs.iterdir() if p.is_dir()]
    manifest = json.loads((session / "manifest.json").read_text())
    assert manifest["status"] == "failed"
    summary = json.loads((session / "final_summary.json").read_text())
    sec = summary["sections"]["liveness"]
    assert sec["diagnosis"]["kind"] == "RANK_LOST", sec["diagnosis"]
    assert sec["diagnosis"]["severity"] == "critical"
    assert 1 in sec["diagnosis"]["ranks"], sec["diagnosis"]
    assert "1" in sec.get("data_gaps", {}), sec.get("data_gaps")
    assert 1 in sec["unfinished_ranks"]
    assert sec["unfinished_rank_states"]["1"] == "lost"
    assert summary["primary_diagnosis"]["kind"] in ("RANK_LOST", "LIKELY_PREEMPTED"), summary["primary_diagnosis"]
    status = json.loads((session / "rank_status.json").read_text())
    assert status["thresholds"] == {"stale_after_sec": 1.0, "lost_after_sec": 3.0}
    assert summary["primary_diagnosis"]["kind"] in (session / "final_summary.html").read_text()


def test_train_script_final_summary_tokens_and_summary(tmp_path):
    from traceml_tpu.sdk.summary_client import summary as jax_summary
    from traceml_tpu_torch.sdk.summary_client import summary

    logs = tmp_path / "logs"
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary",
         "--logs-dir", str(logs), "--sampler-interval", "0.25", "--finalize-timeout", "30",
         str(TRAIN_SCRIPT), "--", "--device", "cpu", "--tiny", "--delay-x", "3", "--steps", str(STEPS),
         "--remat", "--h2d", "to", "--tokens", "--final-summary"],
        env=_env(), capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    (session,) = [p for p in logs.iterdir() if p.is_dir()]
    payload = json.loads((session / "final_summary.json").read_text())
    lines = [l for l in proc.stdout.splitlines() if l.startswith("final_summary ")]
    asked = json.loads(lines[-1].split(" ", 1)[1])
    g = payload["sections"]["step_time"]["global"]
    assert asked["kind"] == payload["primary_diagnosis"]["kind"] == "INPUT_BOUND"
    assert 0 < asked["n_steps"] <= g["n_steps"] == STEPS
    assert "train_script: batches copied by Tensor.to in the step" in proc.stdout
    eff = g["efficiency"]
    assert eff["tokens_per_step"] == 2 * 64
    assert eff["tokens_per_sec_median"] == round(128 / (g["steady_state"]["median_ms"] / 1e3), 1)
    assert payload["sections"]["liveness"]["ranks"]["0"]["state"] == "finished"
    assert not (session / "control" / "final_summary_request.json").exists()
    flat = summary(session_dir=session)
    assert flat == jax_summary(session_dir=session)
    assert flat["traceml/sections/step_time/global/efficiency/tokens_per_step"] == 128
    assert all(k.startswith("traceml/") and isinstance(v, (int, float)) for k, v in flat.items())


def test_summary_protocol_and_service_as_jax(tmp_path):
    """The request and response files are the JAX package's (same paths,
    read across the two packages), and the service settles, generates,
    answers and clears the request as the JAX one does."""
    from traceml_tpu.sdk import protocol as jax_protocol
    from traceml_tpu_torch.aggregator.summary_service import FinalSummaryService
    from traceml_tpu_torch.sdk import protocol

    for name in ("control_dir", "request_path", "response_path", "get_final_summary_json_path",
                 "get_final_summary_txt_path"):
        assert getattr(protocol, name)(tmp_path) == getattr(jax_protocol, name)(tmp_path)
    protocol.write_summary_request(tmp_path, requester_rank=3)
    assert jax_protocol.read_summary_request(tmp_path)["requester_rank"] == 3
    calls = []
    service = FinalSummaryService(TraceMLSettingsAt(tmp_path), generate=lambda: calls.append("gen") or True,
                                  settle=lambda: calls.append("settle"), poll_interval=0.0)
    service.poll()
    assert calls == ["settle", "gen"] and service.requests_served == 1
    assert jax_protocol.read_summary_response(tmp_path)["ok"] is True
    assert protocol.read_summary_request(tmp_path) is None
    service.poll()  # no request: nothing
    assert calls == ["settle", "gen"]
    protocol.write_summary_request(tmp_path)
    failing = FinalSummaryService(TraceMLSettingsAt(tmp_path), generate=lambda: 1 / 0, poll_interval=0.0)
    failing.poll()
    resp = jax_protocol.read_summary_response(tmp_path)
    assert resp["ok"] is False and "division" in resp["error"]
    assert protocol.read_summary_request(tmp_path) is None


class TraceMLSettingsAt:
    """Settings whose session dir is a given directory."""

    def __init__(self, session_dir):
        self.session_dir = session_dir


def test_run_bounded_then_view_and_inspect(tmp_path):
    from traceml_tpu_torch.database.database_writer import iter_backup_tables

    logs, steps = tmp_path / "logs", 12
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--logs-dir", str(logs), "--sampler-interval", "0.1",
         "--finalize-timeout", "30", "--trace-max-steps", "3", "--summary-window-rows", "4", "--disk-backup",
         "--no-capture-stderr", str(TRAIN_SCRIPT), "--",
         "--device", "cpu", "--tiny", "--delay-ms", "20", "--steps", str(steps), "--stderr-marker"],
        env=_env(), capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    (session,) = [p for p in logs.iterdir() if p.is_dir()]
    manifest = json.loads((session / "manifest.json").read_text())
    assert (manifest["status"], manifest["telemetry_status"]) == ("completed", "ok")
    backup = session / "rank_0" / "data" / "step_time" / "envelopes.msgpack"
    backed = [r["step"] for t, r in iter_backup_tables(backup) if t == "step_time"]
    assert sorted(backed) == list(range(1, steps + 1))
    conn = sqlite3.connect(session / "telemetry.sqlite")
    try:
        raw = [s for (s,) in conn.execute("SELECT step FROM step_time_samples ORDER BY step")]
        folded = conn.execute("SELECT SUM(count) FROM rollup_samples_10s WHERE grain='rank' AND metric='step_ms'"
                              " AND source_table='step_time_samples'").fetchone()[0]
        journal = conn.execute("SELECT COUNT(*) FROM retention_watermarks WHERE table_name='step_time_samples'"
                               ).fetchone()[0]
        stdout_rows = [line for (line,) in conn.execute("SELECT line FROM stdout_samples")]
    finally:
        conn.close()
    assert raw == list(range(steps - 5, steps + 1)) and folded + len(raw) == steps and journal >= 1
    marker = "train_script: stderr marker"
    assert marker in proc.stderr and not any(marker in line for line in stdout_rows)
    assert any(line.startswith("train_script: ") for line in stdout_rows)  # stdout is still captured
    assert marker not in (session / "rank_0" / "stdout.log").read_text()
    payload = json.loads((session / "final_summary.json").read_text())
    assert payload["history"]["step_time"]["step_ms"]["ranks"] == 1
    txt = (session / "final_summary.txt").read_text()
    assert "History:" in txt

    def cmd(*args):
        got = subprocess.run([sys.executable, "-m", "traceml_tpu_torch", *args], env=_env(), capture_output=True,
                             text=True, timeout=60, cwd=str(tmp_path))
        assert got.returncode == 0, got.stderr[-2000:]
        return got.stdout

    assert cmd("view", str(session)) == txt + "\n"
    assert json.loads(cmd("view", str(session), "--format", "json")) == payload
    dump = cmd("inspect", str(session / "rank_0" / "data"))
    assert f"── {backup}" in dump and '"table": "step_time"' in dump
    assert "step_time.step_ms" in cmd("inspect", "--domain", "rollup", str(session))


def _key_tree(obj):
    return {k: _key_tree(v) for k, v in obj.items()} if isinstance(obj, dict) else None


def _jax_transports_block(tmp_path, transport):
    """What the JAX aggregator writes under ``transports`` for one rank
    that announced its transport and sent over it: its ``_transport_stats``
    after the rank's hello, on an aggregator built with the same setting."""
    from traceml_tpu.aggregator.trace_aggregator import TraceMLAggregator as JaxAggregator
    from traceml_tpu.runtime.settings import TraceMLSettings as JaxSettings
    from traceml_tpu.telemetry.control import build_transport_hello

    agg = JaxAggregator(JaxSettings(session_id="jax", logs_dir=tmp_path / "jax", mode="summary",
                                    transport=transport))
    kind = "shm" if transport == "auto" else transport
    agg._handle_control(build_transport_hello({"global_rank": 0, "session_id": "jax"}, kind, None))
    agg.server.frames_by_transport[kind] = 1  # the rank's frames, counted by the server's thread
    return agg._transport_stats()


@pytest.mark.parametrize("transport", ["auto", "uds", "tcp"])
def test_run_over_each_transport_stores_the_same_steps(tmp_path, transport):
    """The default (the shm ring), the Unix socket and TCP: the same (rank,
    step) coverage, the rank's hello naming the transport, its frames
    counted under it, the ``transports`` block shaped as JAX's, and no
    ring segment, descriptor or socket of the session left."""
    from traceml_tpu_torch.transport.select import default_uds_path
    from traceml_tpu_torch.transport.shm_ring import ring_segment_path

    steps, logs = 30, tmp_path / "logs"
    env = {k: v for k, v in _env().items() if not k.startswith("TRACEML_")}
    if transport != "auto":
        env["TRACEML_TRANSPORT"] = transport
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary", "--logs-dir", str(logs),
         "--sampler-interval", "0.25", "--finalize-timeout", "30", str(SCRIPT), "--",
         "--device", "cpu", "--tiny", "--delay-ms", "20", "--steps", str(steps)],
        env=env, capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    (session,) = [p for p in logs.iterdir() if p.is_dir()]
    conn = sqlite3.connect(session / "telemetry.sqlite")
    try:
        rows = conn.execute("SELECT global_rank, step FROM step_time_samples ORDER BY step").fetchall()
    finally:
        conn.close()
    assert rows == [(0, s) for s in range(1, steps + 1)]
    stats = json.loads((session / "ingest_stats.json").read_text())
    kind = "shm" if transport == "auto" else transport
    block = stats["transports"]
    assert block["ranks"] == {"0": {"transport": kind, "compression": None}}
    assert set(block["frames_by_kind"]) == {kind} and block["frames_by_kind"][kind] == stats["frames_received"]
    assert stats["producers"]["0"]["transport"]["kind"] == kind
    assert _key_tree(block) == _key_tree(_jax_transports_block(tmp_path, transport))
    summary = json.loads((session / "final_summary.json").read_text())
    assert summary["meta"]["telemetry_stats"]["transports"] == block
    left = [p for p in (ring_segment_path(session, 0), session / "rank_0" / "shm_ring.json",
                        Path(default_uds_path(session))) if p.exists()]
    assert left == []


def test_two_runs_under_one_name_end_in_a_regression_and_a_compare_verdict(tmp_path):
    """Cross-run baselines and ``compare`` end to end: ``train_script.py``
    on the tiny model, healthy, then with a host input delay of 3x the
    step (``--delay-x 3``) under the same logs dir and run name.  The
    first run's ``regressions`` is ``no_baseline``, the second's a
    PERF_REGRESSION on ``steady_step_ms`` (judged against the first, then
    recorded: the store holds both); each ``regressions.json`` is its
    payload's section and each session has its ``code_manifest.json``;
    ``compare`` of the two exits 0 with a REGRESSION, its step-time
    findings led by the step's major regression, and the candidate's own
    ``regressions`` verdict."""
    from traceml_tpu_torch.analytics.baselines import STORE_FILENAME

    logs = tmp_path / "logs"
    sessions = []
    for args in ((), ("--delay-x", "3")):
        before = set(logs.iterdir()) if logs.exists() else set()
        proc = subprocess.run(
            [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary", "--run-name", "tiny",
             "--logs-dir", str(logs), "--sampler-interval", "0.25", "--finalize-timeout", "30",
             str(TRAIN_SCRIPT), "--", "--device", "cpu", "--tiny", "--steps", str(STEPS), *args],
            env=_env(), capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        (session,) = [p for p in set(logs.iterdir()) - before if p.is_dir()]
        sessions.append(session)
        code = json.loads((session / "code_manifest.json").read_text())
        assert code["framework"] == "torch" and "adamw" in code["optimizer_hints"]
    (healthy, delayed) = (json.loads((s / "final_summary.json").read_text()) for s in sessions)
    for session, payload in zip(sessions, (healthy, delayed)):
        assert json.loads((session / "regressions.json").read_text()) == payload["regressions"]
    assert (healthy["regressions"]["status"], healthy["regressions"]["baseline_runs"]) == ("no_baseline", 0)
    reg = delayed["regressions"]
    assert (reg["status"], reg["baseline_runs"]) == ("regression", 1)
    assert reg["fingerprint"] == {"run_name": "tiny", "mesh_axes": "", "world_size": 1}
    (issue,) = [i for i in reg["issues"] if i["metric"] == "steady_step_ms"]
    assert issue["kind"] == "PERF_REGRESSION" and "python -m traceml_tpu_torch compare" in issue["action"]
    assert "[baseline] PERF_REGRESSION: steady_step_ms" in (sessions[1] / "final_summary.txt").read_text()
    assert (logs / STORE_FILENAME).exists()
    out = tmp_path / "cmp.json"
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "compare", str(sessions[0]), str(sessions[1]),
         "--output", str(out)],
        env=_env(), capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    payload = json.loads(out.read_text())
    assert payload["verdict"] == "REGRESSION" and proc.stdout.startswith("VERDICT: REGRESSION")
    step_findings = [f for f in payload["findings"] if f["section"] == "step_time"]
    assert (step_findings[0]["kind"], step_findings[0]["significance"]) == ("STEP_TIME_REGRESSION", "major")
    assert payload["candidate_baseline"]["status"] == "regression"
    assert payload["candidate_baseline"]["regressed_metrics"][0] == "steady_step_ms"
