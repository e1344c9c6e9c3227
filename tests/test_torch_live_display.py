"""The port's live display (``run --mode cli``) against the JAX package's.

One seeded session DB (step-time rows with a forward/backward/optimizer
split, model_stats, step memory, system and process rows with their GPU
rows, stdout rows, from a numpy seed; written by the port's
``SQLiteWriter``, whose tables equal the JAX writer's) is read by the JAX
``LiveComputer`` (its scalar arm: ``TRACEML_COLUMNAR_WINDOW=0
TRACEML_INCR_WINDOW=0 TRACEML_VECTOR_DIAGNOSIS=0``) and by the port's
with its engines on, as by default (the port's engines equal its scalar
arm bit for bit, ``tests/test_torch_columnar_window.py``).
Every view's ``as_dict`` is equal, exactly (tolerance 0: the same
arithmetic in the same order), and so are the topology, the stdout tail,
the freshness stamp and the liveness strip; the per-domain diagnoses are
equal once the JAX actions and summaries go through
``tests/test_torch_advice.py``'s table.  Each panel renders the same
title, columns and cells as the JAX panel on its payload (plain text at
one width, the advice table applied to the JAX text).

The dirty gating is the JAX contract (port of
``tests/renderers/test_live_computer_gating.py``): an idle tick runs no
SQL but the ``data_version`` probe and returns the identical payload;
new rows recompute only the domains whose tables changed.  The CLI
display driver prints its last frame at ``stop`` on a non-terminal
stdout and closes its read connection; the aggregator logs a tick that
raises and goes on ingesting, then still stops the driver.  End to end, ``python -m
traceml_tpu_torch run`` with no ``--mode`` runs the live display (the
JAX launcher's default): the script's output reaches the launcher's
stdout whole and in order, ``stdout_samples`` and ``rank_0/stdout.log``
hold its lines in order, the last frame follows them with the step-time
and rank-0 output panels, and ``final_summary.json`` is written as in
summary mode.
"""

import io
import json
import os
import re
import sqlite3
import subprocess
import sys
from pathlib import Path

import pytest
from rich.console import Console

from tests.test_torch_advice import SUMMARIES, port_advice
from tests.test_torch_sqlite import (
    memory_rows,
    model_stats_rows,
    process_rows,
    step_rows,
    system_rows,
    wire_payloads,
)
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.renderers.compute import LiveComputer
from traceml_tpu_torch.telemetry.envelope import SenderIdentity, normalize_telemetry_envelope
from traceml_tpu_torch.utils.atomic_io import atomic_write_json

REPO = Path(__file__).resolve().parent.parent
TRAIN_SCRIPT = REPO / "traceml_tpu_torch" / "dev" / "train_script.py"
VIEWS = ("step_time", "memory", "system", "process")
PANELS = ("step_time_panel", "diagnostics_panel", "step_memory_panel", "system_panel", "process_panel",
          "stdout_panel", "cluster_panel")


def _payload(sampler, tables, rank, seq, world=1):
    ident = SenderIdentity(session_id="s", global_rank=rank, local_rank=rank, world_size=world,
                           local_world_size=world, hostname=f"host-{rank}", pid=100 + rank)
    meta = ident.to_meta()
    meta.update({"schema": 1, "sampler": sampler, "timestamp": 1.7e9, "seq": seq})
    return {"meta": meta, "body": {"tables": tables}}


def _stdout_rows(rank, n):
    return [{"timestamp": 1.7e9 + i, "stream": "stderr" if i % 5 == 4 else "stdout",
             "line": f"rank {rank} line {i}"} for i in range(n)]


SCENARIOS = {
    # one rank, a train step behind a slow input (INPUT_BOUND)
    "input_bound": dict(
        steps={0: step_rows(0, 70, 30.0, 10.0, train=True)},
        memory={0: memory_rows(1, 70, 0.5)},
        stats={0: model_stats_rows(9.0e12, tokens=8192.0)},
        system={0: system_rows(2, 40)},
        process={0: process_rows(3, 40)},
        ranks={"0": {"state": "finished"}},
    ),
    # two ranks on the device clock, rank 1 slower with high memory
    # pressure and a rising footprint
    "two_ranks": dict(
        steps={0: step_rows(4, 70, 2.0, 18.0), 1: step_rows(5, 70, 2.0, 26.0)},
        memory={0: memory_rows(6, 70, 0.5), 1: memory_rows(7, 70, 0.96)},
        stats={0: model_stats_rows(9.0e12, n=2), 1: model_stats_rows(9.0e12)},
        system={0: system_rows(8, 40, util_pct=40.0)},
        process={0: process_rows(9, 40), 1: process_rows(10, 38, rss=9 * (1 << 30))},
        ranks={"0": {"state": "active"}, "1": {"state": "lost"}},
    ),
}


def _seed(tmp_path, name):
    sc = SCENARIOS[name]
    session = tmp_path / "session"
    session.mkdir()
    db = session / "telemetry.sqlite"
    payloads = wire_payloads(sc["steps"], sc["memory"], columnar=True, rank_model_stats=sc["stats"],
                             rank_system=sc["system"], rank_process=sc["process"])
    world = len(sc["steps"])
    seq = 1000
    for rank in sc["steps"]:
        for i in range(0, 30, 10):
            seq += 1
            payloads.append(_payload("stdout_stderr", {"stdout_stderr": _stdout_rows(rank, 30)[i:i + 10]},
                                     rank, seq, world))
    writer = SQLiteWriter(db)
    writer.start()
    for p in payloads:
        assert writer.ingest(normalize_telemetry_envelope(p))
    assert writer.force_flush()
    atomic_write_json(session / "rank_status.json", {
        "ts": 1.7e9, "thresholds": {"stale_after_sec": 15.0, "lost_after_sec": 60.0}, "ranks": sc["ranks"]})
    return db, writer


ENGINE_SWITCHES = ("TRACEML_COLUMNAR_WINDOW", "TRACEML_INCR_WINDOW", "TRACEML_VECTOR_DIAGNOSIS")


def _jax_scalar_arm(monkeypatch):
    for flag in ENGINE_SWITCHES:
        monkeypatch.setenv(flag, "0")


def _port_engines_on(monkeypatch):
    """Both packages read the same switch names on every call: unset them
    after the JAX scalar arm ran, so the port runs its engines."""
    for flag in ENGINE_SWITCHES:
        monkeypatch.delenv(flag, raising=False)


def _both_payloads(tmp_path, monkeypatch, name):
    from traceml_tpu.renderers.compute import LiveComputer as JaxComputer

    _jax_scalar_arm(monkeypatch)
    db, writer = _seed(tmp_path, name)
    jax_c, port_c = JaxComputer(db), LiveComputer(db)
    try:
        jax = jax_c.payload()
        _port_engines_on(monkeypatch)
        port = port_c.payload()
        assert getattr(port["step_time"]["window"], "col", None) is not None  # the engine's window
        return jax, port
    finally:
        jax_c.close()
        port_c.close()
        writer.finalize()


def _diag(result):
    return None if result is None else result.to_dict()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_views_and_diagnoses_equal_jax(tmp_path, monkeypatch, name):
    jax, port = _both_payloads(tmp_path, monkeypatch, name)
    assert sorted(port["views"]) == sorted(VIEWS)
    for key in VIEWS:
        assert port["views"][key].as_dict() == jax["views"][key].as_dict(), key
    for key in ("topology", "stdout", "latest_row_ts", "rank_status", "db_exists"):
        assert port[key] == jax[key], key
    assert len(port["stdout"]) == 12 and port["stdout"][-1][1].endswith("line 29")
    for port_result, jax_result in (
        (port["step_time"]["diagnosis"], jax["step_time"]["diagnosis"]),
        (port["step_memory_diagnosis"], jax["step_memory_diagnosis"]),
        (port["system_diagnosis"], jax["system_diagnosis"]),
        (port["process_diagnosis"], jax["process_diagnosis"]),
    ):
        assert _diag(port_result) == port_advice(_diag(jax_result))
    assert port["step_memory"] == jax["step_memory"]
    assert port["system"] == jax["system"] and port["process"] == jax["process"]
    eff = port["views"]["step_time"].efficiency
    assert eff["mfu_median"] > 0 and eff["flops_per_step"] == 9.0e12
    if name == "input_bound":
        assert port["step_time"]["diagnosis"].diagnosis.kind == "INPUT_BOUND"
        assert eff["tokens_per_sec_median"] > 0


def _text(renderable, width=200):
    console = Console(file=io.StringIO(), width=width, color_system=None, force_terminal=False)
    console.print(renderable)
    return console.file.getvalue()


def _cells(text):
    """The rendered text without the padding before a panel's right
    border (a port summary may be shorter than the JAX one)."""
    return re.sub(r" +│\n", " │\n", text)


def _port_text(jax_text):
    """The JAX panel's text with its summaries as the port writes them."""
    for pattern, repl in SUMMARIES:
        jax_text = re.sub(pattern.lstrip("^"), repl, jax_text)
    return jax_text


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_panels_show_what_the_jax_panels_show(tmp_path, monkeypatch, name):
    import traceml_tpu.renderers.cli as jax_cli
    import traceml_tpu_torch.renderers.cli as port_cli

    jax, port = _both_payloads(tmp_path, monkeypatch, name)
    for panel in PANELS:
        j, p = getattr(jax_cli, panel)(jax), getattr(port_cli, panel)(port)
        if j is None:
            assert p is None, panel
            continue
        assert (p.title, p.subtitle) == (j.title, j.subtitle), panel
        assert _cells(_text(p)) == _cells(_port_text(_text(j))), panel
    frame = _text(port_cli.dashboard(port, "s"), width=120)
    header = frame.splitlines()[0]
    assert header.startswith("TraceML (PyTorch) — live · session s")
    if name == "two_ranks":
        assert "1 active · 1 lost (rank 1)" in header
        assert "cluster" not in frame  # one node
    else:
        assert header.endswith("ranks: 1 finished")
    for title in ("step time", "diagnostics", "device memory", "system", "processes", "rank 0 output"):
        assert title in frame
    # the JAX order: step time, findings, then resources, then output
    order = [frame.index(t) for t in ("step time", "diagnostics", "device memory", "processes",
                                       "rank 0 output")]
    assert order == sorted(order)


def _gating_step_rows(start, n, base_ms=50.0):
    from traceml_tpu_torch.utils import timing as T

    return [{"step": s, "timestamp": float(s), "clock": "device", "events": {
        T.STEP_TIME: {"cpu_ms": base_ms, "device_ms": base_ms, "count": 1},
        T.COMPUTE_TIME: {"cpu_ms": 1.0, "device_ms": base_ms * 0.9, "count": 1},
    }} for s in range(start, start + n)]


def _gating_system_rows(ts):
    return {
        "system": [{"timestamp": ts, "cpu_pct": 10.0, "memory_used_bytes": 1, "memory_total_bytes": 2,
                    "memory_pct": 50.0}],
        "system_device": [{"timestamp": ts, "device_id": 0, "device_kind": "gpu", "memory_used_bytes": 5,
                           "memory_peak_bytes": 6, "memory_total_bytes": 10}],
    }


class _GatingDB:
    """The JAX gating test's session, written by the port's writer."""

    def __init__(self, db):
        self.writer = SQLiteWriter(db)
        self.writer.start()
        self.seq = {0: 0, 1: 0}

    def ingest(self, sampler, tables, rank):
        self.seq[rank] += 1
        assert self.writer.ingest(normalize_telemetry_envelope(
            _payload(sampler, tables, rank, self.seq[rank], world=2)))

    def seed(self):
        for rank in (0, 1):
            self.ingest("step_time", {"step_time": _gating_step_rows(1, 20)}, rank)
        self.ingest("system", _gating_system_rows(1.0), 0)
        self.ingest("process", {"process": [{"timestamp": 1.0, "cpu_pct": 5.0, "rss_bytes": 10,
                                             "vms_bytes": 20, "num_threads": 3}]}, 1)
        self.ingest("stdout_stderr", {"stdout_stderr": [{"timestamp": 1.0, "stream": "stdout",
                                                         "line": "hello"}]}, 0)
        assert self.writer.force_flush()
        return self


def test_idle_tick_zero_row_reads_and_identical_payload(tmp_path):
    db = tmp_path / "t.sqlite"
    w = _GatingDB(db).seed()
    computer = LiveComputer(db)
    p1 = computer.payload()
    assert p1["views"]["step_time"] is not None
    ts1 = p1["ts"]
    statements = []
    computer.store.connection.set_trace_callback(statements.append)
    try:
        p2 = computer.payload()
    finally:
        computer.store.connection.set_trace_callback(None)
    # the identical object back, with only the timestamp refreshed in place
    assert p2 is p1 and p2["ts"] >= ts1
    # the only SQL an idle tick runs is the data_version header check
    assert statements, "expected the data_version probe to be traced"
    assert all("data_version" in s for s in statements), statements
    assert not any("SELECT" in s.upper() for s in statements), statements
    w.writer.finalize()
    computer.close()


def test_tick_after_ingest_recomputes_only_dirty_domains(tmp_path):
    db = tmp_path / "t.sqlite"
    w = _GatingDB(db).seed()
    computer = LiveComputer(db)
    p1 = computer.payload()
    # new step rows for rank 0: the step_time domain recomputes
    w.ingest("step_time", {"step_time": _gating_step_rows(21, 5)}, 0)
    assert w.writer.force_flush()
    p2 = computer.payload()
    assert p2 is not p1
    assert p2["latest_row_ts"] == 25.0
    assert p2["step_time"] is not p1["step_time"]
    assert p2["views"]["step_time"] is not p1["views"]["step_time"]
    # untouched domains keep their exact cached fragments
    assert p2["system"] is p1["system"] and p2["process"] is p1["process"]
    assert p2["stdout"] is p1["stdout"]
    assert p2["views"]["system"] is p1["views"]["system"]
    assert p2["views"]["process"] is p1["views"]["process"]
    # only system rows arrive: the step_time fragment is reused
    w.ingest("system", _gating_system_rows(2.0), 0)
    assert w.writer.force_flush()
    p3 = computer.payload()
    assert p3 is not p2
    assert p3["system"] is not p2["system"]
    assert p3["views"]["system"] is not p2["views"]["system"]
    assert p3["step_time"] is p2["step_time"]
    assert p3["views"]["step_time"] is p2["views"]["step_time"]
    # and the next idle tick returns p3 itself again
    assert computer.payload() is p3
    w.writer.finalize()
    computer.close()


def test_missing_db_payload_and_late_attach(tmp_path):
    db = tmp_path / "nope.sqlite"
    computer = LiveComputer(db)
    p = computer.payload()
    assert p["db_exists"] is False and p["views"] == {}
    w = _GatingDB(db).seed()
    p2 = computer.payload()
    assert p2["db_exists"] is True and "step_time" in p2["views"]
    w.writer.finalize()
    computer.close()


class _Context:
    def __init__(self, db_path):
        self.db_path = db_path
        self.settings = type("S", (), {"session_id": "live-s"})()


def test_cli_driver_prints_the_last_frame_and_closes_its_connection(tmp_path, monkeypatch, capsys):
    from traceml_tpu_torch.aggregator.display_drivers import SummaryDisplayDriver, resolve_display_driver
    from traceml_tpu_torch.aggregator.display_drivers.browser import BrowserDisplayDriver
    from traceml_tpu_torch.aggregator.display_drivers.cli import CLIDisplayDriver

    assert isinstance(resolve_display_driver("cli"), CLIDisplayDriver)
    assert isinstance(resolve_display_driver("dashboard"), BrowserDisplayDriver)
    assert type(resolve_display_driver("summary")) is SummaryDisplayDriver
    db, writer = _seed(tmp_path, "input_bound")
    driver = CLIDisplayDriver()
    driver.start(_Context(db))
    driver.tick()
    driver.tick()
    store = driver._computer.store
    assert store.connected
    driver.stop()
    writer.finalize()
    assert not store.connected and driver._computer is None
    out = capsys.readouterr().out
    assert out.count("TraceML (PyTorch) — live · session live-s") == 1  # the last frame, once
    assert "step time" in out and "INPUT_BOUND" in out and "rank 0 line 29" in out


def test_run_cli_mode_by_default_end_to_end(tmp_path):
    logs = tmp_path / "logs"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--logs-dir", str(logs), "--sampler-interval", "0.25",
         "--finalize-timeout", "30", str(TRAIN_SCRIPT), "--", "--device", "cpu", "--tiny", "--delay-x", "3",
         "--steps", "30", "--final-summary"],
        env=env, capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    (session,) = [p for p in logs.iterdir() if p.is_dir()]
    payload = json.loads((session / "final_summary.json").read_text())
    assert payload["meta"]["mode"] == "cli"
    assert payload["primary_diagnosis"]["kind"] == "INPUT_BOUND"
    assert payload["sections"]["step_time"]["global"]["n_steps"] == 30
    assert payload["sections"]["liveness"]["status"] == "OK"
    manifest = json.loads((session / "manifest.json").read_text())
    assert (manifest["mode"], manifest["status"], manifest["telemetry_status"]) == ("cli", "completed", "ok")
    # the script's lines, whole and in order, on the launcher's stdout
    script_lines = [l for l in proc.stdout.splitlines() if l.startswith(("train_script:", "flash_attention.",
                                                                         "final_summary "))]
    assert [l.split(":")[0].split(" ")[0] for l in script_lines] == [
        "train_script", "train_script", "train_script", "flash_attention.launches", "final_summary"]
    asked = json.loads(script_lines[-1].split(" ", 1)[1])
    assert asked["kind"] == "INPUT_BOUND"
    conn = sqlite3.connect(session / "telemetry.sqlite")
    try:
        stored = conn.execute("SELECT global_rank, stream, line FROM stdout_samples ORDER BY id").fetchall()
    finally:
        conn.close()
    assert [line for _, _, line in stored if line in script_lines] == script_lines
    assert {(rank, stream) for rank, stream, _ in stored} == {(0, "stdout")}
    log = (session / "rank_0" / "stdout.log").read_text().splitlines()
    assert [l[len("[stdout] "):] for l in log if l[len("[stdout] "):] in script_lines] == script_lines
    # the last frame follows the script's output; no summary text in cli mode
    frame = proc.stdout[proc.stdout.index("TraceML (PyTorch) — live · session"):]
    assert proc.stdout.index(script_lines[-1]) < proc.stdout.index("TraceML (PyTorch) — live")
    assert "step time" in frame and "rank 0 output" in frame and "INPUT_BOUND" in frame
    assert "ranks: 1 finished" in " ".join(frame.split())  # the settled liveness strip
    assert "final_summary" in frame.split("rank 0 output")[1]
    assert "[TraceML] final summary:" not in proc.stdout


class _RaisingDriver:
    """A display driver whose every tick raises."""

    def __init__(self):
        self.ticks = self.stops = 0

    def start(self, context=None):
        pass

    def tick(self, context=None):
        self.ticks += 1
        raise RuntimeError("render failed")

    def stop(self):
        self.stops += 1


def test_a_raising_tick_is_logged_and_ingest_goes_on(tmp_path, monkeypatch):
    """As in JAX: the aggregator logs a failed display tick and keeps
    ingesting; the driver is still stopped and the report written."""
    import time

    from traceml_tpu_torch.aggregator.trace_aggregator import TraceMLAggregator
    from traceml_tpu_torch.runtime.settings import AggregatorEndpoint, TraceMLSettings
    from traceml_tpu_torch.telemetry.control import build_rank_finished
    from traceml_tpu_torch.transport.tcp_transport import TCPClient
    from traceml_tpu_torch.utils.error_log import get_error_log

    logged = []
    monkeypatch.setattr(get_error_log(), "warning", lambda msg, exc=None: logged.append(msg))
    settings = TraceMLSettings(session_id="s", logs_dir=tmp_path, mode="cli", aggregator=AggregatorEndpoint(),
                               expected_world_size=1, finalize_timeout_sec=10.0)
    agg = TraceMLAggregator(settings)
    driver = agg.display = _RaisingDriver()
    agg.start()
    client = TCPClient("127.0.0.1", agg.port)
    try:
        for seq, start in enumerate((1, 21, 41), 1):
            assert client.send_batch([_payload("step_time", {"step_time": _gating_step_rows(start, 20)}, 0, seq)])
            # ingest goes on after each failed tick: the envelope lands,
            # then the loop's next tick (every 0.5 s) fails again
            deadline = time.monotonic() + 30
            while (agg.envelopes_ingested < seq or driver.ticks < seq) and time.monotonic() < deadline:
                time.sleep(0.05)
            assert agg.envelopes_ingested == seq and driver.ticks >= seq
        ident = SenderIdentity(session_id="s", global_rank=0, local_rank=0, world_size=1, local_world_size=1,
                               hostname="host-0", pid=100)
        assert client.send_batch([build_rank_finished(ident.to_meta())])
    finally:
        client.close()
        agg.stop()
    assert agg.envelopes_ingested == 3 and driver.ticks >= 4 and driver.stops == 1  # the last tick in stop()
    assert logged.count("display tick failed") == driver.ticks and "display stop failed" not in logged
    conn = sqlite3.connect(tmp_path / "s" / "telemetry.sqlite")
    try:
        assert conn.execute("SELECT COUNT(*) FROM step_time_samples").fetchone()[0] == 60
    finally:
        conn.close()
    assert (tmp_path / "s" / "final_summary.json").exists()
