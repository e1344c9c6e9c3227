"""The port's stitched history reads against the JAX package's.

One database, written by the port's SQLite writer from the two-rank
stream of ``tests/test_torch_retention.py`` (retention 12 rows, online
prunes during the stream, every partition trimmed at ``finalize``):

* ``reporting/tiers.py``: ``has_rollups``, ``load_stitched_series`` at
  the rank and host grains and ``stitched_overview`` equal the JAX
  functions' on the same database (exact: the same SQL and fold).
* The final report: the JAX ``generate_summary`` and the port's give the
  same ``history`` block (points, ranks, resolutions; floats to 1e-9
  relative, the final report tests' tolerance) and the same "History:"
  line in ``final_summary.txt``; a database with no fold has neither.
* The dashboard: the ``history`` fragment of the port's payload equals
  the JAX payload's (its scalar arm), to 1e-9 relative.
* The live snapshot store: refreshed after every tick while the writer
  prunes online, the port's store holds the same windows as a cold load
  of the database and as the JAX store refreshed alongside it (step
  time, step memory, process rows; exact), its ``rollup`` version moves
  with the prunes, and its ``stitched_overview`` equals the cold one.
"""

import json
import sqlite3

import pytest

from test_torch_final_report import assert_same
from test_torch_live_display import _jax_scalar_arm
from test_torch_retention import WINDOW, _stream
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.reporting import tiers
from traceml_tpu_torch.telemetry.envelope import normalize_telemetry_envelope


@pytest.fixture(scope="module")
def pruned_db(tmp_path_factory):
    db = tmp_path_factory.mktemp("history") / "telemetry.sqlite"
    w = SQLiteWriter(db, summary_window_rows=WINDOW)
    w.start()
    for tick in _stream():
        for p in tick:
            w.ingest(normalize_telemetry_envelope(json.loads(json.dumps(p))))
        w.force_flush(timeout=30)
    assert w.finalize(timeout=30)
    return db


def _ro(db):
    conn = sqlite3.connect(f"file:{db}?mode=ro", uri=True)
    conn.row_factory = sqlite3.Row
    return conn


def test_stitched_reads_equal_the_jax_functions(pruned_db):
    from traceml_tpu.reporting import tiers as jax_tiers

    conn = _ro(pruned_db)
    try:
        assert tiers.has_rollups(conn) and jax_tiers.has_rollups(conn)
        for grain in ("rank", "host"):
            ours = tiers.load_stitched_series(conn, "step_time_samples", "step_ms", grain=grain)
            assert ours and ours == jax_tiers.load_stitched_series(conn, "step_time_samples", "step_ms", grain=grain)
        overview = tiers.stitched_overview(conn)
        assert overview == jax_tiers.stitched_overview(conn)
    finally:
        conn.close()
    assert set(overview) == {"step_time", "step_memory"}
    points = overview["step_time"]["step_ms"]["0"]
    assert sum(p["n"] for p in points) == 330 and {p["res"] for p in points} <= {"raw", "10s"}


def _summaries(tmp_path, db):
    from traceml_tpu.reporting.final import generate_summary as jax_generate_summary
    from traceml_tpu.runtime.settings import TraceMLSettings as JaxSettings
    from traceml_tpu_torch.reporting.final import generate_summary
    from traceml_tpu_torch.runtime.settings import TraceMLSettings

    out = {}
    for name, gen, settings in (("jax", jax_generate_summary, JaxSettings(session_id="s", mode="summary")),
                                ("port", generate_summary, TraceMLSettings(session_id="s", mode="summary"))):
        session = tmp_path / name / "s"
        session.mkdir(parents=True)
        assert gen(db_path=db, session_dir=session, settings=settings)
        out[name] = (json.loads((session / "final_summary.json").read_text()),
                     (session / "final_summary.txt").read_text())
    return out["port"], out["jax"]


def _history_line(text):
    return [line for line in text.splitlines() if line.startswith("History:")]


def test_final_history_block_and_line_equal_jax(tmp_path, pruned_db):
    (ours, our_txt), (theirs, their_txt) = _summaries(tmp_path, pruned_db)
    assert set(ours["history"]) == {"step_time", "step_memory"}
    assert_same(ours["history"], theirs["history"], "history")
    st = ours["history"]["step_time"]["step_ms"]
    # the last buckets hold only surviving raw rows
    assert st["ranks"] == 2 and st["resolutions"] == ["10s", "raw"] and len(st["points"]) == 24
    assert _history_line(our_txt) == _history_line(their_txt) == [
        "History: 24 stitched buckets covering 0.1 h (10s/raw resolution)"]
    assert ours["meta"]["topology"] == theirs["meta"]["topology"]


def test_no_fold_no_history(tmp_path):
    """A database no prune ever touched: neither report has the block or
    the line (the shape without tiers)."""
    db = tmp_path / "telemetry.sqlite"
    w = SQLiteWriter(db)
    w.start()
    for p in _stream()[0]:
        w.ingest(normalize_telemetry_envelope(json.loads(json.dumps(p))))
    assert w.finalize(timeout=30)
    (ours, our_txt), (theirs, their_txt) = _summaries(tmp_path, db)
    assert "history" not in ours and "history" not in theirs
    assert _history_line(our_txt) == _history_line(their_txt) == []


def test_history_fragment_equals_jax(pruned_db, monkeypatch):
    from traceml_tpu.renderers import serving as jax_serving
    from traceml_tpu.renderers.web_payload import build_web_payload as jax_build
    from traceml_tpu_torch.renderers import serving, web_payload

    _jax_scalar_arm(monkeypatch)
    try:
        theirs = jax_build(pruned_db, "hist")
        ours = web_payload.build_web_payload(pruned_db, "hist")
    finally:
        serving.close_all_publishers()
        jax_serving.close_all_publishers()
    assert list(ours) == list(theirs)
    assert_same(ours["history"], theirs["history"], "history")
    hist = ours["history"]["step_time"]
    assert hist["ranks"] == 2 and len(hist["points"]) == 24
    assert set(hist["points"][0]) == {"t", "mean_ms", "min_ms", "max_ms", "res"}


def test_live_store_after_online_prunes_equals_cold_and_jax(tmp_path, monkeypatch):
    from traceml_tpu.reporting.snapshot_store import LiveSnapshotStore as JaxStore
    from traceml_tpu_torch.reporting.snapshot_store import LiveSnapshotStore

    _jax_scalar_arm(monkeypatch)
    db = tmp_path / "telemetry.sqlite"
    w = SQLiteWriter(db, summary_window_rows=WINDOW)
    w.start()
    live, jax_live = LiveSnapshotStore(db), JaxStore(db)
    rollup_versions = []

    def same_windows(a, b):
        assert a.step_time_rows() == b.step_time_rows()
        assert a.step_memory_rows() == b.step_memory_rows()
        assert a.process_rows() == b.process_rows()

    try:
        for i, tick in enumerate(_stream()):
            for p in tick:
                w.ingest(normalize_telemetry_envelope(json.loads(json.dumps(p))))
            assert w.force_flush(timeout=30)
            live.refresh()
            jax_live.refresh()
            rollup_versions.append(live.versions["rollup"])
            if i % 8 == 7 or i >= 26:
                cold = LiveSnapshotStore(db)
                try:
                    cold.refresh()
                    same_windows(live, cold)
                finally:
                    cold.close()
                same_windows(live, jax_live)
        assert w.stats()["prune"]["prunes"] == 8
        assert rollup_versions[0] == 0 and rollup_versions[-1] > 0  # the online prunes moved it
        # pruned to 12 at tick 27 (270 rows), then six ticks of 10 more
        assert {len(rows) for rows in live.step_time_rows().values()} == {int(WINDOW * 1.5) + 60}
        assert w.finalize(timeout=30)
        live.refresh()
        jax_live.refresh()
        cold = LiveSnapshotStore(db)
        try:
            cold.refresh()
            same_windows(live, cold)
            same_windows(live, jax_live)
            assert {len(r) for r in live.step_time_rows().values()} == {int(WINDOW * 1.5)}
            assert live.has_rollups() and live.stitched_overview() == cold.stitched_overview()
            assert live.stitched_overview() == jax_live.stitched_overview()
        finally:
            cold.close()
    finally:
        live.close()
        jax_live.close()
