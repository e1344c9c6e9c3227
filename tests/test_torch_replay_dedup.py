"""The port's replay dedup and crash-resume against the JAX package's.

* Writer: one envelope stream (two ranks; step-time, step-memory and
  process envelopes with ``seq``, one system envelope without), with
  replayed duplicates inside a batch and across batches and a low-lane
  envelope whose seq is below a high-lane one already committed, goes
  through the JAX ``SQLiteWriter`` and the port's, a flush barrier
  between batches.  The ``step_time_samples`` rows, the other tables and
  the ``rank_seq`` tables are equal, and so is ``replay_duplicates``.
* Reopen: the port's writer is reopened on its database and the whole
  stream replayed: nothing is inserted twice, and the maxima it seeded
  equal the ``rank_seq`` table.  The same after a writer process was
  SIGKILLed with its WAL never checkpointed.
* Reseed: a ``rank_status.json`` with a finished rank goes through the
  JAX aggregator's ``_reseed_from_prior_run`` and the port's: the same
  finished and seen ranks and the same liveness states; a file of
  another session is ignored by both.
"""

import json
import sqlite3
import subprocess
import sys
import time
from pathlib import Path

import pytest

from test_torch_sqlite import memory_rows, process_rows, step_rows, system_rows
from traceml_tpu.aggregator.sqlite_writer import SQLiteWriter as JaxWriter
from traceml_tpu.aggregator.trace_aggregator import TraceMLAggregator as JaxAggregator
from traceml_tpu.runtime.settings import TraceMLSettings as JaxSettings
from traceml_tpu.telemetry.envelope import normalize_telemetry_envelope as jax_normalize
from traceml_tpu_torch.aggregator.liveness import RankLivenessTracker
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.aggregator.trace_aggregator import TraceMLAggregator
from traceml_tpu_torch.runtime.settings import TraceMLSettings
from traceml_tpu_torch.telemetry.envelope import SenderIdentity, normalize_telemetry_envelope, rows_to_columns

REPO = Path(__file__).resolve().parent.parent
TABLES = ("step_time_samples", "step_memory_samples", "process_samples", "system_samples")


def _envelope(rank, sampler, tables, seq):
    meta = SenderIdentity(session_id="s", global_rank=rank, local_rank=rank, world_size=2,
                          local_world_size=2, hostname="h", pid=100 + rank).to_meta()
    meta.update({"schema": 2, "sampler": sampler, "timestamp": 1.7e9})
    if seq is not None:
        meta["seq"] = seq
    return {"meta": meta, "body": {"tables": {t: rows_to_columns(r) for t, r in tables.items()}}}


def _stream():
    """Batches of wire payloads for two ranks, each rank's seq counting
    across its samplers: batch 2 replays the tail of batch 1 and carries
    an original with its replay; batch 3 replays batch 2's again and ends
    with rank 1's last tick as the JAX writer's lanes may commit it: the
    step-time envelope first, then the process one with the lower seq."""
    made = {}
    for rank in (0, 1):
        steps = step_rows(10 + rank, 42, 2.0, 18.0)
        mem = memory_rows(20 + rank, 40, 0.4, every=4)
        proc = process_rows(30 + rank, 45)
        envs = []
        for i in range(8):
            envs.append(("step_time", {"step_time": steps[5 * i:5 * i + 5]}))
            if i % 2:
                envs.append(("step_memory", {"step_memory": mem[i - 1:i + 1]}))
            if i % 3 == 0:
                envs.append(("process", {t: proc[t][5 * i:5 * i + 5] for t in ("process", "process_device")}))
        made[rank] = [_envelope(rank, sampler, tables, 1000 * (rank + 1) + k)
                      for k, (sampler, tables) in enumerate(envs)]
    r0, r1 = made[0], made[1]
    last_steps = _envelope(1, "step_time", {"step_time": step_rows(11, 42, 2.0, 18.0)[40:]}, 2016)
    last_proc = _envelope(1, "process", {t: process_rows(31, 45)[t][40:] for t in ("process", "process_device")},
                          2015)
    no_seq = _envelope(0, "system", system_rows(7, 3), None)
    batch1 = r0[:6] + r1[:5]
    batch2 = r0[3:6] + r0[6:9] + [r0[7]] + r1[3:8] + [no_seq]
    batch3 = r0[6:9] + r0[9:] + r1[5:] + [last_steps, last_proc]
    return [batch1, batch2, batch3]


def _write(writer, normalize, batches):
    writer.start()
    for batch in batches:
        for p in batch:
            assert writer.ingest(normalize(json.loads(json.dumps(p))))
        assert writer.force_flush(timeout=30)
    assert writer.finalize(timeout=30)
    return writer


def _dump(db, table, with_id=True):
    conn = sqlite3.connect(db)
    try:
        cols = [r[1] for r in conn.execute(f"PRAGMA table_info({table})") if with_id or r[1] != "id"]
        order = "id" if with_id else ", ".join(cols)
        return cols, conn.execute(f"SELECT {', '.join(cols)} FROM {table} ORDER BY {order}").fetchall()
    finally:
        conn.close()


def _rank_seq(db):
    conn = sqlite3.connect(db)
    try:
        return sorted(conn.execute("SELECT session_id, global_rank, lane, max_seq FROM rank_seq"))
    finally:
        conn.close()


COVERAGE = [(0, s) for s in range(1, 41)] + [(1, s) for s in range(1, 43)]


def _steps(db):
    conn = sqlite3.connect(db)
    try:
        return [tuple(r) for r in conn.execute("SELECT global_rank, step FROM step_time_samples")]
    finally:
        conn.close()


def test_writers_drop_the_same_replays(tmp_path):
    batches = _stream()
    jax = _write(JaxWriter(tmp_path / "jax.sqlite"), jax_normalize, batches)
    port = _write(SQLiteWriter(tmp_path / "port.sqlite"), normalize_telemetry_envelope, batches)
    assert _dump(tmp_path / "jax.sqlite", "step_time_samples") == _dump(tmp_path / "port.sqlite", "step_time_samples")
    for table in TABLES[1:]:
        assert _dump(tmp_path / "jax.sqlite", table, with_id=False) == _dump(tmp_path / "port.sqlite", table,
                                                                             with_id=False), table
    assert _rank_seq(tmp_path / "jax.sqlite") == _rank_seq(tmp_path / "port.sqlite")
    # batch 2: 3 + 1 (inside the batch) + 2; batch 3: 3 + 3
    assert jax.stats()["replay_duplicates"] == port.stats()["replay_duplicates"] == 12
    # every (rank, step) once; rank 1's last process rows (a seq below its
    # high lane's maximum) and the seq-less system rows landed
    assert sorted(_steps(tmp_path / "port.sqlite")) == COVERAGE
    conn = sqlite3.connect(tmp_path / "port.sqlite")
    try:
        assert conn.execute("SELECT COUNT(*) FROM process_samples WHERE global_rank = 1").fetchone()[0] == 3 * 5 + 5
        assert conn.execute("SELECT COUNT(*) FROM system_samples").fetchone()[0] == 3
    finally:
        conn.close()
    lanes = {(r, lane) for _, r, lane, _ in _rank_seq(tmp_path / "port.sqlite")}
    assert lanes == {(0, "high"), (0, "low"), (1, "high"), (1, "low")}


def _seeded(db):
    writer = SQLiteWriter(db)
    writer.start()
    assert writer.force_flush(timeout=30)  # the writer thread has opened and seeded
    return writer


def _replay_everything(writer, batches):
    for batch in batches:
        for p in batch:
            writer.ingest(normalize_telemetry_envelope(json.loads(json.dumps(p))))
    assert writer.finalize(timeout=30)


def _seq_only(batches):
    return [[p for p in b if "seq" in p["meta"]] for b in batches]


def test_reopened_writer_inserts_nothing_twice(tmp_path):
    db = tmp_path / "t.sqlite"
    batches = _seq_only(_stream())
    _write(SQLiteWriter(db), normalize_telemetry_envelope, batches)
    before = {t: _dump(db, t) for t in TABLES}
    writer = _seeded(db)
    assert sorted((k[0], k[1], k[2], v) for k, v in writer._seq_max.items()) == _rank_seq(db)
    _replay_everything(writer, batches)
    assert {t: _dump(db, t) for t in TABLES} == before
    assert writer.stats()["replay_duplicates"] == sum(len(b) for b in batches)
    assert writer.stats()["written"] == 0


_KILLED_WRITER = """
import json, os, signal, sys
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.telemetry.envelope import normalize_telemetry_envelope
writer = SQLiteWriter(sys.argv[1])
writer.start()
for batch in json.load(open(sys.argv[2])):
    for p in batch:
        writer.ingest(normalize_telemetry_envelope(p))
    assert writer.force_flush(timeout=30)
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_writer_resumes_a_database_left_by_a_sigkill(tmp_path):
    db = tmp_path / "t.sqlite"
    batches = _seq_only(_stream())
    (tmp_path / "stream.json").write_text(json.dumps(batches[:2]))
    proc = subprocess.run([sys.executable, "-c", _KILLED_WRITER, str(db), str(tmp_path / "stream.json")],
                          env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == -9, proc.stderr[-2000:]
    wal = db.with_name(db.name + "-wal")
    assert wal.exists() and wal.stat().st_size > 0  # never checkpointed
    writer = _seeded(db)
    assert sorted((k[0], k[1], k[2], v) for k, v in writer._seq_max.items()) == _rank_seq(db)
    _replay_everything(writer, batches)  # the spools replay everything, batch 3 is new
    assert sorted(_steps(db)) == COVERAGE
    reference = tmp_path / "ref.sqlite"
    _write(SQLiteWriter(reference), normalize_telemetry_envelope, batches)
    for table in TABLES:
        assert _dump(db, table, with_id=False) == _dump(reference, table, with_id=False), table
    assert _rank_seq(db) == _rank_seq(reference)


def _status_file(session_dir, session_id):
    tracker = RankLivenessTracker(stale_after=10.0, lost_after=30.0)
    now = time.time()
    tracker.observe(0, now - 50.0, progress=True)
    tracker.mark_finished(0, now - 40.0)
    tracker.observe(1, now - 20.0, progress=True)
    tracker.observe(1, now - 12.0)
    tracker.observe(2, now - 1.0)
    snap = tracker.snapshot(now)
    if session_id is not None:
        snap["session_id"] = session_id
    snap["expected_world_size"] = 3
    session_dir.mkdir(parents=True, exist_ok=True)
    (session_dir / "rank_status.json").write_text(json.dumps(snap))
    return now


@pytest.mark.parametrize("owner", ["same", "unnamed", "other"])
def test_reseed_restores_finished_ranks_like_jax(tmp_path, owner):
    sid = "run_1"
    now = _status_file(tmp_path / sid, {"same": sid, "unnamed": None, "other": "run_0"}[owner])
    jax = JaxAggregator(JaxSettings(session_id=sid, logs_dir=tmp_path, mode="summary"))
    port = TraceMLAggregator(TraceMLSettings(session_id=sid, logs_dir=tmp_path, mode="summary"))
    jax._reseed_from_prior_run()
    port._reseed_from_prior_run()
    assert (jax._finished_ranks, jax._seen_ranks) == (port._finished_ranks, port._seen_ranks)
    assert jax.liveness.snapshot(now) == port.liveness.snapshot(now)
    states = {r: port.liveness.state_of(r, now) for r in port.liveness.ranks()}
    assert states == {r: jax.liveness.state_of(r, now) for r in jax.liveness.ranks()}
    if owner == "other":
        assert port._finished_ranks == port._seen_ranks == set() and states == {}
    else:
        assert port._finished_ranks == {0} and port._seen_ranks == {0, 1, 2}
        assert states == {0: "finished", 1: "stale", 2: "active"}
