"""The port's watermark retention and rollup tiers against the JAX
package's.

* One stream, two writers: two ranks' step_time, step_memory and process
  envelopes (fixed timestamps 0.7 s apart, 330 steps, so the run crosses
  many 10 s and several 1 m buckets; ``summary_window_rows`` 8, so
  retention is 12 rows and a partition is pruned online once it holds
  12 + 256) go through the JAX ``SQLiteWriter`` and the port's, a flush
  barrier after every tick.  After ``finalize`` the raw survivors of
  every table, ``retention_watermarks`` (all but ``ts``),
  ``rollup_samples_10s`` and ``rollup_samples_1m`` are equal: counts,
  step ranges and ids exactly, sums and sums of squares bit for bit (both
  fold the same rows in the same order with the same IEEE operations),
  and so are the prune and fold counters.  Every ingested step is raw or
  rolled up, and the online prune fired before ``finalize``.
* The JAX ``test_rollup_retention.py`` cases on the port: the vectorised
  fold equals the scalar fold bit for bit on ragged arrivals (and the JAX
  fold); ``parse_tiers`` reads the same strings as JAX;
  ``TRACEML_ROLLUP=0`` creates no tier and discards history; a prune
  transaction rolled back leaves every row raw, the retried one commits
  fold and delete together; a short 10 s horizon decays the 10 s tier and
  the 1 m tier still covers the run, as in JAX.
* The ``rank_seq`` dedup of the crash-resume path still drops replays
  after a prune, in the same transaction, as the JAX writer does.
* The mesh-axis grains: the same stream after each rank's
  ``mesh_topology`` row, for a 2-rank layout on one host (the ``fsdp``
  axis of size 2 over ICI, the others of size 1) and a 2-node one (rank r
  on node r, host ``h<r>``, the ``data`` axis over DCN): both writers'
  tier tables are equal row for row, and they hold the ``axis:fsdp`` or
  ``dcn_side:data`` series of each coordinate (no grain for an axis of
  size 1), each equal to the matching ``rank`` series.
"""

import json
import random
import sqlite3

import pytest

from test_torch_sqlite import memory_rows, process_rows, step_rows
from traceml_tpu.aggregator import rollup as jax_rollup
from traceml_tpu.aggregator.sqlite_writer import SQLiteWriter as JaxWriter
from traceml_tpu.telemetry.envelope import normalize_telemetry_envelope as jax_normalize
from traceml_tpu_torch.aggregator import rollup
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.telemetry.envelope import SenderIdentity, normalize_telemetry_envelope, rows_to_columns

N_STEPS, PER_TICK, DT = 330, 10, 0.7
WINDOW = 8  # retention 12
TABLES = ("step_time_samples", "step_memory_samples", "process_samples", "process_device_samples",
          "model_stats_samples")


def _envelope(rank, sampler, tables, seq, nodes=1):
    """One rank's envelope; with ``nodes=2`` rank r runs alone on node r
    (host ``h<r>``)."""
    two = nodes == 2
    meta = SenderIdentity(session_id="s", global_rank=rank, local_rank=0 if two else rank, world_size=2,
                          local_world_size=1 if two else 2, node_rank=rank if two else 0,
                          hostname=f"h{rank}" if two else "h", pid=100 + rank).to_meta()
    meta.update({"schema": 2, "sampler": sampler, "timestamp": 1.7e9})
    if seq is not None:
        meta["seq"] = seq
    return {"meta": meta, "body": {"tables": {t: rows_to_columns(r) for t, r in tables.items()}}}


def _retimed(rows):
    for r in rows:
        r["timestamp"] = 1.7e9 + r["step"] * DT
    return rows


def _stream(seq_base=None, nodes=1):
    """Ticks of envelopes, in the order the JAX writer's lanes commit them
    (the step lanes first, then process)."""
    data = {}
    for rank in (0, 1):
        steps = _retimed(step_rows(40 + rank, N_STEPS, 2.0 + rank, 90.0))
        mem = _retimed(memory_rows(50 + rank, N_STEPS, 0.4, every=1))
        proc = process_rows(60 + rank, N_STEPS)
        for t in proc.values():
            for i, r in enumerate(t):
                r["timestamp"] = 1.7e9 + (i + 1) * DT
        data[rank] = (steps, mem, proc)
    ticks, seq = [], {0: 0, 1: 0}
    for lo in range(0, N_STEPS, PER_TICK):
        tick = []
        for sampler in ("step_time", "step_memory", "process"):
            for rank in (0, 1):
                steps, mem, proc = data[rank]
                tables = {"step_time": {"step_time": steps[lo:lo + PER_TICK]},
                          "step_memory": {"step_memory": mem[lo:lo + PER_TICK]},
                          "process": {t: proc[t][lo:lo + PER_TICK] for t in ("process", "process_device")}}[sampler]
                seq[rank] += 1
                tick.append(_envelope(rank, sampler, tables, None if seq_base is None else seq_base + seq[rank],
                                      nodes))
        ticks.append(tick)
    return ticks


def _write(writer, normalize, ticks):
    writer.start()
    for tick in ticks:
        for p in tick:
            assert writer.ingest(normalize(json.loads(json.dumps(p))))
        assert writer.force_flush(timeout=30)
    return writer


def _dump(db, table, drop=()):
    conn = sqlite3.connect(db)
    try:
        cols = [r[1] for r in conn.execute(f"PRAGMA table_info({table})") if r[1] not in drop]
        return cols, conn.execute(f"SELECT {', '.join(cols)} FROM {table} ORDER BY rowid").fetchall()
    finally:
        conn.close()


def test_same_stream_gives_the_same_survivors_journal_and_tiers(tmp_path):
    ticks = _stream()
    jax = _write(JaxWriter(tmp_path / "jax.sqlite", summary_window_rows=WINDOW), jax_normalize, ticks)
    port = _write(SQLiteWriter(tmp_path / "port.sqlite", summary_window_rows=WINDOW), normalize_telemetry_envelope,
                  ticks)
    online = port.stats()["prune"]["prunes"]
    assert online == jax.stats()["prune"]["prunes"] == 8  # the 8 partitions, once each, before finalize
    assert jax.finalize(timeout=30) and port.finalize(timeout=30)
    jdb, pdb = tmp_path / "jax.sqlite", tmp_path / "port.sqlite"
    for table in TABLES + ("rollup_samples_10s", "rollup_samples_1m"):
        assert _dump(pdb, table) == _dump(jdb, table), table
    assert _dump(pdb, "retention_watermarks", drop=("ts",)) == _dump(jdb, "retention_watermarks", drop=("ts",))
    js, ps = jax.stats(), port.stats()
    assert ps["rollup"] == js["rollup"] | {"fold_ms_total": ps["rollup"]["fold_ms_total"],
                                           "fold_ms_max": ps["rollup"]["fold_ms_max"]}
    assert {k: ps["prune"][k] for k in ("prunes", "rows_pruned", "retention_rows")} == {
        k: js["prune"][k] for k in ("prunes", "rows_pruned", "retention_rows")}
    conn = sqlite3.connect(pdb)
    try:
        for table in TABLES[:4]:
            assert max(n for (n,) in conn.execute(
                f"SELECT COUNT(*) FROM {table} GROUP BY session_id, global_rank")) == int(WINDOW * 1.5)
        for rank in (0, 1):
            raw = conn.execute("SELECT COUNT(*) FROM step_time_samples WHERE global_rank=?", (rank,)).fetchone()[0]
            folded = conn.execute("SELECT SUM(count), MIN(step_min), MAX(step_max) FROM rollup_samples_10s WHERE "
                                  "grain='rank' AND grain_key=? AND metric='step_ms'", (str(rank),)).fetchone()
            assert raw + folded[0] == N_STEPS and folded[1:] == (1, N_STEPS - raw)
        kinds = {r[0] for r in conn.execute("SELECT DISTINCT source_table FROM rollup_samples_1m")}
        assert kinds == {"step_time_samples", "step_memory_samples"}
    finally:
        conn.close()


# -- the JAX rollup cases ------------------------------------------------------


def _ragged_arrivals(rng, n):
    ts, steps, vals = [], [], []
    t = rng.uniform(0, 50)
    for i in range(n):
        if rng.random() < 0.15:
            t -= rng.uniform(0, 5)
        elif rng.random() >= 0.2:
            t += rng.expovariate(1.0)
        ts.append(t)
        steps.append(i if rng.random() > 0.1 else None)
        vals.append(rng.uniform(-1e3, 1e6))
    return ts, steps, vals


@pytest.mark.parametrize("width", [10.0, 60.0, 7.5])
def test_fold_is_bit_exact_with_its_scalar_twin_and_the_jax_fold(width):
    rng = random.Random(20260808)
    for _ in range(40):
        ts, steps, vals = _ragged_arrivals(rng, rng.randrange(1, 400))
        fast = rollup.fold_buckets(ts, steps, vals, width)
        assert fast == rollup.fold_buckets_reference(ts, steps, vals, width)
        assert fast == jax_rollup.fold_buckets(ts, steps, vals, width)
    assert rollup.fold_buckets([], [], [], 10.0) == []
    assert rollup.fold_buckets([1.0, 2.0, 11.0], [None] * 3, [3.0, 4.0, 5.0], 10.0) == \
        jax_rollup.fold_buckets_reference([1.0, 2.0, 11.0], [None] * 3, [3.0, 4.0, 5.0], 10.0)


@pytest.mark.parametrize("raw", ["10:21600,60:1209600", "5:100", "30", "", "abc", "10:-5", "0:100",
                                 "10:100,junk", None])
def test_parse_tiers_as_jax(raw):
    assert rollup.parse_tiers(raw) == jax_rollup.parse_tiers(raw)
    assert rollup.DEFAULT_TIERS == jax_rollup.DEFAULT_TIERS


def _step_stream(n, rank=0, dt=0.4):
    rows = [{"step": s, "timestamp": s * dt, "clock": "host",
             "events": {"_traceml_internal:step_time": {"cpu_ms": 100.0 + (s % 7) * 0.3, "count": 1}}}
            for s in range(1, n + 1)]
    return [[_envelope(rank, "step_time", {"step_time": rows[i:i + 1]}, None)] for i in range(n)]


def test_rollup_kill_switch_discards_history(tmp_path, monkeypatch):
    monkeypatch.setenv("TRACEML_ROLLUP", "0")
    w = _write(SQLiteWriter(tmp_path / "t.sqlite", summary_window_rows=20), normalize_telemetry_envelope,
               [sum(_step_stream(200), [])])
    assert w.finalize() and w.stats()["rollup"] == {"enabled": False}
    conn = sqlite3.connect(tmp_path / "t.sqlite")
    try:
        assert conn.execute("SELECT name FROM sqlite_master WHERE name='rollup_samples_10s'").fetchone() is None
        assert conn.execute("SELECT COUNT(*) FROM step_time_samples").fetchone()[0] == 30
    finally:
        conn.close()


def test_crash_atomicity_rollback_leaves_raw_rows_intact(tmp_path):
    db = tmp_path / "t.sqlite"
    w = _write(SQLiteWriter(db, summary_window_rows=500, retention_factor=1.0), normalize_telemetry_envelope,
               [sum(_step_stream(100), [])])
    assert w.finalize()
    conn = sqlite3.connect(db)
    engine = rollup.RollupEngine()
    engine.init_schema(conn)
    conn.commit()
    watermark = conn.execute("SELECT id FROM step_time_samples ORDER BY id LIMIT 1 OFFSET 59").fetchone()[0]

    def prune_txn(c):
        engine.fold_doomed(c, "step_time_samples", "s", 0, watermark)
        c.execute("DELETE FROM step_time_samples WHERE session_id='s' AND global_rank=0 AND id<=?", (watermark,))

    prune_txn(conn)
    conn.rollback()  # a crash before the commit
    assert conn.execute("SELECT COUNT(*) FROM step_time_samples").fetchone()[0] == 100
    assert conn.execute("SELECT COUNT(*) FROM rollup_samples_10s").fetchone()[0] == 0
    prune_txn(conn)
    conn.commit()
    raw = conn.execute("SELECT COUNT(*) FROM step_time_samples").fetchone()[0]
    folded = conn.execute("SELECT SUM(count) FROM rollup_samples_10s WHERE grain='rank' AND grain_key='0'").fetchone()[0]
    host = conn.execute("SELECT SUM(count) FROM rollup_samples_1m WHERE grain='host' AND grain_key='h'").fetchone()[0]
    conn.close()
    assert (raw, folded, host) == (40, 60, 60)


def test_tier_decay_as_jax(tmp_path, monkeypatch):
    """A 120 s horizon on the 10 s tier: both writers decay it alike, and
    the 1 m tier still holds every step."""
    monkeypatch.setenv("TRACEML_ROLLUP_TIERS", "10:120,60:1209600")
    stream = [sum(_step_stream(600, dt=2.0)[i:i + 20], []) for i in range(0, 600, 20)]
    jax = _write(JaxWriter(tmp_path / "jax.sqlite", summary_window_rows=20), jax_normalize, stream)
    port = _write(SQLiteWriter(tmp_path / "port.sqlite", summary_window_rows=20), normalize_telemetry_envelope,
                  stream)
    assert jax.finalize() and port.finalize()
    assert port.stats()["rollup"]["rows_decayed"] == jax.stats()["rollup"]["rows_decayed"] > 0
    for table in ("rollup_samples_10s", "rollup_samples_1m", "step_time_samples"):
        assert _dump(tmp_path / "port.sqlite", table) == _dump(tmp_path / "jax.sqlite", table), table
    conn = sqlite3.connect(tmp_path / "port.sqlite")
    try:
        assert conn.execute("SELECT SUM(count) FROM rollup_samples_1m WHERE grain='rank'").fetchone()[0] + 30 == 600
    finally:
        conn.close()


def test_replays_after_a_prune_are_dropped(tmp_path):
    """Envelopes with seqs go past an online prune; then a rank's spool
    replays ticks already committed: both writers drop them (counted in
    ``replay_duplicates``) and the tables, tiers and ``rank_seq`` stay
    equal to the JAX writer's."""
    ticks = _stream(seq_base=1000)
    replay = [p for tick in ticks[20:30] for p in tick if p["meta"]["global_rank"] == 0]
    stream = ticks + [replay]
    jax = _write(JaxWriter(tmp_path / "jax.sqlite", summary_window_rows=WINDOW), jax_normalize, stream)
    port = _write(SQLiteWriter(tmp_path / "port.sqlite", summary_window_rows=WINDOW), normalize_telemetry_envelope,
                  stream)
    assert port.stats()["prune"]["prunes"] == 8 and port.replay_duplicates == jax.replay_duplicates == len(replay)
    assert jax.finalize() and port.finalize()
    for table in TABLES + ("rollup_samples_10s", "rank_seq"):
        assert _dump(tmp_path / "port.sqlite", table) == _dump(tmp_path / "jax.sqlite", table), table
    conn = sqlite3.connect(tmp_path / "port.sqlite")
    try:
        folded = conn.execute("SELECT SUM(count) FROM rollup_samples_10s WHERE grain='rank' AND grain_key='0'"
                              " AND metric='step_ms'").fetchone()[0]
        raw = conn.execute("SELECT COUNT(*) FROM step_time_samples WHERE global_rank=0").fetchone()[0]
    finally:
        conn.close()
    assert folded + raw == N_STEPS  # no replayed row stored or folded twice


# -- the mesh-axis grains --------------------------------------------------------

MESH_LAYOUTS = {
    # one host, 2 ranks on the fsdp axis (the others of size 1)
    "2-rank": (1, [{"name": "data", "size": 1, "kind": "ici"}, {"name": "fsdp", "size": 2, "kind": "ici"},
                   {"name": "tensor", "size": 1, "kind": "ici"}, {"name": "context", "size": 1, "kind": "ici"}],
               lambda r: [0, r, 0, 0], "axis:fsdp"),
    # two nodes, one rank each, the data axis across the node boundary
    "2-node": (2, [{"name": "data", "size": 2, "kind": "dcn"}, {"name": "fsdp", "size": 1, "kind": "ici"}],
               lambda r: [r, 0], "dcn_side:data"),
}


def _mesh_envelope(rank, nodes, axes, coords):
    row = {"timestamp": 1.7e9, "source": "mesh", "axes_json": json.dumps(axes), "coords_json": json.dumps(coords)}
    return _envelope(rank, "mesh_topology", {"mesh_topology": [row]}, None, nodes)


@pytest.mark.parametrize("layout", sorted(MESH_LAYOUTS))
def test_mesh_axis_grains_as_jax(tmp_path, layout):
    nodes, axes, coords, grain = MESH_LAYOUTS[layout]
    ticks = _stream(nodes=nodes)
    ticks[0] = [_mesh_envelope(r, nodes, axes, coords(r)) for r in (0, 1)] + ticks[0]
    jax = _write(JaxWriter(tmp_path / "jax.sqlite", summary_window_rows=WINDOW), jax_normalize, ticks)
    port = _write(SQLiteWriter(tmp_path / "port.sqlite", summary_window_rows=WINDOW), normalize_telemetry_envelope,
                  ticks)
    assert jax.finalize(timeout=30) and port.finalize(timeout=30)
    jdb, pdb = tmp_path / "jax.sqlite", tmp_path / "port.sqlite"
    for table in ("rollup_samples_10s", "rollup_samples_1m", "mesh_topology"):
        assert _dump(pdb, table) == _dump(jdb, table), table
    assert port.stats()["rollup"]["rows_upserted"] == jax.stats()["rollup"]["rows_upserted"]
    conn = sqlite3.connect(pdb)
    try:
        grains = {r for r in conn.execute("SELECT DISTINCT grain, grain_key FROM rollup_samples_10s")}
        series = {}
        for g, key, bucket, count, total in conn.execute(
                "SELECT grain, grain_key, bucket_ts, count, sum FROM rollup_samples_10s WHERE "
                "source_table='step_time_samples' AND metric='step_ms' ORDER BY bucket_ts"):
            series.setdefault((g, key), []).append((bucket, count, total))
    finally:
        conn.close()
    hosts = {("host", "h")} if nodes == 1 else {("host", "h0"), ("host", "h1")}
    assert grains == {("rank", "0"), ("rank", "1"), (grain, "0"), (grain, "1")} | hosts
    for r in (0, 1):  # each coordinate of the axis holds one rank here
        assert series[(grain, str(r))] == series[("rank", str(r))]

