"""step_time projection → ``step_time_samples``.

Counterpart of ``traceml_tpu/aggregator/sqlite_writers/step_time_writer.py``
with the same tables and columns.

One row per (rank, step): stable identity columns + ``events_json``
payload (the per-phase {cpu_ms, device_ms, count} dict from the
step-time sampler) + the selected clock.  And ``model_stats_samples``:
one row per change of a rank's FLOPs declaration (the MFU inputs).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from traceml_tpu_torch.aggregator.sqlite_writers.common import (
    IDENTITY_SCHEMA,
    dumps,
    identity_tuple,
)
from traceml_tpu_torch.telemetry.envelope import TelemetryEnvelope

TABLE = "step_time_samples"
MODEL_STATS_TABLE = "model_stats_samples"


def accepts_sampler(name: str) -> bool:
    return name == "step_time"


def init_schema(conn) -> None:
    conn.execute(
        f"""CREATE TABLE IF NOT EXISTS {TABLE} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            {IDENTITY_SCHEMA},
            step INTEGER,
            timestamp REAL,
            clock TEXT,
            late_markers INTEGER,
            events_json TEXT
        )"""
    )
    conn.execute(
        f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_rank_step "
        f"ON {TABLE} (session_id, global_rank, step)"
    )
    conn.execute(
        f"""CREATE TABLE IF NOT EXISTS {MODEL_STATS_TABLE} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            {IDENTITY_SCHEMA},
            timestamp REAL,
            flops_per_step REAL,
            flops_source TEXT,
            device_kind TEXT,
            peak_flops REAL,
            device_count INTEGER,
            tokens_per_step REAL
        )"""
    )


def insert_sql(table: str) -> str:
    if table == MODEL_STATS_TABLE:
        return (
            f"INSERT INTO {MODEL_STATS_TABLE} (session_id, global_rank,"
            " local_rank, world_size, local_world_size, node_rank, hostname,"
            " pid, timestamp, flops_per_step, flops_source, device_kind,"
            " peak_flops, device_count, tokens_per_step)"
            " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)"
        )
    return (
        f"INSERT INTO {TABLE} (session_id, global_rank, local_rank, world_size,"
        " local_world_size, node_rank, hostname, pid, step, timestamp, clock,"
        " late_markers, events_json) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)"
    )


def build_rows(env: TelemetryEnvelope) -> Dict[str, List[Tuple]]:
    ident = identity_tuple(env)
    tables: Dict[str, List[Tuple]] = {}
    v = env.column_view("step_time")
    if v:
        steps = v.ints("step")
        ts = v.floats("timestamp")
        clocks = v.strs("clock", "host")
        late = v.ints("late_markers")
        events = v.col("events")
        tables[TABLE] = [
            ident
            + (
                steps[i],
                ts[i],
                clocks[i],
                late[i] or 0,
                dumps(events[i] if events[i] is not None else {}),
            )
            for i in range(len(v))
        ]
    v = env.column_view("model_stats")
    if v:
        ts = v.floats("timestamp")
        flops = v.floats("flops_per_step")
        source = v.col("flops_source")
        kind = v.col("device_kind")
        peak = v.floats("peak_flops")
        count = v.ints("device_count")
        tokens = v.floats("tokens_per_step")
        tables[MODEL_STATS_TABLE] = [
            ident + (ts[i], flops[i], source[i], kind[i], peak[i], count[i], tokens[i])
            for i in range(len(v))
        ]
    return tables
