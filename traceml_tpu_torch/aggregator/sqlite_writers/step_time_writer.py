"""step_time projection → ``step_time_samples``.

Counterpart of ``traceml_tpu/aggregator/sqlite_writers/step_time_writer.py``
with the same table and columns (the ``model_stats`` projection comes
with FLOPs and MFU).

One row per (rank, step): stable identity columns + ``events_json``
payload (the per-phase {cpu_ms, device_ms, count} dict from the
step-time sampler) + the selected clock.
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


def insert_sql(table: str) -> str:
    return (
        f"INSERT INTO {TABLE} (session_id, global_rank, local_rank, world_size,"
        " local_world_size, node_rank, hostname, pid, step, timestamp, clock,"
        " late_markers, events_json) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)"
    )


def build_rows(env: TelemetryEnvelope) -> Dict[str, List[Tuple]]:
    v = env.column_view("step_time")
    if not v:
        return {}
    ident = identity_tuple(env)
    steps = v.ints("step")
    ts = v.floats("timestamp")
    clocks = v.strs("clock", "host")
    late = v.ints("late_markers")
    events = v.col("events")
    out = [
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
    return {TABLE: out}
