"""step_memory projection → ``step_memory_samples``.

Counterpart of ``traceml_tpu/aggregator/sqlite_writers/step_memory_writer.py``
(copied: same table and columns).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from traceml_tpu_torch.aggregator.sqlite_writers.common import (
    IDENTITY_SCHEMA,
    identity_tuple,
)
from traceml_tpu_torch.telemetry.envelope import TelemetryEnvelope

TABLE = "step_memory_samples"


def accepts_sampler(name: str) -> bool:
    return name == "step_memory"


def init_schema(conn) -> None:
    conn.execute(
        f"""CREATE TABLE IF NOT EXISTS {TABLE} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            {IDENTITY_SCHEMA},
            step INTEGER,
            timestamp REAL,
            device_id INTEGER,
            device_kind TEXT,
            current_bytes INTEGER,
            peak_bytes INTEGER,
            step_peak_bytes INTEGER,
            limit_bytes INTEGER,
            backend TEXT
        )"""
    )
    conn.execute(
        f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_rank_step "
        f"ON {TABLE} (session_id, global_rank, step)"
    )


def insert_sql(table: str) -> str:
    return (
        f"INSERT INTO {TABLE} (session_id, global_rank, local_rank, world_size,"
        " local_world_size, node_rank, hostname, pid, step, timestamp, device_id,"
        " device_kind, current_bytes, peak_bytes, step_peak_bytes, limit_bytes,"
        " backend) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)"
    )


def build_rows(env: TelemetryEnvelope) -> Dict[str, List[Tuple]]:
    v = env.column_view("step_memory")
    if not v:
        return {}
    ident = identity_tuple(env)
    steps = v.ints("step")
    ts = v.floats("timestamp")
    dev_id = v.ints("device_id")
    kind = v.strs("device_kind", "unknown")
    current = v.ints("current_bytes")
    peak = v.ints("peak_bytes")
    step_peak = v.ints("step_peak_bytes")
    limit = v.ints("limit_bytes")
    backend = v.strs("backend", "unknown")
    out = [
        ident
        + (
            steps[i],
            ts[i],
            dev_id[i],
            kind[i],
            current[i],
            peak[i],
            step_peak[i],
            limit[i],
            backend[i],
        )
        for i in range(len(v))
    ]
    return {TABLE: out}
