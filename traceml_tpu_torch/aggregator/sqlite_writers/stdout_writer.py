"""stdout/stderr projection → ``stdout_samples``.

Counterpart of ``traceml_tpu/aggregator/sqlite_writers/stdout_writer.py``
(copied: same table and columns; like the JAX module it declares no
index).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from traceml_tpu_torch.aggregator.sqlite_writers.common import (
    IDENTITY_SCHEMA,
    identity_tuple,
)
from traceml_tpu_torch.telemetry.envelope import TelemetryEnvelope

TABLE = "stdout_samples"
# tables the writer's watermark retention prunes per (session, rank)
RETENTION_TABLES = (TABLE,)


def accepts_sampler(name: str) -> bool:
    return name == "stdout_stderr"


def init_schema(conn) -> None:
    conn.execute(
        f"""CREATE TABLE IF NOT EXISTS {TABLE} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            {IDENTITY_SCHEMA},
            timestamp REAL,
            stream TEXT,
            line TEXT
        )"""
    )


def insert_sql(table: str) -> str:
    return (
        f"INSERT INTO {TABLE} (session_id, global_rank, local_rank, world_size,"
        " local_world_size, node_rank, hostname, pid, timestamp, stream, line)"
        " VALUES (?,?,?,?,?,?,?,?,?,?,?)"
    )


def build_rows(env: TelemetryEnvelope) -> Dict[str, List[Tuple]]:
    v = env.column_view("stdout_stderr")
    if not v:
        return {}
    ident = identity_tuple(env)
    ts = v.floats("timestamp")
    streams = v.strs("stream", "stdout")
    lines = v.strs("line", "")
    out = [
        ident + (ts[i], streams[i], lines[i][:4096])
        for i in range(len(v))
    ]
    return {TABLE: out}
