"""collectives projection → ``collectives_samples``.

Counterpart of ``traceml_tpu/aggregator/sqlite_writers/collectives_writer.py``
(copied: same table and columns).  One row per (rank, step, op, dtype):
the stable identity columns and the per-step aggregates the sampler emits
(count, bytes, group_size, duration_ms, exposed_ms).  Overlap efficiency
is derived downstream (``utils/columnar.py``) from the duration and
exposed sums, so the fold stays exact and re-foldable over any window.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from traceml_tpu_torch.aggregator.sqlite_writers.common import (
    IDENTITY_SCHEMA,
    identity_tuple,
)
from traceml_tpu_torch.telemetry.envelope import TelemetryEnvelope

TABLE = "collectives_samples"
RETENTION_TABLES = (TABLE,)


def accepts_sampler(name: str) -> bool:
    return name == "collectives"


def init_schema(conn) -> None:
    conn.execute(
        f"""CREATE TABLE IF NOT EXISTS {TABLE} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            {IDENTITY_SCHEMA},
            step INTEGER,
            timestamp REAL,
            op TEXT,
            dtype TEXT,
            count INTEGER,
            bytes INTEGER,
            group_size INTEGER,
            duration_ms REAL,
            exposed_ms REAL
        )"""
    )
    conn.execute(
        f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_rank_step "
        f"ON {TABLE} (session_id, global_rank, step)"
    )


def insert_sql(table: str) -> str:
    return (
        f"INSERT INTO {TABLE} (session_id, global_rank, local_rank, world_size,"
        " local_world_size, node_rank, hostname, pid, step, timestamp, op,"
        " dtype, count, bytes, group_size, duration_ms, exposed_ms)"
        " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)"
    )


def build_rows(env: TelemetryEnvelope) -> Dict[str, List[Tuple]]:
    ident = identity_tuple(env)
    tables: Dict[str, List[Tuple]] = {}
    v = env.column_view("collectives")
    if v:
        steps = v.ints("step")
        ts = v.floats("timestamp")
        ops = v.strs("op", "other")
        dtypes = v.strs("dtype", "")
        counts = v.ints("count")
        nbytes = v.ints("bytes")
        groups = v.ints("group_size")
        dur = v.floats("duration_ms")
        exp = v.floats("exposed_ms")
        tables[TABLE] = [
            ident
            + (
                steps[i],
                ts[i],
                ops[i],
                dtypes[i],
                counts[i] or 0,
                nbytes[i] or 0,
                groups[i] or 1,
                dur[i] or 0.0,
                exp[i] or 0.0,
            )
            for i in range(len(v))
        ]
    return tables
