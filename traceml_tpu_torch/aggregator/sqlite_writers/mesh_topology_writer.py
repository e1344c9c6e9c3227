"""mesh_topology control message → ``mesh_topology``.

Counterpart of ``traceml_tpu/aggregator/sqlite_writers/mesh_topology_writer.py``
(copied: same table and columns).  One row per rank per capture: the
aggregator re-wraps the one-shot ``mesh_topology`` control message into
an envelope, and a replay may append duplicates, so readers keep the
latest row per rank.  Not in ``RETENTION_TABLES``: a handful of rows per
rank for the whole run, and trimming them would forget the mesh
mid-session.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from traceml_tpu_torch.aggregator.sqlite_writers.common import (
    IDENTITY_SCHEMA,
    identity_tuple,
)
from traceml_tpu_torch.telemetry.envelope import TelemetryEnvelope

TABLE = "mesh_topology"
RETENTION_TABLES = ()


def accepts_sampler(name: str) -> bool:
    return name == "mesh_topology"


def init_schema(conn) -> None:
    conn.execute(
        f"""CREATE TABLE IF NOT EXISTS {TABLE} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            {IDENTITY_SCHEMA},
            timestamp REAL,
            source TEXT,
            axes_json TEXT,
            coords_json TEXT
        )"""
    )


def insert_sql(table: str) -> str:
    return (
        f"INSERT INTO {TABLE} (session_id, global_rank, local_rank, world_size,"
        " local_world_size, node_rank, hostname, pid, timestamp, source,"
        " axes_json, coords_json)"
        " VALUES (?,?,?,?,?,?,?,?,?,?,?,?)"
    )


def build_rows(env: TelemetryEnvelope) -> Dict[str, List[Tuple]]:
    v = env.column_view(TABLE)
    if not v:
        return {}
    ident = identity_tuple(env)
    ts = v.floats("timestamp")
    sources = v.strs("source", "mesh")
    axes = v.strs("axes_json", "[]")
    coords = v.strs("coords_json", "null")
    return {
        TABLE: [
            ident + (ts[i], sources[i], axes[i], coords[i])
            for i in range(len(v))
        ]
    }
