"""Shared identity columns of the projection writers.

Counterpart of ``traceml_tpu/aggregator/sqlite_writers/common.py``.
Every projection table leads with the same stable identity columns; the
writers read tables through ``TelemetryEnvelope.column_view``, so a
schema-2 envelope becomes ``executemany`` parameter tuples without
per-row dicts."""

from __future__ import annotations

import json
from typing import Any, Tuple

from traceml_tpu_torch.telemetry.envelope import TelemetryEnvelope

IDENTITY_COLS = (
    "session_id",
    "global_rank",
    "local_rank",
    "world_size",
    "local_world_size",
    "node_rank",
    "hostname",
    "pid",
)

IDENTITY_SCHEMA = """
    session_id TEXT,
    global_rank INTEGER,
    local_rank INTEGER,
    world_size INTEGER,
    local_world_size INTEGER,
    node_rank INTEGER,
    hostname TEXT,
    pid INTEGER
"""


def identity_tuple(env: TelemetryEnvelope) -> Tuple[Any, ...]:
    m = env.meta
    return (
        str(m.get("session_id", "unknown")),
        int(m.get("global_rank", m.get("rank", 0))),
        int(m.get("local_rank", 0)),
        int(m.get("world_size", 1)),
        int(m.get("local_world_size", 1)),
        int(m.get("node_rank", 0)),
        str(m.get("hostname", "")),
        int(m.get("pid", 0)),
    )


def dumps(obj: Any) -> str:
    try:
        return json.dumps(obj)
    except (TypeError, ValueError):
        return json.dumps(str(obj))

