"""process projection → ``process_samples`` + ``process_device_samples``.

Counterpart of ``traceml_tpu/aggregator/sqlite_writers/process_writer.py`` (copied: same
tables, columns and indexes).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from traceml_tpu_torch.aggregator.sqlite_writers.common import (
    IDENTITY_SCHEMA,
    identity_tuple,
)
from traceml_tpu_torch.telemetry.envelope import TelemetryEnvelope

TABLE = "process_samples"
TABLE_DEVICE = "process_device_samples"


def accepts_sampler(name: str) -> bool:
    return name == "process"


def init_schema(conn) -> None:
    conn.execute(
        f"""CREATE TABLE IF NOT EXISTS {TABLE} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            {IDENTITY_SCHEMA},
            timestamp REAL,
            cpu_pct REAL,
            rss_bytes INTEGER,
            vms_bytes INTEGER,
            num_threads INTEGER
        )"""
    )
    conn.execute(
        f"""CREATE TABLE IF NOT EXISTS {TABLE_DEVICE} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            {IDENTITY_SCHEMA},
            timestamp REAL,
            device_id INTEGER,
            device_kind TEXT,
            memory_used_bytes INTEGER,
            memory_peak_bytes INTEGER,
            memory_total_bytes INTEGER
        )"""
    )
    conn.execute(
        f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_rank "
        f"ON {TABLE} (session_id, global_rank, timestamp)"
    )
    conn.execute(
        f"CREATE INDEX IF NOT EXISTS idx_{TABLE_DEVICE}_rank "
        f"ON {TABLE_DEVICE} (session_id, global_rank, device_id, timestamp)"
    )


def insert_sql(table: str) -> str:
    if table == TABLE:
        return (
            f"INSERT INTO {TABLE} (session_id, global_rank, local_rank,"
            " world_size, local_world_size, node_rank, hostname, pid, timestamp,"
            " cpu_pct, rss_bytes, vms_bytes, num_threads)"
            " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)"
        )
    return (
        f"INSERT INTO {TABLE_DEVICE} (session_id, global_rank, local_rank,"
        " world_size, local_world_size, node_rank, hostname, pid, timestamp,"
        " device_id, device_kind, memory_used_bytes, memory_peak_bytes,"
        " memory_total_bytes) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)"
    )


def build_rows(env: TelemetryEnvelope) -> Dict[str, List[Tuple]]:
    ident = identity_tuple(env)
    out: Dict[str, List[Tuple]] = {}
    v = env.column_view("process")
    if v:
        ts = v.floats("timestamp")
        cpu = v.floats("cpu_pct")
        rss = v.ints("rss_bytes")
        vms = v.ints("vms_bytes")
        threads = v.ints("num_threads")
        out[TABLE] = [
            ident + (ts[i], cpu[i], rss[i], vms[i], threads[i])
            for i in range(len(v))
        ]
    v = env.column_view("process_device")
    if v:
        ts = v.floats("timestamp")
        dev_id = v.ints("device_id")
        kind = v.strs("device_kind", "unknown")
        used = v.ints("memory_used_bytes")
        peak = v.ints("memory_peak_bytes")
        total = v.ints("memory_total_bytes")
        out[TABLE_DEVICE] = [
            ident + (ts[i], dev_id[i], kind[i], used[i], peak[i], total[i])
            for i in range(len(v))
        ]
    return out
