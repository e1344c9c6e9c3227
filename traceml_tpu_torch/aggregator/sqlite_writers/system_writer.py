"""system projection → ``system_samples`` + ``system_device_samples``.

Counterpart of ``traceml_tpu/aggregator/sqlite_writers/system_writer.py`` (copied: same
tables, columns and indexes).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from traceml_tpu_torch.aggregator.sqlite_writers.common import (
    IDENTITY_SCHEMA,
    identity_tuple,
)
from traceml_tpu_torch.telemetry.envelope import TelemetryEnvelope

TABLE_HOST = "system_samples"
TABLE_DEVICE = "system_device_samples"
# tables the writer's watermark retention prunes per (session, rank)
RETENTION_TABLES = (TABLE_HOST, TABLE_DEVICE)


def accepts_sampler(name: str) -> bool:
    return name == "system"


def init_schema(conn) -> None:
    conn.execute(
        f"""CREATE TABLE IF NOT EXISTS {TABLE_HOST} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            {IDENTITY_SCHEMA},
            timestamp REAL,
            cpu_pct REAL,
            memory_used_bytes INTEGER,
            memory_total_bytes INTEGER,
            memory_pct REAL,
            load_1m REAL,
            load_5m REAL,
            load_15m REAL
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
            memory_total_bytes INTEGER,
            utilization_pct REAL,
            temperature_c REAL,
            power_w REAL
        )"""
    )
    conn.execute(
        f"CREATE INDEX IF NOT EXISTS idx_{TABLE_HOST}_rank "
        f"ON {TABLE_HOST} (session_id, node_rank, timestamp)"
    )
    conn.execute(
        f"CREATE INDEX IF NOT EXISTS idx_{TABLE_DEVICE}_rank "
        f"ON {TABLE_DEVICE} (session_id, node_rank, device_id, timestamp)"
    )


def insert_sql(table: str) -> str:
    if table == TABLE_HOST:
        return (
            f"INSERT INTO {TABLE_HOST} (session_id, global_rank, local_rank,"
            " world_size, local_world_size, node_rank, hostname, pid, timestamp,"
            " cpu_pct, memory_used_bytes, memory_total_bytes, memory_pct,"
            " load_1m, load_5m, load_15m) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)"
        )
    return (
        f"INSERT INTO {TABLE_DEVICE} (session_id, global_rank, local_rank,"
        " world_size, local_world_size, node_rank, hostname, pid, timestamp,"
        " device_id, device_kind, memory_used_bytes, memory_peak_bytes,"
        " memory_total_bytes, utilization_pct, temperature_c, power_w)"
        " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)"
    )


def build_rows(env: TelemetryEnvelope) -> Dict[str, List[Tuple]]:
    ident = identity_tuple(env)
    out: Dict[str, List[Tuple]] = {}
    v = env.column_view("system")
    if v:
        ts = v.floats("timestamp")
        cpu = v.floats("cpu_pct")
        used = v.ints("memory_used_bytes")
        total = v.ints("memory_total_bytes")
        pct = v.floats("memory_pct")
        l1 = v.floats("load_1m")
        l5 = v.floats("load_5m")
        l15 = v.floats("load_15m")
        out[TABLE_HOST] = [
            ident + (ts[i], cpu[i], used[i], total[i], pct[i], l1[i], l5[i], l15[i])
            for i in range(len(v))
        ]
    v = env.column_view("system_device")
    if v:
        ts = v.floats("timestamp")
        dev_id = v.ints("device_id")
        kind = v.strs("device_kind", "unknown")
        used = v.ints("memory_used_bytes")
        peak = v.ints("memory_peak_bytes")
        total = v.ints("memory_total_bytes")
        util = v.floats("utilization_pct")
        temp = v.floats("temperature_c")
        power = v.floats("power_w")
        out[TABLE_DEVICE] = [
            ident
            + (
                ts[i],
                dev_id[i],
                kind[i],
                used[i],
                peak[i],
                total[i],
                util[i],
                temp[i],
                power[i],
            )
            for i in range(len(v))
        ]
    return out
