"""SQLite read paths of the final report.

Counterpart of ``traceml_tpu/reporting/loaders.py``, trimmed to the
tables the port writes, the aggregator's ``rank_status.json`` and
``ingest_stats.json``, and the cross-run ``regressions.json``.
One-shot readers, one query per table; the
step-time and step-memory reads are bounded per rank with a
``ROW_NUMBER() OVER (PARTITION BY global_rank ...)`` window, the system
and process reads by their newest rows.  Every loader accepts an optional ``conn`` to reuse a
read connection.
"""

from __future__ import annotations

import json
import sqlite3
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


def _connect_ro(db_path: Path) -> sqlite3.Connection:
    conn = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    conn.row_factory = sqlite3.Row
    return conn


@contextmanager
def _reading(db_path: Path, conn: Optional[sqlite3.Connection] = None):
    """Yield a usable read connection: the caller-provided shared one
    (left open) or a fresh one (closed on exit — the seed's
    ``with sqlite3.connect(...)`` only committed, it never closed)."""
    if conn is not None:
        yield conn
        return
    fresh = _connect_ro(db_path)
    try:
        yield fresh
    finally:
        fresh.close()


def _table_exists(conn: sqlite3.Connection, table: str) -> bool:
    row = conn.execute(
        "SELECT name FROM sqlite_master WHERE type='table' AND name=?", (table,)
    ).fetchone()
    return row is not None


def load_step_time_rows(
    db_path: Path,
    max_steps_per_rank: int = 600,
    conn: Optional[sqlite3.Connection] = None,
) -> Dict[int, List[Dict[str, Any]]]:
    """global_rank → step rows (events decoded), ascending by step."""
    out: Dict[int, List[Dict[str, Any]]] = {}
    with _reading(db_path, conn) as c:
        if not _table_exists(c, "step_time_samples"):
            return out
        rows = c.execute(
            "SELECT global_rank, step, timestamp, clock, late_markers,"
            " events_json FROM ("
            "  SELECT global_rank, step, timestamp, clock, late_markers,"
            "   events_json, ROW_NUMBER() OVER ("
            "    PARTITION BY global_rank ORDER BY step DESC, id DESC"
            "   ) AS rn FROM step_time_samples"
            " ) WHERE rn <= ? ORDER BY global_rank, step, rn DESC",
            (int(max_steps_per_rank),),
        ).fetchall()
    for r in rows:
        try:
            events = json.loads(r["events_json"] or "{}")
        except ValueError:
            events = {}
        out.setdefault(int(r["global_rank"]), []).append(
            {
                "step": r["step"],
                "timestamp": r["timestamp"],
                "clock": r["clock"],
                "late_markers": r["late_markers"],
                "events": events,
            }
        )
    return out



def load_model_stats(
    db_path: Path,
    recent_rows: int = 64,
    conn: Optional[sqlite3.Connection] = None,
) -> Dict[int, Dict[str, Any]]:
    """global_rank → FLOPs declaration (the MFU numerator and the device
    peak taken when it was declared).  ``flops_per_step`` and
    ``tokens_per_step`` are the medians over the rank's recent
    declarations (per-step declarations vary with the batch); source,
    device kind, peak and device count come from the newest row."""
    import statistics

    out: Dict[int, Dict[str, Any]] = {}
    per_rank_flops: Dict[int, List[float]] = {}
    per_rank_tokens: Dict[int, List[float]] = {}
    with _reading(db_path, conn) as c:
        if not _table_exists(c, "model_stats_samples"):
            return out
        rows = c.execute(
            "SELECT * FROM (SELECT global_rank, flops_per_step,"
            " flops_source, device_kind, peak_flops, device_count,"
            " tokens_per_step, id"
            " FROM model_stats_samples"
            f" ORDER BY id DESC LIMIT {int(recent_rows)}) ORDER BY id ASC"
        ).fetchall()
    for r in rows:
        rank = int(r["global_rank"])
        if r["flops_per_step"]:
            per_rank_flops.setdefault(rank, []).append(float(r["flops_per_step"]))
        if r["tokens_per_step"]:
            per_rank_tokens.setdefault(rank, []).append(float(r["tokens_per_step"]))
        out[rank] = {  # ascending order → the newest row wins
            "flops_source": r["flops_source"],
            "device_kind": r["device_kind"],
            "peak_flops": r["peak_flops"],
            "device_count": r["device_count"],
        }
    for rank, vals in per_rank_flops.items():
        out[rank]["flops_per_step"] = statistics.median(vals)
    for rank, vals in per_rank_tokens.items():
        out[rank]["tokens_per_step"] = statistics.median(vals)
    return {
        r: v for r, v in out.items()
        if v.get("flops_per_step") or v.get("tokens_per_step")
    }

def load_step_memory_rows(
    db_path: Path,
    max_rows_per_rank: int = 20000,
    conn: Optional[sqlite3.Connection] = None,
) -> Dict[int, List[Dict[str, Any]]]:
    out: Dict[int, List[Dict[str, Any]]] = {}
    with _reading(db_path, conn) as c:
        if not _table_exists(c, "step_memory_samples"):
            return out
        rows = c.execute(
            "SELECT global_rank, step, timestamp, device_id, device_kind,"
            " current_bytes, peak_bytes, step_peak_bytes, limit_bytes FROM ("
            "  SELECT global_rank, step, timestamp, device_id, device_kind,"
            "   current_bytes, peak_bytes, step_peak_bytes, limit_bytes,"
            "   ROW_NUMBER() OVER ("
            "    PARTITION BY global_rank ORDER BY step DESC, id DESC"
            "   ) AS rn FROM step_memory_samples"
            " ) WHERE rn <= ? ORDER BY global_rank, step, rn DESC",
            (int(max_rows_per_rank),),
        ).fetchall()
    for r in rows:
        rank = int(r["global_rank"])
        row = dict(r)
        del row["global_rank"]
        out.setdefault(rank, []).append(row)
    return out


def load_system_rows(
    db_path: Path,
    max_rows: int = 2000,
    conn: Optional[sqlite3.Connection] = None,
) -> Tuple[Dict[int, List[Dict[str, Any]]], Dict[tuple, List[Dict[str, Any]]]]:
    """The newest ``max_rows`` system rows: node_rank → host rows and
    (node_rank, device_id) → GPU rows, oldest first."""
    host: Dict[int, List[Dict[str, Any]]] = {}
    devices: Dict[tuple, List[Dict[str, Any]]] = {}
    with _reading(db_path, conn) as c:
        if _table_exists(c, "system_samples"):
            for r in c.execute(
                "SELECT * FROM (SELECT * FROM system_samples ORDER BY id DESC"
                f" LIMIT {int(max_rows)}) ORDER BY id ASC"
            ):
                host.setdefault(int(r["node_rank"]), []).append(dict(r))
        if _table_exists(c, "system_device_samples"):
            for r in c.execute(
                "SELECT * FROM (SELECT * FROM system_device_samples ORDER BY id"
                f" DESC LIMIT {int(max_rows)}) ORDER BY id ASC"
            ):
                devices.setdefault(
                    (int(r["node_rank"]), int(r["device_id"] or 0)), []
                ).append(dict(r))
    return host, devices


def load_process_rows(
    db_path: Path,
    max_rows: int = 2000,
    conn: Optional[sqlite3.Connection] = None,
) -> Tuple[Dict[int, List[Dict[str, Any]]], Dict[tuple, List[Dict[str, Any]]]]:
    """The newest ``max_rows`` process rows: global_rank → process rows
    and (global_rank, device_id) → GPU rows, oldest first."""
    procs: Dict[int, List[Dict[str, Any]]] = {}
    devices: Dict[tuple, List[Dict[str, Any]]] = {}
    with _reading(db_path, conn) as c:
        if _table_exists(c, "process_samples"):
            for r in c.execute(
                "SELECT * FROM (SELECT * FROM process_samples ORDER BY id DESC"
                f" LIMIT {int(max_rows)}) ORDER BY id ASC"
            ):
                procs.setdefault(int(r["global_rank"]), []).append(dict(r))
        if _table_exists(c, "process_device_samples"):
            for r in c.execute(
                "SELECT * FROM (SELECT * FROM process_device_samples ORDER BY"
                f" id DESC LIMIT {int(max_rows)}) ORDER BY id ASC"
            ):
                devices.setdefault(
                    (int(r["global_rank"]), int(r["device_id"] or 0)), []
                ).append(dict(r))
    return procs, devices


def load_topology(db_path: Path, conn: Optional[sqlite3.Connection] = None) -> Dict[str, Any]:
    """Run topology from the identity columns of the first table present
    of step_time, process and system samples."""
    with _reading(db_path, conn) as c:
        tables = [t for t in ("step_time_samples", "process_samples", "system_samples")
                  if _table_exists(c, t)]
        if not tables:
            return {"mode": "unknown", "world_size": 0, "nodes": 0}
        rows = c.execute(
            f"SELECT DISTINCT global_rank, node_rank, hostname, world_size FROM {tables[0]}"
        ).fetchall()
    ranks = sorted({int(r["global_rank"]) for r in rows})
    nodes = sorted({int(r["node_rank"]) for r in rows})
    world = max((int(r["world_size"]) for r in rows), default=len(ranks))
    return {
        "mode": "multi_node" if len(nodes) > 1 else "single_node",
        "world_size": max(world, len(ranks)),
        "ranks_seen": ranks,
        "nodes": len(nodes),
        "hostnames": sorted({str(r["hostname"]) for r in rows}),
    }


def load_rank_identities(
    db_path: Path, conn: Optional[sqlite3.Connection] = None
) -> Dict[int, Dict[str, Any]]:
    """global_rank → identity block.  Pulled from
    whichever projection tables exist; across tables the row with the
    newest telemetry timestamp wins, so a rank that moved hosts
    (restart/resume) reports its current placement even if its newest
    rows live in a different sampler's table."""
    identity: Dict[int, Dict[str, Any]] = {}
    newest: Dict[int, float] = {}
    with _reading(db_path, conn) as c:
        for table in ("step_time_samples", "process_samples", "step_memory_samples"):
            if not _table_exists(c, table):
                continue
            # SQLite bare-column semantics: with MAX(id) the other
            # selected columns come from that same max-id row
            rows = c.execute(
                f"SELECT global_rank, local_rank, node_rank, hostname, pid,"
                f" world_size, local_world_size, timestamp, MAX(id)"
                f" FROM {table} GROUP BY global_rank"
            ).fetchall()
            for r in rows:
                rank = int(r["global_rank"])
                ts = float(r["timestamp"] or 0.0)
                if rank in identity and ts <= newest[rank]:
                    continue
                newest[rank] = ts
                identity[rank] = {
                    "global_rank": rank,
                    "local_rank": r["local_rank"],
                    "node_rank": r["node_rank"],
                    "hostname": r["hostname"],
                    "pid": r["pid"],
                    "world_size": r["world_size"],
                    "local_world_size": r["local_world_size"],
                }
    return identity


def _load_cached_json(path: Path, cache: Dict[str, Tuple[Tuple[float, int], Dict[str, Any]]]) -> Dict[str, Any]:
    """``path``'s JSON object, re-read only when its (mtime, size)
    changed; ``{}`` when the file is missing or unreadable."""
    from traceml_tpu_torch.utils.atomic_io import read_json

    try:
        st = path.stat()
    except OSError:
        return {}
    stamp = (st.st_mtime, st.st_size)
    cached = cache.get(str(path))
    if cached is not None and cached[0] == stamp:
        return cached[1]
    data = read_json(path)
    if not isinstance(data, dict):
        return {}
    cache[str(path)] = (stamp, data)
    return data


# rank_status.json and ingest_stats.json are rewritten atomically every
# few seconds by the aggregator loop; as in the JAX loaders, each is
# cached on (mtime, size) so a live poller does not parse an unchanged
# file on every tick.
_RANK_STATUS_CACHE: Dict[str, Tuple[Tuple[float, int], Dict[str, Any]]] = {}
_INGEST_STATS_CACHE: Dict[str, Tuple[Tuple[float, int], Dict[str, Any]]] = {}


def load_rank_status(session_dir: Path) -> Dict[str, Any]:
    """The rank liveness snapshot (per rank: active, stale, lost or
    finished, last seen, last progress; the thresholds) from
    ``rank_status.json``, states as the aggregator wrote them; ``{}`` when
    the file is missing or unreadable."""
    return _load_cached_json(Path(session_dir) / "rank_status.json", _RANK_STATUS_CACHE)


def load_ingest_stats(session_dir: Path) -> Dict[str, Any]:
    """The aggregator's self-metrics (queue depths and high-water marks,
    per-domain drops, group commit) from ``ingest_stats.json``; ``{}``
    when the file is missing or unreadable."""
    return _load_cached_json(Path(session_dir) / "ingest_stats.json", _INGEST_STATS_CACHE)


# regressions.json is written once at finalize (analytics/baselines.py)
# but polled live by the dashboard's meta fragment; the same (mtime,
# size) cache as the other file-backed meta inputs.
_REGRESSIONS_CACHE: Dict[str, Tuple[Tuple[float, int], Dict[str, Any]]] = {}


def load_regressions(session_dir: Path) -> Dict[str, Any]:
    """The cross-run regression verdict (``regressions.json``: status,
    fingerprint, per-metric checks against the baseline bands, issues)
    as written at finalize; ``{}`` when the file is missing or
    unreadable."""
    return _load_cached_json(Path(session_dir) / "regressions.json", _REGRESSIONS_CACHE)
