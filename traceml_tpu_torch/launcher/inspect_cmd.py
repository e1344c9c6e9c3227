"""``python -m traceml_tpu_torch inspect``: decode the per-rank disk backups.

Counterpart of ``traceml_tpu/launcher/inspect_cmd.py``.  Both backup
frame formats (``database/database_writer.py``): a per-row file prints
one JSON object per row; an envelope file (v2, ``envelopes.msgpack``)
carries several tables per frame, so each row is printed with a
``table`` field naming its table.  ``--limit`` caps the rows printed per
file.

``--domain <table>`` keeps the rows of one table (``step_time``,
``system``, ``collectives``, ...).  Collectives rows get a derived
``overlap_efficiency`` column (``1 − exposed_ms/duration_ms``, 1.0 for a
zero-duration row), as in JAX, so overlap is readable straight off the
backups.

``--domain topology`` reads the captured mesh out of the session's
``telemetry.sqlite`` (the one-shot ``mesh_topology`` rows) and prints the
axis names and sizes, each axis's interconnect kind and the rank → host
→ coordinates table.

``--domain rollup`` reads the stitched full-run series of the session's
rollup tiers (``reporting/tiers.py``): per source and metric, the
ranks, buckets, span and resolutions, then the tail of each rank's
step-time series.

``--domain serving`` reads a table the port does not write yet (the
serving probe, ROADMAP queue 1 item 6): it prints what the JAX command
prints for a session without it.
"""

from __future__ import annotations

import json
import sqlite3
from pathlib import Path
from typing import Any, Dict, Optional

from traceml_tpu_torch.database.database_writer import iter_backup_tables
from traceml_tpu_torch.reporting import tiers


def _enrich_row(table: Optional[str], row: Dict[str, Any]) -> Dict[str, Any]:
    """Derived columns per domain.  Collectives: overlap efficiency."""
    if table == "collectives" or (table is None and "exposed_ms" in row):
        try:
            dur = float(row.get("duration_ms", 0.0) or 0.0)
            exp = float(row.get("exposed_ms", 0.0) or 0.0)
            row = dict(row)
            row["overlap_efficiency"] = round(1.0 - exp / dur, 4) if dur > 0 else 1.0
        except Exception:
            pass
    return row


def _find_session_db(path: Path) -> Optional[Path]:
    """telemetry.sqlite at or under ``path``: the path itself, a session
    dir holding one, or the first one found below (a logs dir)."""
    if path.is_file() and path.suffix == ".sqlite":
        return path
    if path.is_dir():
        direct = path / "telemetry.sqlite"
        if direct.exists():
            return direct
        hits = sorted(path.rglob("telemetry.sqlite"))
        if hits:
            return hits[0]
    return None


def _inspect_topology(path: Path) -> int:
    from traceml_tpu_torch.reporting.loaders import load_mesh_topology

    db = _find_session_db(path)
    if db is None:
        print(f"no telemetry.sqlite at or under {path}")
        return 1
    try:
        topo = load_mesh_topology(db)
    except Exception as exc:
        print(f"failed to read mesh topology from {db}: {exc}")
        return 1
    if topo is None:
        print(
            f"no mesh topology captured in {db}\n"
            "(pre-topology session, or the run never built a mesh — "
            "set TRACEML_MESH or call parallel.mesh.make_mesh)"
        )
        return 1
    print(f"── mesh topology ({db})")
    print(f"source: {topo.source}")
    axes = "  ·  ".join(f"{a.name}×{a.size} [{a.kind}]" for a in topo.axes)
    print(f"axes:   {axes}")
    hosts = sorted(set(topo.rank_hosts.values()))
    if hosts:
        print(f"hosts:  {len(hosts)}")
    print(f"ranks:  {len(topo.rank_coords)}")
    coord_hdr = ",".join(a.name for a in topo.axes)
    print(f"{'rank':>6}  {'host':>6}  hostname{'':<12} ({coord_hdr})")
    for rank in sorted(topo.rank_coords):
        host = topo.rank_hosts.get(rank)
        name = topo.rank_hostnames.get(rank, "")
        coords = ",".join(str(c) for c in topo.rank_coords[rank])
        print(f"{rank:>6}  {'' if host is None else host:>6}  {name:<20} ({coords})")
    return 0


def _inspect_serving(path: Path) -> int:
    db = _find_session_db(path)
    if db is None:
        print(f"no telemetry.sqlite at or under {path}")
        return 1
    print(
        f"no serving telemetry in {db}\n"
        "(training-only session, or the run set TRACEML_SERVING=0)"
    )
    return 1


def _inspect_rollup(path: Path, limit: int = 20) -> int:
    """The stitched full-run series: per source and metric the coverage
    and resolutions, then the last ``limit`` buckets of each rank's
    step-time series."""
    db = _find_session_db(path)
    if db is None:
        print(f"no telemetry.sqlite at or under {path}")
        return 1
    conn = sqlite3.connect(f"file:{db}?mode=ro", uri=True)
    conn.row_factory = sqlite3.Row
    try:
        if not tiers.has_rollups(conn):
            print(f"no rollup tiers in {db}\n(run too short for a watermark prune, or TRACEML_ROLLUP=0)")
            return 1
        print(f"── rollup tiers ({db})")
        for source in tiers.ROLLUP_SOURCES:
            for metric in tiers.SOURCE_METRICS.get(source, ()):
                series = tiers.load_stitched_series(conn, source, metric)
                if not series:
                    continue
                n_pts = sum(len(p) for p in series.values())
                t_lo = min(p[0]["t"] for p in series.values())
                t_hi = max(p[-1]["t"] for p in series.values())
                res = sorted({pt["res"] for p in series.values() for pt in p})
                print(
                    f"{source.replace('_samples', ''):>12}.{metric:<18} "
                    f"{len(series)} rank(s)  {n_pts} buckets  "
                    f"{(t_hi - t_lo) / 60.0:8.1f} min span  "
                    f"res {'/'.join(res)}"
                )
        series = tiers.load_stitched_series(conn, "step_time_samples", "step_ms")
    finally:
        conn.close()
    if series:
        print(f"\nstep_ms tail (last {limit} buckets per rank):")
        print(f"{'rank':>6}  {'bucket':>12}  {'res':>4}  {'n':>5}  {'mean':>10}  {'min':>10}  {'max':>10}  steps")
        for rank in sorted(series, key=lambda r: int(r) if r.isdigit() else 0):
            for p in series[rank][-limit:]:
                steps = f"{p['step_min']}–{p['step_max']}" if p.get("step_min") is not None else "n/a"
                print(
                    f"{rank:>6}  {p['t']:>12.1f}  {p['res']:>4}  "
                    f"{p['n']:>5}  {p['mean']:>8.2f}ms  "
                    f"{p['min']:>8.2f}ms  {p['max']:>8.2f}ms  {steps}"
                )
    return 0


def run_inspect(path: Path, limit: int = 20, domain: Optional[str] = None) -> int:
    path = Path(path)
    if domain == "topology":
        return _inspect_topology(path)
    if domain == "serving":
        return _inspect_serving(path)
    if domain == "rollup":
        return _inspect_rollup(path, limit=limit)
    files = []
    if path.is_file():
        files = [path]
    elif path.is_dir():
        files = sorted(path.rglob("*.msgpack"))
    if not files:
        print(f"no .msgpack backups under {path}")
        return 1
    matched = 0
    for f in files:
        printed_header = False
        n = 0
        for table, row in iter_backup_tables(f):
            # a per-row file names its table by its file name
            effective = table if table is not None else f.stem
            if domain is not None and effective != domain:
                continue
            if not printed_header:
                print(f"── {f}")
                printed_header = True
            row = _enrich_row(effective, row)
            if table is None:
                print(json.dumps(row, default=str))
            else:
                print(json.dumps({"table": table, **row}, default=str))
            matched += 1
            n += 1
            if n >= limit:
                print(f"… (showing first {limit})")
                break
        if domain is None and not printed_header:
            print(f"── {f}")
    if domain is not None and matched == 0:
        print(f"no rows for domain {domain!r} under {path}")
        return 1
    return 0
