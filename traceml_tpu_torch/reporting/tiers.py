"""Resolution-aware stitched reads over the raw rows and the rollup tiers.

Counterpart of ``traceml_tpu/reporting/tiers.py`` (copied).  The
watermark prune folds every doomed row into ``rollup_samples_10s`` and
``rollup_samples_1m`` before deleting it (``aggregator/rollup.py``), so
a session database holds the whole run as the surviving raw rows (the
live window), 10 s buckets (folded history inside the 10 s horizon) and
1 m buckets (older history).  This module stitches the three into one
full-run series at bounded cost:

* every 10 s bucket holds only deleted rows, and the surviving raw tail
  folds on the fly through the same :func:`fold_buckets` the writer
  uses, so merging the two by bucket is exact at 10 s (disjoint row
  sets, the same fold);
* 1 m buckets are used only where the 10 s tier has decayed
  (``bucket + 60 <= the oldest 10 s coverage``), marked ``res="1m"``.

The tiers are bounded by the writer's decay, the raw rows by retention.
The final report's ``history`` block, the dashboard's history strip and
``inspect --domain rollup`` all read through here; the connection must
have ``row_factory = sqlite3.Row``.
"""

from __future__ import annotations

import sqlite3
from typing import Any, Dict, List, Optional, Tuple

from traceml_tpu_torch.aggregator.rollup import (
    _SOURCE_COLS,
    ROLLUP_SOURCES,
    extract_metrics,
    fold_buckets,
)

#: metrics served per source table (mirrors the writer's fold)
SOURCE_METRICS: Dict[str, Tuple[str, ...]] = {
    "step_time_samples": ("step_ms",),
    "step_memory_samples": ("current_bytes", "step_peak_bytes"),
    "collectives_samples": ("duration_ms", "exposed_ms", "bytes"),
    "serving_samples": ("tokens_per_s", "requests_completed", "queue_depth"),
}

_TIER_10S = "rollup_samples_10s"
_TIER_1M = "rollup_samples_1m"


def _has_table(conn: sqlite3.Connection, table: str) -> bool:
    try:
        return (
            conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table' AND name=?",
                (table,),
            ).fetchone()
            is not None
        )
    except sqlite3.Error:
        return False


def has_rollups(conn: sqlite3.Connection) -> bool:
    """True when the DB carries any folded history (omit-when-empty
    gates in the web payload and final report key off this)."""
    if not _has_table(conn, _TIER_10S):
        return False
    try:
        return conn.execute(
            f"SELECT 1 FROM {_TIER_10S} LIMIT 1"
        ).fetchone() is not None
    except sqlite3.Error:
        return False


def _tier_rows(
    conn: sqlite3.Connection,
    tier: str,
    source_table: str,
    metric: str,
    grain: str,
) -> Dict[str, List[sqlite3.Row]]:
    """Per grain_key, the tier's buckets in ascending bucket order."""
    if not _has_table(conn, tier):
        return {}
    out: Dict[str, List[sqlite3.Row]] = {}
    try:
        rows = conn.execute(
            f"SELECT grain_key, bucket_ts, count, sum, min, max, sumsq,"
            f" step_min, step_max FROM {tier}"
            " WHERE source_table=? AND metric=? AND grain=?"
            " ORDER BY grain_key, bucket_ts",
            (source_table, metric, grain),
        ).fetchall()
    except sqlite3.Error:
        return {}
    for r in rows:
        out.setdefault(str(r["grain_key"]), []).append(r)
    return out


def _raw_folded(
    conn: sqlite3.Connection,
    source_table: str,
    metric: str,
    width_s: float = 10.0,
) -> Dict[str, List[Tuple]]:
    """Fold the SURVIVING raw rows to ``width_s`` buckets per rank —
    the same extract + fold the writer applies to doomed rows, so the
    merge with tier buckets is exact."""
    cols = _SOURCE_COLS.get(source_table)
    if cols is None or not _has_table(conn, source_table):
        return {}
    try:
        rows = conn.execute(
            f"SELECT global_rank, {', '.join(cols)} FROM {source_table}"
            " ORDER BY id"
        ).fetchall()
    except sqlite3.Error:
        return {}
    by_rank: Dict[int, List[Tuple]] = {}
    for r in rows:
        by_rank.setdefault(int(r[0]), []).append(tuple(r)[1:])
    out: Dict[str, List[Tuple]] = {}
    for rank, tuples in by_rank.items():
        metrics = extract_metrics(source_table, tuples)
        series = metrics.get(metric)
        if not series:
            continue
        tss, steps, vals = series
        folded = fold_buckets(tss, steps, vals, width_s)
        if folded:
            out[str(rank)] = folded
    return out


def _merge_bucket(
    a: Optional[Dict[str, Any]], bucket: Tuple, res: str
) -> Dict[str, Any]:
    """Merge one folded/tier bucket into a stitched point (disjoint row
    sets: counts and sums add, min/min, max/max)."""
    (t, count, total, mn, mx, _sumsq, step_min, step_max) = bucket
    if a is None:
        return {
            "t": float(t),
            "n": int(count),
            "sum": float(total),
            "min": float(mn),
            "max": float(mx),
            "step_min": step_min,
            "step_max": step_max,
            "res": res,
        }
    a["n"] += int(count)
    a["sum"] += float(total)
    a["min"] = min(a["min"], float(mn))
    a["max"] = max(a["max"], float(mx))
    if step_min is not None:
        a["step_min"] = (
            step_min if a["step_min"] is None else min(a["step_min"], step_min)
        )
    if step_max is not None:
        a["step_max"] = (
            step_max if a["step_max"] is None else max(a["step_max"], step_max)
        )
    if a["res"] != res:
        a["res"] = "10s"  # tier + raw contributions merged at 10s
    return a


def load_stitched_series(
    conn: sqlite3.Connection,
    source_table: str,
    metric: str,
    grain: str = "rank",
) -> Dict[str, List[Dict[str, Any]]]:
    """Full-run series per grain key: raw where it survives (folded to
    10s buckets), 10s tier beyond the watermark, 1m tier beyond the 10s
    horizon.  Points carry ``t/n/sum/min/max/mean/res`` ascending in
    time.  For non-``rank`` grains the raw tail is not re-grouped (the
    store's live window already serves it); tiers alone answer."""
    tier10 = _tier_rows(conn, _TIER_10S, source_table, metric, grain)
    tier1m = _tier_rows(conn, _TIER_1M, source_table, metric, grain)
    raw10 = _raw_folded(conn, source_table, metric) if grain == "rank" else {}

    out: Dict[str, List[Dict[str, Any]]] = {}
    for key in sorted(set(tier10) | set(tier1m) | set(raw10)):
        merged: Dict[float, Dict[str, Any]] = {}
        for r in tier10.get(key, ()):
            b = (r["bucket_ts"], r["count"], r["sum"], r["min"], r["max"],
                 r["sumsq"], r["step_min"], r["step_max"])
            merged[float(r["bucket_ts"])] = _merge_bucket(
                merged.get(float(r["bucket_ts"])), b, "10s"
            )
        for bucket in raw10.get(key, ()):
            t = float(bucket[0])
            merged[t] = _merge_bucket(merged.get(t), bucket, "raw")
        oldest_10s = min(merged) if merged else None
        points: List[Dict[str, Any]] = []
        for r in tier1m.get(key, ()):
            t = float(r["bucket_ts"])
            # only where the 10s tier has decayed: a 1m bucket fully
            # older than the oldest 10s coverage
            if oldest_10s is not None and t + 60.0 > oldest_10s:
                continue
            b = (t, r["count"], r["sum"], r["min"], r["max"], r["sumsq"],
                 r["step_min"], r["step_max"])
            points.append(_merge_bucket(None, b, "1m"))
        points.extend(merged[t] for t in sorted(merged))
        for p in points:
            p["mean"] = p["sum"] / p["n"] if p["n"] else None
        if points:
            out[key] = points
    return out


def stitched_overview(
    conn: sqlite3.Connection,
    sources: Tuple[str, ...] = ROLLUP_SOURCES,
) -> Dict[str, Any]:
    """Per-source stitched rank-grain series for every served metric —
    the payload shape the final report's ``history`` block and the
    dashboard history strip consume.  Empty dict when the DB has no
    rollups (callers omit the section)."""
    if not has_rollups(conn):
        return {}
    out: Dict[str, Any] = {}
    for source in sources:
        per_metric: Dict[str, Any] = {}
        for metric in SOURCE_METRICS.get(source, ()):
            series = load_stitched_series(conn, source, metric)
            if series:
                per_metric[metric] = series
        if per_metric:
            out[source.replace("_samples", "")] = per_metric
    return out
