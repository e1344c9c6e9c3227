"""Multi-resolution rollup tiers under the watermark retention prune.

Counterpart of ``traceml_tpu/aggregator/rollup.py``.  The SQLite writer
keeps ``int(1.5 x summary_window_rows)`` raw rows per table and rank; a
prune folds the doomed id range into ``rollup_samples_10s`` and
``rollup_samples_1m`` INSIDE the same transaction as the range DELETE
(``SQLiteWriter._prune_partition``), so no reader, and no restarted
aggregator, ever sees rows that are neither raw nor rolled up.

A tier row is one aggregate per (session, source table, grain, grain
key, metric, time bucket): ``count / sum / min / max / sumsq`` and the
covered step range.  Grains: ``rank`` (one series per global rank, the
read path's stitch grain) and ``host`` (per hostname, merged across
ranks by the UPSERT).  The JAX engine also folds ``axis:<name>`` and
``dcn_side:<name>`` grains from a session's ``mesh_topology`` capture;
the port does not fold them yet (ROADMAP queue 1 item 5(b)), so its tier
rows equal the JAX ones for a session without a mesh, and lack those
grains for one with a mesh.

Every prune folds into both tiers, so the 10 s tier decays by plain
deletion past its horizon (6 h by default) and the 1 m tier's horizon
(14 days) is the only history bound.  The fold is vectorized (numpy)
with a scalar twin, :func:`fold_buckets_reference`, that replays the
same IEEE operations; the tests hold the live fold to it bit for bit.  ``TRACEML_ROLLUP=0``
turns the tiers off (a prune then discards history);
``TRACEML_ROLLUP_TIERS`` sets the tiers (``width[:horizon],...``
seconds).
"""

from __future__ import annotations

import json
import math
import os
import sqlite3
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from traceml_tpu_torch.utils import timing as T
from traceml_tpu_torch.utils.error_log import get_error_log

ENV_ROLLUP = "TRACEML_ROLLUP"
ENV_ROLLUP_TIERS = "TRACEML_ROLLUP_TIERS"

#: raw tables that decay into tiers when the watermark prune fires
ROLLUP_SOURCES = (
    "step_time_samples",
    "step_memory_samples",
    "collectives_samples",
    "serving_samples",
)

#: default tiers: (width seconds, horizon seconds kept at that width).
#: 10s buckets cover the last 6 hours beyond the raw window; 1m buckets
#: cover 14 days — a week-long run never loses its series.
DEFAULT_TIERS: Tuple[Tuple[float, float], ...] = (
    (10.0, 6 * 3600.0),
    (60.0, 14 * 24 * 3600.0),
)

#: columns SELECTed from each source for the fold (timestamp/step first)
_SOURCE_COLS: Dict[str, Tuple[str, ...]] = {
    "step_time_samples": ("timestamp", "step", "clock", "events_json"),
    "step_memory_samples": (
        "timestamp", "step", "current_bytes", "step_peak_bytes"),
    "collectives_samples": (
        "timestamp", "step", "duration_ms", "exposed_ms", "bytes"),
    "serving_samples": (
        "timestamp", "step", "tokens_per_s", "requests_completed",
        "queue_depth"),
}


def tier_label(width_s: float) -> str:
    """``10 → "10s"``, ``60 → "1m"`` — names the tier table suffix."""
    w = int(width_s)
    if w >= 60 and w % 60 == 0:
        return f"{w // 60}m"
    return f"{w}s"


def tier_table(width_s: float) -> str:
    return f"rollup_samples_{tier_label(width_s)}"


def parse_tiers(raw: Optional[str]) -> Tuple[Tuple[float, float], ...]:
    """``"10:21600,60:1209600"`` (``width[:horizon]`` seconds) → tier
    tuples; malformed specs fall back to :data:`DEFAULT_TIERS` (env
    flags must never raise into the writer thread)."""
    if not raw:
        return DEFAULT_TIERS
    out: List[Tuple[float, float]] = []
    try:
        for part in str(raw).split(","):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                w_s, h_s = part.split(":", 1)
                width, horizon = float(w_s), float(h_s)
            else:
                width = float(part)
                horizon = next(
                    (h for w, h in DEFAULT_TIERS if w == width),
                    width * 2160.0,
                )
            if width <= 0 or horizon <= 0:
                return DEFAULT_TIERS
            out.append((width, horizon))
    except (TypeError, ValueError):
        return DEFAULT_TIERS
    return tuple(out) or DEFAULT_TIERS


# -- metric extraction ----------------------------------------------------


def extract_metrics(
    table: str, rows: Sequence[Tuple[Any, ...]]
) -> Dict[str, Tuple[List[float], List[Optional[int]], List[float]]]:
    """Per metric: (timestamps, steps, values) with NULL/sentinel rows
    skipped.  Input rows are tuples in :data:`_SOURCE_COLS` order —
    the same column tuples the writer's SELECT hands back."""
    out: Dict[str, Tuple[List[float], List[Optional[int]], List[float]]] = {}

    def _emit(metric: str, ts: Any, step: Any, val: Any) -> None:
        if ts is None or val is None:
            return
        tss, steps, vals = out.setdefault(metric, ([], [], []))
        tss.append(float(ts))
        steps.append(int(step) if step is not None else None)
        vals.append(float(val))

    if table == "step_time_samples":
        for ts, step, clock, events_json in rows:
            try:
                events = json.loads(events_json) if events_json else {}
            except (TypeError, ValueError):
                continue
            env = events.get(T.STEP_TIME) or {}
            val = (
                env.get("device_ms")
                if clock == "device" and env.get("device_ms") is not None
                else env.get("cpu_ms")
            )
            _emit("step_ms", ts, step, val)
    elif table == "step_memory_samples":
        for ts, step, current_bytes, step_peak_bytes in rows:
            _emit("current_bytes", ts, step, current_bytes)
            _emit("step_peak_bytes", ts, step, step_peak_bytes)
    elif table == "collectives_samples":
        for ts, step, duration_ms, exposed_ms, nbytes in rows:
            _emit("duration_ms", ts, step, duration_ms)
            _emit("exposed_ms", ts, step, exposed_ms)
            _emit("bytes", ts, step, nbytes)
    elif table == "serving_samples":
        for ts, step, tokens_per_s, requests_completed, queue_depth in rows:
            _emit("tokens_per_s", ts, step, tokens_per_s)
            _emit("requests_completed", ts, step, requests_completed)
            _emit("queue_depth", ts, step, queue_depth)
    return out


# -- the fold (vectorized + scalar reference twin) ------------------------

#: one folded bucket: (bucket_ts, count, sum, min, max, sumsq,
#: step_min, step_max)
FoldedBucket = Tuple[
    float, int, float, float, float, float, Optional[int], Optional[int]
]


def fold_buckets(
    ts: Sequence[float],
    steps: Sequence[Optional[int]],
    values: Sequence[float],
    width_s: float,
) -> List[FoldedBucket]:
    """Vectorized fold of one metric's samples into ``width_s`` buckets.

    Buckets are emitted in ascending bucket order; within a bucket the
    accumulation order is ARRIVAL order (stable sort).  Sums are
    prefix-sum differences: ``np.cumsum`` is an exact sequential
    left-fold (``np.add.reduceat``/``np.sum`` reduce PAIRWISE and would
    drift in the low bits), so ``cumsum[end] - cumsum[start-1]`` is a
    fixed sequence of IEEE ops the scalar reference replays verbatim.
    ``min``/``max`` are order-free and exact on any path.
    """
    if not len(ts):
        return []
    t = np.asarray(ts, dtype=np.float64)
    v = np.asarray(values, dtype=np.float64)
    buckets = np.floor(t / width_s) * width_s
    order = np.argsort(buckets, kind="stable")
    b = buckets[order]
    vv = v[order]
    edges = np.nonzero(np.r_[True, b[1:] != b[:-1]])[0]
    ends = np.r_[edges[1:], len(b)] - 1
    counts = np.diff(np.r_[edges, len(b)])
    cs = np.cumsum(vv)
    cs2 = np.cumsum(vv * vv)
    sums = cs[ends].copy()
    sums[1:] -= cs[edges[1:] - 1]
    sumsq = cs2[ends].copy()
    sumsq[1:] -= cs2[edges[1:] - 1]
    mins = np.minimum.reduceat(vv, edges)
    maxs = np.maximum.reduceat(vv, edges)
    has_steps = all(s is not None for s in steps)
    if has_steps:
        ss = np.asarray(steps, dtype=np.int64)[order]
        step_mins = np.minimum.reduceat(ss, edges)
        step_maxs = np.maximum.reduceat(ss, edges)
    out: List[FoldedBucket] = []
    for i, e in enumerate(edges):
        out.append(
            (
                float(b[e]),
                int(counts[i]),
                float(sums[i]),
                float(mins[i]),
                float(maxs[i]),
                float(sumsq[i]),
                int(step_mins[i]) if has_steps else None,
                int(step_maxs[i]) if has_steps else None,
            )
        )
    return out


def fold_buckets_reference(
    ts: Sequence[float],
    steps: Sequence[Optional[int]],
    values: Sequence[float],
    width_s: float,
) -> List[FoldedBucket]:
    """Scalar reference twin of :func:`fold_buckets` — pure-Python
    loops replaying the identical IEEE op sequence: same bucket math
    (float64 ``floor(t / w) * w``), same stable sort, same sequential
    prefix accumulation over the sorted array, same prefix-difference
    per bucket.  The golden suite asserts BIT-exact equality on ragged
    arrivals."""
    n = len(ts)
    if not n:
        return []
    has_steps = all(s is not None for s in steps)
    buckets = [math.floor(float(ts[i]) / width_s) * width_s for i in range(n)]
    order = sorted(range(n), key=lambda i: buckets[i])  # stable, like argsort
    out: List[FoldedBucket] = []
    run = 0.0  # sequential left-fold prefixes, exactly np.cumsum
    run_sq = 0.0

    def _close(seg: List[Any]) -> None:
        # first segment takes the raw prefix (the vectorized path's
        # untouched sums[0]); later segments subtract the prefix just
        # before their start — the same single IEEE subtraction
        if out:
            seg[2] = run - seg[8]
            seg[5] = run_sq - seg[9]
        else:
            seg[2] = run
            seg[5] = run_sq
        out.append(tuple(seg[:8]))

    cur: Optional[List[Any]] = None
    for i in order:
        b = buckets[i]
        val = float(values[i])
        st = int(steps[i]) if has_steps else None
        if cur is None or b != cur[0]:
            if cur is not None:
                _close(cur)
            # [bucket, count, sum, min, max, sumsq, step_min, step_max,
            #  prefix-before-start, sq-prefix-before-start]
            cur = [b, 0, 0.0, val, val, 0.0, st, st, run, run_sq]
        run = run + val
        run_sq = run_sq + val * val
        cur[1] += 1
        cur[3] = min(cur[3], val)
        cur[4] = max(cur[4], val)
        if has_steps:
            cur[6] = min(cur[6], st)
            cur[7] = max(cur[7], st)
    if cur is not None:
        _close(cur)
    return out


# -- the engine -----------------------------------------------------------


class RollupEngine:
    """Folds doomed raw rows into tier tables inside the caller's open
    transaction, and decays each tier past its horizon.

    One instance lives inside :class:`SQLiteWriter` (writer thread
    only, no locking); the stitched read path (``reporting/tiers.py``)
    folds the surviving raw rows with the same :func:`fold_buckets`."""

    def __init__(self) -> None:
        self.tiers = parse_tiers(os.environ.get(ENV_ROLLUP_TIERS))
        self.sources = frozenset(ROLLUP_SOURCES)
        # (tier_table, session, source, grain, key) → last decay cutoff
        self._decay_cutoffs: Dict[Tuple[str, str, str, str, str], float] = {}
        # stats (read via SQLiteWriter.stats())
        self.folds = 0
        self.rows_folded = 0
        self.rows_upserted = 0
        self.rows_decayed = 0
        self.fold_ms_total = 0.0
        self.fold_ms_max = 0.0

    # -- schema -----------------------------------------------------------

    def init_schema(self, conn: sqlite3.Connection) -> None:
        for width, _horizon in self.tiers:
            table = tier_table(width)
            conn.execute(
                f"""CREATE TABLE IF NOT EXISTS {table} (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    session_id TEXT NOT NULL,
                    source_table TEXT NOT NULL,
                    grain TEXT NOT NULL,
                    grain_key TEXT NOT NULL,
                    global_rank INTEGER NOT NULL,
                    bucket_ts REAL NOT NULL,
                    metric TEXT NOT NULL,
                    count INTEGER NOT NULL,
                    sum REAL NOT NULL,
                    min REAL NOT NULL,
                    max REAL NOT NULL,
                    sumsq REAL NOT NULL,
                    step_min INTEGER,
                    step_max INTEGER,
                    UNIQUE (session_id, source_table, grain, grain_key,
                            metric, bucket_ts)
                )"""
            )

    def stats(self) -> Dict[str, Any]:
        return {
            "tiers": [
                {"table": tier_table(w), "width_s": w, "horizon_s": h}
                for w, h in self.tiers
            ],
            "folds": self.folds,
            "rows_folded": self.rows_folded,
            "rows_upserted": self.rows_upserted,
            "rows_decayed": self.rows_decayed,
            "fold_ms_total": round(self.fold_ms_total, 3),
            "fold_ms_max": round(self.fold_ms_max, 3),
        }

    # -- the in-transaction fold ------------------------------------------

    def fold_doomed(
        self,
        conn: sqlite3.Connection,
        table: str,
        session_id: str,
        rank: int,
        watermark: int,
    ) -> int:
        """Fold the partition's doomed id-range (``id <= watermark``)
        into every tier, inside the caller's OPEN transaction.  Returns
        the number of raw rows folded.  Any sqlite error propagates to
        the caller's rollback path — fold and delete commit together or
        not at all."""
        cols = _SOURCE_COLS.get(table)
        if cols is None:
            return 0
        t0 = time.perf_counter()
        rows = conn.execute(
            f"SELECT hostname, {', '.join(cols)} FROM {table}"
            " WHERE session_id=? AND global_rank=? AND id <= ?",
            (session_id, rank, watermark),
        ).fetchall()
        if not rows:
            return 0
        hostname = rows[0][0]
        metrics = extract_metrics(table, [r[1:] for r in rows])
        if not metrics:
            return 0
        grains: List[Tuple[str, str, int]] = [("rank", str(int(rank)), int(rank))]
        if hostname:
            grains.append(("host", str(hostname), -1))
        upserts_by_tier: Dict[str, List[tuple]] = {}
        newest_bucket: Dict[str, float] = {}
        for width, _horizon in self.tiers:
            tier = tier_table(width)
            params = upserts_by_tier.setdefault(tier, [])
            for metric, (tss, steps, vals) in metrics.items():
                folded = fold_buckets(tss, steps, vals, width)
                if not folded:
                    continue
                newest_bucket[tier] = max(
                    newest_bucket.get(tier, -math.inf), folded[-1][0]
                )
                for (bucket, count, total, mn, mx, sumsq,
                     step_min, step_max) in folded:
                    for grain, key, grank in grains:
                        params.append(
                            (session_id, table, grain, key, grank, bucket,
                             metric, count, total, mn, mx, sumsq,
                             step_min, step_max)
                        )
        for tier, params in upserts_by_tier.items():
            if not params:
                continue
            conn.executemany(
                f"""INSERT INTO {tier}
                    (session_id, source_table, grain, grain_key,
                     global_rank, bucket_ts, metric, count, sum, min, max,
                     sumsq, step_min, step_max)
                    VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)
                    ON CONFLICT(session_id, source_table, grain, grain_key,
                                metric, bucket_ts)
                    DO UPDATE SET
                        count = count + excluded.count,
                        sum = sum + excluded.sum,
                        min = MIN(min, excluded.min),
                        max = MAX(max, excluded.max),
                        sumsq = sumsq + excluded.sumsq,
                        step_min = MIN(COALESCE(step_min, excluded.step_min),
                                       COALESCE(excluded.step_min, step_min)),
                        step_max = MAX(COALESCE(step_max, excluded.step_max),
                                       COALESCE(excluded.step_max, step_max))
                """,
                params,
            )
            self.rows_upserted += len(params)
        self._decay(conn, table, session_id, grains, newest_bucket)
        self.folds += 1
        self.rows_folded += len(rows)
        lat = (time.perf_counter() - t0) * 1000.0
        self.fold_ms_total += lat
        if lat > self.fold_ms_max:
            self.fold_ms_max = lat
        return len(rows)

    def _decay(
        self,
        conn: sqlite3.Connection,
        table: str,
        session_id: str,
        grains: List[Tuple[str, str, int]],
        newest_bucket: Dict[str, float],
    ) -> None:
        """Delete tier buckets older than the tier's horizon (measured
        from the newest bucket just written, so a replayed/offline
        timeline decays by its own clock).  The 10s tier's data is
        already merged into the 1m tier, so decay is a plain delete;
        the 1m horizon (default 14 days) is the documented history
        bound.  Amortized: a partition is re-checked only after its
        cutoff advances by 16 bucket widths."""
        for width, horizon in self.tiers:
            tier = tier_table(width)
            newest = newest_bucket.get(tier)
            if newest is None:
                continue
            cutoff = newest - horizon
            for grain, key, _grank in grains:
                ck = (tier, session_id, table, grain, key)
                last = self._decay_cutoffs.get(ck, -math.inf)
                if cutoff < last + 16 * width:
                    continue
                cur = conn.execute(
                    f"DELETE FROM {tier} WHERE session_id=? AND"
                    " source_table=? AND grain=? AND grain_key=? AND"
                    " bucket_ts < ?",
                    (session_id, table, grain, key, cutoff),
                )
                if cur.rowcount and cur.rowcount > 0:
                    self.rows_decayed += cur.rowcount
                self._decay_cutoffs[ck] = cutoff


def build_engine() -> Optional[RollupEngine]:
    """The writer's entry point: an engine when ``TRACEML_ROLLUP`` is
    on (the default), None when killed."""
    if str(os.environ.get(ENV_ROLLUP, "1")).strip().lower() in ("0", "false", "off"):
        return None
    try:
        return RollupEngine()
    except Exception as exc:  # pragma: no cover - defensive
        get_error_log().warning("rollup engine init failed", exc)
        return None
