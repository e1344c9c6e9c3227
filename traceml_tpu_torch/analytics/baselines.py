"""Cross-run regression baselines.

Counterpart of ``traceml_tpu/analytics/baselines.py``.  At finalize each
finished run's fingerprint (run name, mesh axes, world size) and summary
stats (steady-state step time, overlap efficiency, memory slope, serving
tokens/s) go into ``traceml_baselines.sqlite`` in the LOGS dir (one
level above the session dir, so every run under the same logs root
shares it).  A new run is judged against robust bands over the last
``TRACEML_BASELINE_MAX_RUNS`` (default 20) sessions with the SAME
fingerprint.

Bands are median ± max(k·MAD, relative floor): MAD so one earlier
outlier run cannot widen the band arbitrarily; small-n fallbacks keep
the check usable from the second run (n=1: ±50%, n=2: ±30%).

Evaluation strictly precedes ingestion, so a slow run never widens the
band it is judged against.  Everything is fail-open: a missing or
unwritable store returns None and the final summary leaves its
``regressions`` section out.

As in JAX, a regression of ``steady_step_ms`` is attributed to ranks and
hosts through the captured mesh (``utils.topology.attribute_ranks`` over
each rank's current-minus-baseline steady step): with ``topology`` the
PERF_REGRESSION issue carries an ``attribution`` when a host, a mesh
axis or one side of a node boundary explains the shift.  The
PERF_REGRESSION action names the port's own command, ``python -m
traceml_tpu_torch compare``.
"""

from __future__ import annotations

import json
import os
import sqlite3
import statistics
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from traceml_tpu_torch.utils.error_log import get_error_log

STORE_FILENAME = "traceml_baselines.sqlite"

#: matching sessions kept per fingerprint (the JAX flag's name and default)
ENV_BASELINE_MAX_RUNS = "TRACEML_BASELINE_MAX_RUNS"
DEFAULT_BASELINE_MAX_RUNS = 20

#: the PERF_REGRESSION remedy: the JAX text with the port's own command
REGRESSION_ACTION = (
    "diff this run against the baseline sessions (python -m traceml_tpu_torch "
    "compare) and check the attributed ranks' hosts before trusting new code"
)

#: metric key → (direction that is a REGRESSION, relative band floor)
#: direction "high" = larger is worse, "low" = smaller is worse
METRICS: Dict[str, Dict[str, Any]] = {
    "steady_step_ms": {"bad": "high", "rel_floor": 0.15, "unit": "ms"},
    "overlap_efficiency": {"bad": "low", "rel_floor": 0.10, "unit": ""},
    "memory_slope_pct_per_100": {"bad": "high", "rel_floor": 0.25,
                                 "unit": "%/100 steps", "abs_floor": 0.5},
    "tokens_per_s": {"bad": "low", "rel_floor": 0.15, "unit": "tok/s"},
}

_MAD_K = 3.0 * 1.4826  # 3-sigma-equivalent under normality


def _max_runs_setting() -> int:
    """``TRACEML_BASELINE_MAX_RUNS`` as the JAX flag reads it: unset gives
    the default, a malformed value the default too."""
    raw = os.environ.get(ENV_BASELINE_MAX_RUNS)
    if raw is None:
        return DEFAULT_BASELINE_MAX_RUNS
    try:
        return int(str(raw).strip())
    except ValueError:
        return DEFAULT_BASELINE_MAX_RUNS


# -- fingerprint + stats extraction ---------------------------------------


def fingerprint_from_summary(payload: Dict[str, Any]) -> Dict[str, Any]:
    """What makes two runs comparable: same run name, same mesh axes,
    same world size.  The mesh axes string comes from the topology
    capture when present (``meta.topology.mesh.axes``)."""
    meta = payload.get("meta") or {}
    topo = meta.get("topology") or {}
    mesh = topo.get("mesh") or {}
    axes = mesh.get("axes")
    if isinstance(axes, list):
        axes_str = ",".join(
            f"{a.get('name')}:{a.get('size')}@{a.get('kind', 'ici')}"
            for a in axes
            if isinstance(a, dict)
        )
    else:
        axes_str = ""
    return {
        "run_name": meta.get("run_name") or "",
        "mesh_axes": axes_str,
        "world_size": int(topo.get("world_size") or 0),
    }


def fingerprint_key(fp: Dict[str, Any]) -> str:
    return json.dumps(fp, sort_keys=True)


def _steady_step(payload: Dict[str, Any]) -> Dict[str, Any]:
    g = ((payload.get("sections") or {}).get("step_time") or {}).get(
        "global"
    ) or {}
    steady = g.get("steady_state") or {}
    median = steady.get("median_ms")
    per_rank = steady.get("per_rank_median_ms") or {}
    if median is None:
        median = ((g.get("phases") or {}).get("step_time") or {}).get(
            "median_ms"
        )
    return {"median_ms": median, "per_rank_ms": per_rank}


def summary_stats(payload: Dict[str, Any]) -> Dict[str, Any]:
    """The comparable stats of one finished session, pulled from its
    final-summary payload (missing sections yield None entries — a
    training-only run has no tokens/s and that is not a regression)."""
    sections = payload.get("sections") or {}
    step = _steady_step(payload)
    coll_g = (sections.get("collectives") or {}).get("global") or {}
    mem_g = (sections.get("step_memory") or {}).get("global") or {}
    serv_g = (sections.get("serving") or {}).get("global") or {}

    slopes: List[float] = []
    for card in (mem_g.get("per_rank") or {}).values():
        trend = (card or {}).get("trend") or {}
        v = trend.get("slope_pct_per_100")
        if v is not None:
            slopes.append(float(v))
    tokens = serv_g.get("tokens_per_s")
    if tokens is None:
        tokens = (serv_g.get("totals") or {}).get("tokens_per_s")
    return {
        "steady_step_ms": step["median_ms"],
        "per_rank_step_ms": step["per_rank_ms"],
        "overlap_efficiency": coll_g.get("overlap_efficiency"),
        "memory_slope_pct_per_100": (
            statistics.median(slopes) if slopes else None
        ),
        "tokens_per_s": tokens,
    }


# -- the store ------------------------------------------------------------


class BaselineStore:
    """Tiny SQLite store keyed by fingerprint; per-fingerprint history
    trimmed to ``TRACEML_BASELINE_MAX_RUNS`` newest sessions."""

    def __init__(self, path: Path, max_runs: Optional[int] = None) -> None:
        self.path = Path(path)
        self.max_runs = (
            int(max_runs)
            if max_runs is not None
            else max(1, _max_runs_setting())
        )
        self._conn = sqlite3.connect(str(self.path))
        self._conn.execute(
            """CREATE TABLE IF NOT EXISTS baseline_runs (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                fingerprint TEXT NOT NULL,
                session_id TEXT NOT NULL,
                recorded_ts REAL,
                stats_json TEXT NOT NULL,
                UNIQUE (fingerprint, session_id)
            )"""
        )
        self._conn.commit()

    def close(self) -> None:
        try:
            self._conn.close()
        except sqlite3.Error:
            pass

    def matching_runs(
        self, fp: Dict[str, Any], exclude_session: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        """Prior runs with this fingerprint, oldest first, excluding
        the session under evaluation (re-finalize must not self-match)."""
        rows = self._conn.execute(
            "SELECT session_id, recorded_ts, stats_json FROM baseline_runs"
            " WHERE fingerprint=? ORDER BY id",
            (fingerprint_key(fp),),
        ).fetchall()
        out = []
        for session_id, ts, stats_json in rows:
            if exclude_session is not None and session_id == exclude_session:
                continue
            try:
                stats = json.loads(stats_json)
            except ValueError:
                continue
            out.append(
                {"session_id": session_id, "ts": ts, "stats": stats}
            )
        return out

    def record(
        self,
        fp: Dict[str, Any],
        session_id: str,
        stats: Dict[str, Any],
        ts: Optional[float] = None,
    ) -> None:
        """Upsert this session's stats and trim the fingerprint's
        history to ``max_runs`` newest rows."""
        key = fingerprint_key(fp)
        self._conn.execute(
            "INSERT INTO baseline_runs"
            " (fingerprint, session_id, recorded_ts, stats_json)"
            " VALUES (?,?,?,?)"
            " ON CONFLICT(fingerprint, session_id) DO UPDATE SET"
            " recorded_ts=excluded.recorded_ts,"
            " stats_json=excluded.stats_json",
            (key, session_id, ts if ts is not None else time.time(),
             json.dumps(stats)),
        )
        self._conn.execute(
            "DELETE FROM baseline_runs WHERE fingerprint=? AND id NOT IN ("
            " SELECT id FROM baseline_runs WHERE fingerprint=?"
            " ORDER BY id DESC LIMIT ?)",
            (key, key, self.max_runs),
        )
        self._conn.commit()


# -- robust bands + evaluation --------------------------------------------


def robust_band(
    values: List[float], rel_floor: float, abs_floor: float = 0.0
) -> Optional[Dict[str, float]]:
    """Median ± max(k·MAD, floors).  Small-n fallbacks: one prior run
    allows ±50%, two allow ±30% — usable detection from run #2 while a
    deep history tightens the band."""
    vals = [float(v) for v in values if v is not None]
    if not vals:
        return None
    center = statistics.median(vals)
    scale = max(abs(center), 1e-12)
    if len(vals) == 1:
        half = max(0.5 * scale, abs_floor)
    elif len(vals) == 2:
        half = max(0.3 * scale, abs_floor)
    else:
        mad = statistics.median([abs(v - center) for v in vals])
        half = max(_MAD_K * mad, rel_floor * scale, abs_floor)
    return {"center": center, "low": center - half, "high": center + half,
            "n": len(vals)}


def evaluate(
    stats: Dict[str, Any],
    baseline_runs: List[Dict[str, Any]],
    topology: Any = None,
) -> Dict[str, Any]:
    """Check each metric against its band over the baseline runs.
    Returns the ``regressions`` payload section: overall status, one
    entry per evaluable metric, and PERF_REGRESSION issues.  ``topology``
    is the captured ``MeshTopology`` (or None): a step-time regression's
    issue then names the ranks' grouping that explains it."""
    checks: List[Dict[str, Any]] = []
    issues: List[Dict[str, Any]] = []
    for metric, spec in METRICS.items():
        current = stats.get(metric)
        history = [r["stats"].get(metric) for r in baseline_runs]
        band = robust_band(
            history, spec["rel_floor"], spec.get("abs_floor", 0.0)
        )
        if current is None or band is None:
            continue
        current = float(current)
        bad = spec["bad"]
        outside_bad = (
            current > band["high"] if bad == "high" else current < band["low"]
        )
        outside_good = (
            current < band["low"] if bad == "high" else current > band["high"]
        )
        delta_pct = (
            (current - band["center"]) / abs(band["center"]) * 100.0
            if band["center"]
            else None
        )
        check = {
            "metric": metric,
            "current": current,
            "baseline_median": band["center"],
            "band": [band["low"], band["high"]],
            "baseline_runs": band["n"],
            "delta_pct": round(delta_pct, 2) if delta_pct is not None else None,
            "status": (
                "regression" if outside_bad
                else "improved" if outside_good
                else "ok"
            ),
        }
        checks.append(check)
        if outside_bad:
            issues.append(_regression_issue(metric, spec, check, stats, baseline_runs, topology))
    status = (
        "regression" if any(c["status"] == "regression" for c in checks)
        else "ok" if checks
        else "no_baseline"
    )
    return {
        "status": status,
        "baseline_runs": len(baseline_runs),
        "checks": checks,
        "issues": issues,
    }


def _regression_issue(
    metric: str,
    spec: Dict[str, Any],
    check: Dict[str, Any],
    stats: Optional[Dict[str, Any]] = None,
    baseline_runs: Optional[List[Dict[str, Any]]] = None,
    topology: Any = None,
) -> Dict[str, Any]:
    delta = check.get("delta_pct")
    worse = (
        f"{abs(delta):.1f}% "
        + ("above" if spec["bad"] == "high" else "below")
        if delta is not None
        else "outside"
    )
    issue = {
        "kind": "PERF_REGRESSION",
        "severity": "warn",
        "metric": metric,
        "summary": (
            f"{metric} {check['current']:.4g}{spec['unit'] and ' ' + spec['unit']} is "
            f"{worse} the median of the last {check['baseline_runs']} "
            f"matching run(s) ({check['baseline_median']:.4g})"
        ),
        "action": REGRESSION_ACTION,
    }
    # the cross-run analogue of the within-run attribution: which ranks moved
    if metric == "steady_step_ms" and topology is not None:
        deltas = _per_rank_step_deltas(stats or {}, baseline_runs or [])
        if deltas:
            try:
                from traceml_tpu_torch.utils.topology import attribute_ranks

                attribution = attribute_ranks(deltas, topology)
                if attribution is not None:
                    issue["attribution"] = attribution.to_dict()
            except Exception:
                pass
    return issue


def _per_rank_step_deltas(stats: Dict[str, Any], baseline_runs: List[Dict[str, Any]]) -> Dict[int, float]:
    """Per-rank current-minus-baseline steady step ms (the baseline is
    each rank's median across the matching runs)."""
    current = stats.get("per_rank_step_ms") or {}
    history: Dict[str, List[float]] = {}
    for run in baseline_runs:
        for r, v in (run["stats"].get("per_rank_step_ms") or {}).items():
            if v is not None:
                history.setdefault(str(r), []).append(float(v))
    deltas: Dict[int, float] = {}
    for r, v in current.items():
        base = history.get(str(r))
        if v is None or not base:
            continue
        deltas[int(r)] = float(v) - statistics.median(base)
    return deltas


# -- the finalize entry point ---------------------------------------------


def evaluate_and_record(
    session_dir: Path,
    payload: Dict[str, Any],
    topology: Any = None,
    store_path: Optional[Path] = None,
) -> Optional[Dict[str, Any]]:
    """Evaluate this finished session against its fingerprint's prior
    runs, THEN ingest it (in that order — a regressed run must not
    widen the band that judged it).  Returns the ``regressions``
    section, or None when the store is unusable (caller omits the
    section; fail-open)."""
    session_dir = Path(session_dir)
    path = (
        Path(store_path)
        if store_path is not None
        else session_dir.parent / STORE_FILENAME
    )
    fp = fingerprint_from_summary(payload)
    stats = summary_stats(payload)
    session_id = (payload.get("meta") or {}).get("session_id") or (
        session_dir.name
    )
    if all(
        stats.get(m) is None for m in METRICS
    ):
        return None  # nothing comparable (e.g. an empty/aborted run)
    try:
        store = BaselineStore(path)
    except sqlite3.Error as exc:
        get_error_log().warning("baseline store unavailable", exc)
        return None
    try:
        prior = store.matching_runs(fp, exclude_session=str(session_id))
        result = evaluate(stats, prior, topology=topology)
        result["fingerprint"] = fp
        store.record(fp, str(session_id), stats)
        return result
    except sqlite3.Error as exc:
        get_error_log().warning("baseline evaluate/record failed", exc)
        return None
    finally:
        store.close()
