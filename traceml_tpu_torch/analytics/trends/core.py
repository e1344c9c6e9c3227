"""Generic trend analysis — banded AND windowed evidence.

Counterpart of ``traceml_tpu/analytics/trends/core.py`` (copied).

Two complementary evidence shapes over one numeric series:

* **banded** (:func:`compute_trend_evidence`) — baseline / mid / recent
  thirds with band means, least-squares slope, monotonicity.  Robust to
  noise, explains *the whole history*.
* **windowed** (:func:`compute_window_trend`) — short-window mean vs
  long-window mean over the TAIL, relative slope, and peak-pullback
  recovery detection.  Explains *what is happening now* and rejects
  sawtooth allocators (grow → GC → grow) via the pullback check.

Cross-series rollup (:func:`summarize_across`) gives worst/median stats
over per-rank evidences so rules can demand "worst rank clears the high
bar AND the median rank clears the low bar" — a cluster-wide creep is a
different finding from one leaking rank.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class TrendEvidence:
    n: int
    baseline_mean: float
    mid_mean: float
    recent_mean: float
    delta: float  # recent − baseline
    growth_pct: float  # delta / max(baseline, eps)
    slope_per_100: float  # least-squares slope × 100 samples
    monotonic_band_growth: bool  # baseline ≤ mid ≤ recent
    weak_recovery: bool  # recent dipped below mid (recovering)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def compute_trend_evidence(series: Sequence[float]) -> Optional[TrendEvidence]:
    xs: List[float] = [float(v) for v in series if v is not None]
    n = len(xs)
    if n < 9:  # need ≥3 per band
        return None
    third = n // 3
    baseline = xs[:third]
    mid = xs[third : 2 * third]
    recent = xs[2 * third :]
    b, m, r = _mean(baseline), _mean(mid), _mean(recent)
    delta = r - b
    growth = delta / b if b > 0 else (0.0 if delta == 0 else float("inf"))
    # least-squares slope per sample, scaled to per-100-samples
    mean_i = (n - 1) / 2.0
    mean_x = _mean(xs)
    num = sum((i - mean_i) * (x - mean_x) for i, x in enumerate(xs))
    den = sum((i - mean_i) ** 2 for i in range(n))
    slope = (num / den if den else 0.0) * 100.0
    return TrendEvidence(
        n=n,
        baseline_mean=b,
        mid_mean=m,
        recent_mean=r,
        delta=delta,
        growth_pct=growth,
        slope_per_100=slope,
        monotonic_band_growth=(b <= m <= r),
        weak_recovery=(r < m),
    )


@dataclasses.dataclass
class WindowTrendEvidence:
    """Short-vs-long tail-window evidence: short/long window means,
    relative slope, pullback recovery."""

    n: int
    short_n: int
    long_n: int
    short_mean: float
    long_mean: float
    trend_pct: float          # short/long − 1 (what is happening NOW)
    slope_pct_per_100: float  # LS slope over the long window / its mean
    peak: float
    pullback_pct: float       # (peak − recent) / peak; sawtooth detector
    recovered: bool           # pullback exceeded the tolerance

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def compute_window_trend(
    series: Sequence[float],
    short_n: int = 100,
    long_n: int = 400,
    pullback_tolerance: float = 0.02,
) -> Optional[WindowTrendEvidence]:
    """Tail-window trend: is the series STILL rising, and has it ever
    meaningfully pulled back from its peak (allocator recovery)?"""
    xs: List[float] = [float(v) for v in series if v is not None]
    n = len(xs)
    if n < max(8, short_n // 4):
        return None
    short = xs[-min(short_n, n):]
    long = xs[-min(long_n, n):]
    s_mean, l_mean = _mean(short), _mean(long)
    trend_pct = (s_mean / l_mean - 1.0) if l_mean > 0 else 0.0
    # least-squares slope over the long window, relative to its mean
    ln = len(long)
    mean_i = (ln - 1) / 2.0
    num = sum((i - mean_i) * (x - l_mean) for i, x in enumerate(long))
    den = sum((i - mean_i) ** 2 for i in range(ln))
    slope = (num / den if den else 0.0) * 100.0
    slope_pct = slope / l_mean if l_mean > 0 else 0.0
    peak = max(xs)
    # compare against the recent MAX, not mean: a monotonically rising
    # series' recent mean always lags its own tip and would read as a
    # false pullback
    recent = max(xs[-max(3, len(short) // 4):])
    pullback = (peak - recent) / peak if peak > 0 else 0.0
    return WindowTrendEvidence(
        n=n,
        short_n=len(short),
        long_n=ln,
        short_mean=s_mean,
        long_mean=l_mean,
        trend_pct=trend_pct,
        slope_pct_per_100=slope_pct,
        peak=peak,
        pullback_pct=pullback,
        recovered=pullback > pullback_tolerance,
    )


@dataclasses.dataclass
class CrossSeriesSummary:
    """Worst/median rollup over per-key scalar evidence values."""

    n_series: int
    worst_key: Optional[object]
    worst: float
    median: float

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["worst_key"] = str(self.worst_key)
        return d


def summarize_across(values: Dict[object, float]) -> Optional[CrossSeriesSummary]:
    vals = {k: float(v) for k, v in values.items() if v is not None}
    if not vals:
        return None
    worst_key = max(vals, key=lambda k: vals[k])
    return CrossSeriesSummary(
        n_series=len(vals),
        worst_key=worst_key,
        worst=vals[worst_key],
        median=statistics.median(vals.values()),
    )
