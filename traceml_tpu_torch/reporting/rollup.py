"""Uniform cross-rank rollup for final-report sections.

Counterpart of ``traceml_tpu/reporting/rollup.py`` (copied).  Every
section's rollup shares one shape: ``{index_by, window, average,
median{metric:{value, idx}}, worst{metric:{value, idx}}}``.

Why a *median rank* and not just the median value: the summary's
"median/worst" pairs name a concrete rank to ssh into on both ends —
``median.idx`` is the rank whose value sits closest to the cross-rank
median (deterministic tie-break: smaller value, then smaller rank),
``worst.idx`` the maximum (tie-break: smaller rank), so the pairs are
stable run to run.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

from traceml_tpu_torch.utils.rankstats import (  # noqa: F401
    closest_rank_to_median,
    worst_rank,
)


def _finite(value: Any) -> Optional[float]:
    try:
        v = float(value)
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None


def _point(values: Mapping[str, float], kind: str) -> Dict[str, Any]:
    idx = (
        closest_rank_to_median(values) if kind == "median"
        else worst_rank(values)
    )
    return {
        "value": values.get(idx) if idx is not None else None,
        "idx": idx,
    }


def build_rollup(
    per_metric_rank_values: Mapping[str, Mapping[str, Any]],
    *,
    index_by: str = "global_rank",
    window: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Build the uniform rollup from ``{metric: {rank: value}}``.

    Non-finite / missing values are dropped per metric; a metric with no
    finite values gets ``{value: None, idx: None}`` points so the shape
    is stable for compare and for NO_DATA degradation.
    """
    average: Dict[str, Optional[float]] = {}
    median: Dict[str, Dict[str, Any]] = {}
    worst: Dict[str, Dict[str, Any]] = {}
    for metric in sorted(per_metric_rank_values):
        finite = {
            str(r): fv
            for r, v in per_metric_rank_values[metric].items()
            if (fv := _finite(v)) is not None
        }
        average[metric] = (
            sum(finite.values()) / len(finite) if finite else None
        )
        median[metric] = _point(finite, "median")
        worst[metric] = _point(finite, "worst")
    return {
        "index_by": index_by,
        "window": window or {},
        "average": average,
        "median": median,
        "worst": worst,
    }
