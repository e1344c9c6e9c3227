"""Vectorized gate arm for the collectives diagnosis pack.

Counterpart of ``traceml_tpu/diagnostics/collectives/vector.py``, with
one change: the fp32 payload mean folds as the running interpreter's
``sum()`` (``utils/columnar.py`` ``sum_fold``: compensated since
CPython 3.12), which the scalar arm's ``sum(nz)`` is; the JAX arm folds
with ``np.cumsum``, the plain left fold.

The collectives window carries per-step slot series (lists emitted from
the incremental cache's slot arrays) and a small per-rank aggregate dict; the helpers
here lift the PoorOverlap / AllreduceQuantizable per-step and per-rank
loops into numpy while reproducing the scalar arm bit-for-bit:
``np.median`` matches ``statistics.median`` for float64, boolean masks
match the ``if d > 0.0`` filters, and ``sum_fold`` matches ``sum()``
(``statistics.pstdev`` stays scalar: its exact-Fraction arithmetic has
no numpy twin, and it is fed the identical float population either
way).

``enabled()`` is the pack's kill-switch gate
(``TRACEML_VECTOR_DIAGNOSIS=0`` forces the scalar reference arm); a
helper that cannot reproduce its loop returns ``None`` and counts a
fallback instead of logging per tick.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from traceml_tpu_torch.utils.columnar import (
    note_vector_fallback,
    sum_fold,
    vector_diagnosis_enabled,
)

DOMAIN = "collectives"


def enabled() -> bool:
    return vector_diagnosis_enabled()


def poor_overlap_stats(
    per_step: Dict[str, List[float]],
    per_rank: Dict[int, Dict[str, float]],
    headroom_gate: float,
) -> Optional[Tuple[Optional[float], Optional[float], List[int]]]:
    """PoorOverlapRule's two scalar scans as masked reductions:
    (best-steps 75th-pct efficiency, median rank efficiency, lagging
    ranks sorted).  ``None`` → rerun the scalar arm."""
    try:
        eff = np.asarray(
            per_step.get("overlap_efficiency") or [], dtype=np.float64
        )
        dur = np.asarray(per_step.get("duration_ms") or [], dtype=np.float64)
        best_eff: Optional[float] = None
        if eff.shape == dur.shape:
            sel = eff[dur > 0.0]
            if sel.size:
                ranked = np.sort(sel)
                best_eff = float(
                    ranked[min(ranked.size - 1, int(ranked.size * 0.75))]
                )
        elif eff.size or dur.size:
            raise ValueError("ragged per-step series")
        median_rank_eff: Optional[float] = None
        lag_ranks: List[int] = []
        if per_rank:
            ranks = np.asarray(list(per_rank), dtype=np.int64)
            vals = np.asarray(
                [v["overlap_efficiency"] for v in per_rank.values()],
                dtype=np.float64,
            )
            median_rank_eff = float(np.median(vals))
            lag_ranks = np.sort(
                ranks[median_rank_eff - vals >= headroom_gate]
            ).tolist()
        return best_eff, median_rank_eff, lag_ranks
    except Exception:
        note_vector_fallback(DOMAIN)
        return None


def fp32_allreduce_stats(
    series: List[float],
) -> Optional[Tuple[int, float, List[float]]]:
    """AllreduceQuantizableRule's payload scan: (non-zero count, mean
    bytes via the scalar arm's ``sum()`` fold, the non-zero population
    as native floats for ``statistics.pstdev``).  ``None`` → scalar arm."""
    try:
        arr = np.asarray(series, dtype=np.float64)
        nz = arr[arr > 0]
        if nz.size == 0:
            return 0, 0.0, []
        mean_bytes = float(sum_fold(nz[:, None])[0]) / nz.size
        return int(nz.size), mean_bytes, nz.tolist()
    except Exception:
        note_vector_fallback(DOMAIN)
        return None
