"""Vectorized gate arm for the step_memory diagnosis pack.

Counterpart of ``traceml_tpu/diagnostics/step_memory/vector.py``
(copied).  Memory series reads (``latest_pressure`` / ``last_used``) are
O(1) tail-row lookups on the int-column rings, so the per-series loops
stay scalar; what vectorizes is ImbalanceRule's cross-rank aggregation:
median, first-argmax worst rank and skew over the per-rank byte map,
with ``np.median`` matching ``statistics.median`` and ``np.argmax``
matching the scalar first-max tie-break bit for bit.

``enabled()`` is the pack's kill-switch gate
(``TRACEML_VECTOR_DIAGNOSIS=0`` forces the scalar reference arm); the
helper returns ``None`` and counts a fallback instead of logging when
it cannot reproduce the scalar loop.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from traceml_tpu_torch.utils.columnar import (
    note_vector_fallback,
    vector_diagnosis_enabled,
)

DOMAIN = "step_memory"


def enabled() -> bool:
    return vector_diagnosis_enabled()


def median_worst_skew(
    per_rank: Dict[int, float],
) -> Optional[Tuple[float, int, float]]:
    """ImbalanceRule's cross-rank scan: (median bytes, worst rank via
    first-max tie-break, skew vs the median).  Caller guards
    ``len >= 2``; a non-positive median returns skew 0.0 and the caller
    bails exactly like the scalar arm.  ``None`` → scalar arm."""
    try:
        ranks = list(per_rank)
        vals = np.asarray(list(per_rank.values()), dtype=np.float64)
        med = float(np.median(vals))
        widx = int(np.argmax(vals))
        worst_rank = ranks[widx]
        skew = ((float(vals[widx]) - med) / med) if med > 0 else 0.0
        return med, worst_rank, skew
    except Exception:
        note_vector_fallback(DOMAIN)
        return None
