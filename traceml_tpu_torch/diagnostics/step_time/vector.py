"""Vectorized gate arm for the step_time diagnosis pack.

Counterpart of ``traceml_tpu/diagnostics/step_time/vector.py`` (copied).
``gate(window)`` is the single decision point: it returns the window's
column engine (``window.col``) when the vectorized arm may run
(``TRACEML_VECTOR_DIAGNOSIS`` on and a cube-backed window) and ``None``
otherwise, which forces the scalar golden-reference arm in ``rules.py``.
Every helper here is a bit-identical numpy transcription of the scalar
loop it replaces (the same ``np.median`` == ``statistics.median``
midpoint for float64, the same first-max tie-breaks, results cast back
to native ``float`` before they land in evidence dicts), so the two arms
emit byte-identical ``DiagnosticIssue`` lists
(``tests/test_torch_vector_parity.py``).

A helper that cannot reproduce the scalar loop exactly (a shape
surprise, a missing column) returns ``None`` and counts a fallback via
``note_vector_fallback`` instead of logging on every tick; the caller
reruns the scalar arm.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from traceml_tpu_torch.utils.columnar import (
    KEY_INDEX,
    note_vector_fallback,
    vector_diagnosis_enabled,
)

DOMAIN = "step_time"


def gate(window):
    """The vectorized-arm gate: ``window.col`` when the flag is on and
    the window is cube-backed, else ``None`` (scalar reference arm)."""
    if not vector_diagnosis_enabled():
        return None
    return getattr(window, "col", None)


def component_deltas(
    col,
    stat_name: str,
    keys: List[str],
    sync_phase: Optional[str],
    clean_sync: Dict[int, float],
    worst_rank: int,
) -> Optional[Dict[str, float]]:
    """Cube-native form of the CleanStragglerRule component-attribution
    loop: per-phase delta of the worst rank vs the cross-rank median,
    read straight from the (R, 11) per-rank statistic matrix instead of
    materializing every rank's ``RankWindow`` (the warm tick's hot spot
    at many ranks)."""
    try:
        stats = col.medians if stat_name == "medians" else col.averages
        ranks = col.ranks
        widx = ranks.index(worst_rank)
        deltas: Dict[str, float] = {}
        for key in keys:
            if key == sync_phase:
                # the sync phase reads its CLEAN form, already computed
                # (native floats, in ranks order) by _clean_math
                vals = np.asarray(
                    [clean_sync[r] for r in ranks], dtype=np.float64
                )
                worst_v = clean_sync[worst_rank]
            else:
                vals = stats[:, KEY_INDEX[key]]
                worst_v = float(vals[widx])
            deltas[key] = max(0.0, worst_v - float(np.median(vals)))
        return deltas
    except Exception:
        note_vector_fallback(DOMAIN)
        return None
