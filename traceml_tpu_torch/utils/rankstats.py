"""Cross-rank point attribution helpers.

Counterpart of ``traceml_tpu/utils/rankstats.py`` (copied).

Shared by the live views and the final-report rollup so "median rank" /
"worst rank" mean the SAME thing on every surface: ``median`` names the
rank whose value sits closest to the cross-rank median (deterministic
tie-breaks: value distance, then value, then rank id), ``worst`` the
maximum (ties toward the smaller rank id).
"""

from __future__ import annotations

import statistics
from typing import Mapping, Optional


def _rank_sort(rank_key) -> int:
    try:
        return int(rank_key)
    except (TypeError, ValueError):
        return 0


def closest_rank_to_median(values: Mapping) -> Optional[str]:
    """The rank id whose value sits closest to the cross-rank median."""
    if not values:
        return None
    median_value = statistics.median(values.values())
    return min(
        values,
        key=lambda k: (abs(values[k] - median_value), values[k], _rank_sort(k)),
    )


def worst_rank(values: Mapping) -> Optional[str]:
    """The rank id with the maximum value (ties → smaller rank id)."""
    if not values:
        return None
    return max(values, key=lambda k: (values[k], -_rank_sort(k)))
