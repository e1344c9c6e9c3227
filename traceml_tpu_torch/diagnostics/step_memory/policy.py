"""Step-memory thresholds.

Counterpart of ``traceml_tpu/diagnostics/step_memory/policy.py`` (copied).
"""

from __future__ import annotations

import dataclasses

MiB = 1024 * 1024
GiB = 1024 * MiB


@dataclasses.dataclass(frozen=True)
class StepMemoryPolicy:
    pressure_warn: float = 0.92  # used / capacity
    pressure_critical: float = 0.97
    imbalance_warn: float = 0.20  # cross-rank skew
    imbalance_critical: float = 0.30
    imbalance_pressure_gate: float = 0.5  # only interesting when ≥50% full
    # creep heuristics: the ≥800-row gate, 512 MiB / 1 GiB delta bars,
    # worst/median growth and slope bars, and the ≤2% peak-pullback
    # weak-recovery tolerance
    creep_min_steps: int = 800
    creep_min_delta_bytes: int = 512 * MiB
    creep_min_growth_pct: float = 0.06        # worst rank must clear this
    creep_median_growth_pct: float = 0.04     # cluster-wide when median clears
    creep_min_slope_pct_per_100: float = 0.015   # worst rank, rel. to mean
    creep_median_slope_pct_per_100: float = 0.010
    creep_pullback_max: float = 0.02          # deeper dip ⇒ allocator recovered
    creep_short_window: int = 100
    creep_long_window: int = 400
    creep_confirmed_delta_bytes: int = 1 * GiB


DEFAULT_POLICY = StepMemoryPolicy()
