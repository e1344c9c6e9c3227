"""Compare significance thresholds.

Counterpart of ``traceml_tpu/reporting/compare/policy.py`` (copied): the
conservative significance policy (small deltas are noise, not verdicts;
the policy is biased toward abstaining rather than overstating).

Tiers: ``negligible`` (below minor threshold — not even reported),
``minor`` and ``major``.  Every section comparer classifies through
:func:`classify` so the tiers are uniform across domains.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

MiB = 1024 * 1024
GiB = 1024 * MiB

# diagnosis kinds ranked by how pathological they are — a candidate run
# moving UP this ladder is a regression signal even when raw deltas are
# small
DIAGNOSIS_RANK = {
    "NO_DATA": 0,
    "WARMUP": 0,
    "HEALTHY": 1,
    "BALANCED": 1,
    "COMPUTE_BOUND": 2,
    "INPUT_BOUND": 2,
    "H2D_BOUND": 2,
    "RESIDUAL_HEAVY": 3,
    "COMPILE_BOUND": 3,
    "MEMORY_RISING": 2,
    "MEMORY_IMBALANCE": 3,
    "INPUT_STRAGGLER": 4,
    "COMPUTE_STRAGGLER": 4,
    "COLLECTIVE_STRAGGLER": 4,
    "CHECKPOINT_STRAGGLER": 4,
    "H2D_STRAGGLER": 4,
    "RESIDUAL_STRAGGLER": 4,
    "COMPILE_STRAGGLER": 4,
    "STRAGGLER": 4,
    "MEMORY_CREEP": 4,
    "HIGH_PRESSURE": 4,
}


@dataclasses.dataclass(frozen=True)
class ComparePolicy:
    # step average: minor / major relative change
    step_avg_minor: float = 0.03
    step_avg_major: float = 0.08
    # phase share shift in percentage points
    phase_shift_minor_pp: float = 0.75
    phase_shift_major_pp: float = 2.0
    # memory deltas (per-rank peak and global peak)
    memory_minor_bytes: int = 256 * MiB
    memory_major_bytes: int = 1 * GiB
    # cross-rank memory skew shift, percentage points of the median
    memory_skew_minor_pp: float = 0.75
    memory_skew_major_pp: float = 2.5
    # host cpu mean shift, percentage points
    system_cpu_minor_pp: float = 10.0
    system_cpu_major_pp: float = 25.0
    # host memory shift
    system_memory_minor_bytes: int = 512 * MiB
    system_memory_major_bytes: int = 2 * GiB
    # per-rank process cpu shift, percentage points
    process_cpu_minor_pp: float = 15.0
    process_cpu_major_pp: float = 40.0
    # per-rank process rss shift
    process_rss_minor_bytes: int = 256 * MiB
    process_rss_major_bytes: int = 1 * GiB
    # windows smaller than this are too noisy to compare
    min_steps: int = 8


DEFAULT_POLICY = ComparePolicy()


def classify(
    abs_value: Optional[float], minor: float, major: float
) -> str:
    """Uniform three-tier significance classification."""
    if abs_value is None:
        return "negligible"
    v = abs(abs_value)
    if v >= major:
        return "major"
    if v >= minor:
        return "minor"
    return "negligible"


def diagnosis_rank(kind: Optional[str]) -> int:
    return DIAGNOSIS_RANK.get(str(kind or "").upper(), 1)
