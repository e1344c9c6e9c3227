"""Collectives thresholds, live vs summary.

Counterpart of ``traceml_tpu/diagnostics/collectives/policy.py`` (copied).
The numbers come from the motivating papers' framing: T3
(arXiv:2401.16677) treats exposed (serialized) collective time as the
quantity to hide — a step spending over ~20% of its wall clock on
exposed comm is communication-bound territory; EQuARX
(arXiv:2506.17615) reports ~2x AllReduce speedups from block-wise
quantization with negligible quality loss at multi-MB fp32 gradient
payloads, which sets the byte floor for the quantization suggestion.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CollectivesPolicy:
    # COMM_BOUND: exposed comm as a share of mean step time
    exposed_share_warn: float
    exposed_share_critical: float
    # POOR_OVERLAP: overall overlap efficiency (1 − exposed/total)
    overlap_eff_warn: float = 0.50
    overlap_eff_critical: float = 0.20
    # ...judged only when comm is significant: total comm time per step
    # above this floor (ms), or comm/compute share above this fraction
    min_comm_ms_per_step: float = 1.0
    comm_share_gate: float = 0.05
    # headroom gate: the run's own best steps must show meaningfully
    # better overlap before POOR_OVERLAP blames scheduling (if every
    # step overlaps equally badly, COMM_BOUND is the verdict instead)
    overlap_headroom_gate: float = 0.15
    # ALLREDUCE_QUANTIZABLE: fp32 all-reduce payload floor per step and
    # step-to-step stability (coefficient of variation) ceiling
    quantizable_min_bytes: int = 1 << 20  # 1 MiB/step
    quantizable_cv_max: float = 0.25
    quantizable_min_share: float = 0.25  # of steps carrying fp32 all-reduce
    min_steps: int = 10
    # coverage denominator for confidence_from
    full_window_steps: int = 60


LIVE_POLICY = CollectivesPolicy(
    exposed_share_warn=0.20,
    exposed_share_critical=0.35,
    min_steps=5,
    full_window_steps=30,
)

SUMMARY_POLICY = CollectivesPolicy(
    exposed_share_warn=0.25,
    exposed_share_critical=0.40,
    min_steps=10,
    full_window_steps=60,
)


def policy_for(mode: str) -> CollectivesPolicy:
    return SUMMARY_POLICY if mode == "summary" else LIVE_POLICY
