"""Step-time thresholds, live vs summary.

Counterpart of ``traceml_tpu/diagnostics/step_time/policy.py`` (copied:
the same numbers, so both packages give the same verdicts on the same
rows).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StepTimePolicy:
    # input share of step (median across ranks)
    input_share_warn: float
    input_share_critical: float
    # residual share
    residual_share_warn: float
    residual_share_critical: float
    # compute-bound (info-grade: the job is healthy-but-saturated)
    compute_share_info: float
    compute_share_high: float
    # straggler scoring
    straggler_score_fire: float = 0.10
    straggler_dominance: float = 1.25  # component must beat 2nd by this
    skew_gate: float = 0.06
    # compile share (TPU-new): recompilation storms.  Compiles within the
    # first N absolute steps are warmup, not recompiles.
    compile_share_warn: float = 0.10
    compile_share_critical: float = 0.25
    compile_warmup_steps: int = 3
    # device occupancy (device-busy share of wall clock) — the TPU
    # stand-in for the reference's GPU-utilization rule
    # (reference: diagnostics/system/rules.py GPUUtilizationRule)
    occupancy_warn: float = 0.30
    occupancy_critical: float = 0.15
    # MFU (achieved/peak FLOP/s, TPU-new): only judged when the chip is
    # the bottleneck (compute share ≥ mfu_compute_gate) — a busy chip
    # at low MFU means the program wastes the MXU (fusion, precision,
    # tiny matmuls), which occupancy alone cannot see.  Well-tuned LLM
    # training lands 0.35–0.55; below 0.15 something is structurally
    # wrong.
    mfu_low_warn: float = 0.15
    mfu_moderate: float = 0.30
    mfu_compute_gate: float = 0.50
    min_steps: int = 20


LIVE_POLICY = StepTimePolicy(
    input_share_warn=0.25,
    input_share_critical=0.35,
    residual_share_warn=0.15,
    residual_share_critical=0.25,
    compute_share_info=0.85,
    compute_share_high=0.92,
    min_steps=20,
)

SUMMARY_POLICY = StepTimePolicy(
    input_share_warn=0.30,
    input_share_critical=0.40,
    residual_share_warn=0.18,
    residual_share_critical=0.28,
    compute_share_info=0.85,
    compute_share_high=0.92,
    min_steps=50,
)


def policy_for(mode: str) -> StepTimePolicy:
    return SUMMARY_POLICY if mode == "summary" else LIVE_POLICY
