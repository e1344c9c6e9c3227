"""Liveness thresholds, live vs summary.

Counterpart of ``traceml_tpu/diagnostics/liveness/policy.py`` (copied).
The state machine itself (ACTIVE→STALE→LOST) lives aggregator-side in
:mod:`traceml_tpu_torch.aggregator.liveness`, driven by heartbeat age; these
policies only govern how the *diagnosis* reads a persisted
``rank_status.json`` snapshot — chiefly how abruptly a rank must have
gone silent for LIKELY_PREEMPTED to refine RANK_LOST.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LivenessPolicy:
    # LIKELY_PREEMPTED: a lost rank whose last step progress landed
    # within this many seconds of its last contact died mid-stride —
    # the abrupt-kill / preemption profile, as opposed to a rank that
    # idled (hung, deadlocked, draining) before vanishing
    preempt_stride_sec: float = 10.0
    # STALE ranks alone never fire RANK_LOST, but enough of the world
    # simultaneously stale is worth a warning (network partition /
    # aggregator overload profile)
    stale_share_warn: float = 0.5
    # coverage denominator for confidence_from: observed world share
    min_ranks: int = 1


LIVE_POLICY = LivenessPolicy()

SUMMARY_POLICY = LivenessPolicy()


def policy_for(mode: str) -> LivenessPolicy:
    return SUMMARY_POLICY if mode == "summary" else LIVE_POLICY
