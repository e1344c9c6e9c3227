"""Collectives rules: COMM_BOUND, POOR_OVERLAP, ALLREDUCE_QUANTIZABLE.

Counterpart of ``traceml_tpu/diagnostics/collectives/rules.py`` (copied):
the rules, thresholds, summaries and actions are the JAX ones, none of
which names a JAX or TPU remedy.

All three consume one :class:`CollectivesContext` built from the
cross-rank :class:`~traceml_tpu_torch.utils.columnar.CollectivesWindow`
(plus the mean step time from the step_time window, when available,
for the comm/compute ratio)."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Optional

from traceml_tpu_torch.diagnostics.common import (
    DiagnosticIssue,
    SEVERITY_CRITICAL,
    SEVERITY_INFO,
    SEVERITY_WARNING,
    confidence_from,
)
from traceml_tpu_torch.diagnostics.collectives import vector
from traceml_tpu_torch.diagnostics.collectives.policy import CollectivesPolicy
from traceml_tpu_torch.utils.columnar import CollectivesWindow


@dataclasses.dataclass
class CollectivesContext:
    window: CollectivesWindow
    policy: CollectivesPolicy
    # mean step duration (ms) over the same window, from step_time —
    # None when the step_time domain has no aligned window yet
    step_time_ms: Optional[float]
    n_steps: int = 0
    comm_ms_per_step: float = 0.0
    exposed_ms_per_step: float = 0.0
    overlap_efficiency: float = 1.0
    # exposed comm ÷ step time and total comm ÷ step time (None without
    # a step-time denominator)
    exposed_share: Optional[float] = None
    comm_share: Optional[float] = None
    coverage: float = 0.0


def build_context(
    window: CollectivesWindow,
    policy: CollectivesPolicy,
    step_time_ms: Optional[float] = None,
) -> CollectivesContext:
    n = max(1, window.n_steps)
    comm_per_step = window.totals["duration_ms"] / n
    exposed_per_step = window.totals["exposed_ms"] / n
    exposed_share = None
    comm_share = None
    if step_time_ms is not None and step_time_ms > 0:
        exposed_share = exposed_per_step / step_time_ms
        comm_share = comm_per_step / step_time_ms
    return CollectivesContext(
        window=window,
        policy=policy,
        step_time_ms=step_time_ms,
        n_steps=window.n_steps,
        comm_ms_per_step=comm_per_step,
        exposed_ms_per_step=exposed_per_step,
        overlap_efficiency=window.totals["overlap_efficiency"],
        exposed_share=exposed_share,
        comm_share=comm_share,
        coverage=min(1.0, window.n_steps / max(1, policy.full_window_steps)),
    )


def _comm_significant(ctx: CollectivesContext) -> bool:
    if ctx.comm_ms_per_step >= ctx.policy.min_comm_ms_per_step:
        return True
    return ctx.comm_share is not None and ctx.comm_share >= ctx.policy.comm_share_gate


class CommBoundRule:
    """Exposed (un-overlapped) collective time dominates the step: the
    T3 signal — comm the schedule failed to hide is pure step-time tax."""

    def evaluate(self, ctx: CollectivesContext) -> List[DiagnosticIssue]:
        p = ctx.policy
        share = ctx.exposed_share
        if share is None or share < p.exposed_share_warn:
            return []
        severity = (
            SEVERITY_CRITICAL if share >= p.exposed_share_critical else SEVERITY_WARNING
        )
        evidence: Dict[str, Any] = {
            "exposed_ms_per_step": round(ctx.exposed_ms_per_step, 3),
            "comm_ms_per_step": round(ctx.comm_ms_per_step, 3),
            "step_time_ms": round(ctx.step_time_ms, 3),
            "overlap_efficiency": round(ctx.overlap_efficiency, 4),
            "group_size": ctx.window.group_size,
        }
        return [
            DiagnosticIssue(
                kind="COMM_BOUND",
                severity=severity,
                summary=(
                    f"Exposed collective time is {share:.0%} of the step "
                    f"({ctx.exposed_ms_per_step:.1f} of "
                    f"{ctx.step_time_ms:.1f} ms/step) — the job is "
                    "communication-bound."
                ),
                action=(
                    "Hide the comm: overlap gradient sync with backward "
                    "compute (bucketed/async all-reduce), move to "
                    "reduce-scatter + all-gather sharded sync, or grow "
                    "per-step compute (batch/sequence) relative to the "
                    "payload."
                ),
                metric="exposed_comm_share",
                score=float(share),
                share_pct=float(share),
                confidence=confidence_from(
                    share, p.exposed_share_warn, coverage=ctx.coverage
                ),
                evidence=evidence,
            )
        ]


class PoorOverlapRule:
    """Meaningful comm volume with low overlap efficiency, where the
    run's own best steps (or peer ranks) prove better overlap is
    achievable — a scheduling problem, not a volume problem."""

    def evaluate(self, ctx: CollectivesContext) -> List[DiagnosticIssue]:
        p = ctx.policy
        if not _comm_significant(ctx):
            return []
        eff = ctx.overlap_efficiency
        if eff >= p.overlap_eff_warn:
            return []
        w = ctx.window
        stats = (
            vector.poor_overlap_stats(
                w.per_step, w.per_rank, p.overlap_headroom_gate
            )
            if vector.enabled()
            else None
        )
        if stats is not None:
            best_eff, median_rank_eff, lag_ranks = stats
        else:  # scalar golden-reference arm
            # headroom vs the run's own best steps: 75th percentile of
            # per-step efficiency over steps that actually communicated
            per_step_eff = [
                e
                for e, d in zip(
                    w.per_step["overlap_efficiency"], w.per_step["duration_ms"]
                )
                if d > 0.0
            ]
            best_eff = None
            if per_step_eff:
                ranked = sorted(per_step_eff)
                best_eff = ranked[min(len(ranked) - 1, int(len(ranked) * 0.75))]
            # peers: ranks overlapping much worse than the median rank
            rank_eff = {
                r: v["overlap_efficiency"] for r, v in w.per_rank.items()
            }
            lag_ranks: List[int] = []
            median_rank_eff = None
            if rank_eff:
                median_rank_eff = statistics.median(rank_eff.values())
                lag_ranks = sorted(
                    r
                    for r, v in rank_eff.items()
                    if median_rank_eff - v >= p.overlap_headroom_gate
                )
        step_headroom = (
            best_eff is not None and best_eff - eff >= p.overlap_headroom_gate
        )
        if not step_headroom and not lag_ranks:
            # uniformly poor overlap — COMM_BOUND (volume) is the story
            return []
        severity = (
            SEVERITY_CRITICAL if eff < p.overlap_eff_critical else SEVERITY_WARNING
        )
        gap = 1.0 - eff
        evidence: Dict[str, Any] = {
            "overlap_efficiency": round(eff, 4),
            "comm_ms_per_step": round(ctx.comm_ms_per_step, 3),
            "exposed_ms_per_step": round(ctx.exposed_ms_per_step, 3),
        }
        if best_eff is not None:
            evidence["best_steps_overlap_efficiency"] = round(best_eff, 4)
        if median_rank_eff is not None:
            evidence["median_rank_overlap_efficiency"] = round(median_rank_eff, 4)
        if lag_ranks:
            evidence["lagging_ranks"] = lag_ranks[:16]
        return [
            DiagnosticIssue(
                kind="POOR_OVERLAP",
                severity=severity,
                summary=(
                    f"Only {eff:.0%} of collective time is hidden behind "
                    f"compute ({ctx.comm_ms_per_step:.1f} ms/step of comm)"
                    + (
                        f"; the run's best steps reach {best_eff:.0%}"
                        if step_headroom and best_eff is not None
                        else f"; {len(lag_ranks)} rank(s) overlap far worse than the median"
                    )
                    + "."
                ),
                action=(
                    "Re-order dispatch so collectives launch before the "
                    "compute that can hide them (async sync, interleaved "
                    "microbatches); check for host-blocking barriers "
                    "between backward and the sync."
                ),
                metric="overlap_efficiency",
                score=float(gap),
                ranks=lag_ranks,
                confidence=confidence_from(
                    gap, 1.0 - p.overlap_eff_warn, coverage=ctx.coverage
                ),
                evidence=evidence,
            )
        ]


class AllreduceQuantizableRule:
    """Large, stable fp32 all-reduce payloads — the EQuARX candidate
    profile: block-wise quantized AllReduce cuts the payload ~4x for
    ~2x collective speedup with negligible quality loss."""

    def evaluate(self, ctx: CollectivesContext) -> List[DiagnosticIssue]:
        p = ctx.policy
        series = ctx.window.per_step.get("allreduce_fp32_bytes") or []
        stats = (
            vector.fp32_allreduce_stats(series) if vector.enabled() else None
        )
        if stats is not None:
            n_nz, mean_bytes, nz = stats
        else:  # scalar golden-reference arm
            nz = [float(v) for v in series if v > 0]
            n_nz = len(nz)
            mean_bytes = (sum(nz) / n_nz) if nz else 0.0
        if not n_nz or ctx.n_steps <= 0:
            return []
        share = n_nz / ctx.n_steps
        if share < p.quantizable_min_share or mean_bytes < p.quantizable_min_bytes:
            return []
        cv = (statistics.pstdev(nz) / mean_bytes) if n_nz > 1 else 0.0
        if cv > p.quantizable_cv_max:
            return []
        mib = mean_bytes / (1 << 20)
        ar = ctx.window.per_op.get("all_reduce", {})
        return [
            DiagnosticIssue(
                kind="ALLREDUCE_QUANTIZABLE",
                severity=SEVERITY_INFO,
                summary=(
                    f"fp32 all-reduce moves a stable {mib:.1f} MiB/step "
                    f"(CV {cv:.2f}) — a candidate for quantized AllReduce "
                    "(EQuARX-style block int8: ~4x fewer bytes, ~2x faster "
                    "sync)."
                ),
                action=(
                    "Evaluate quantized or mixed-precision gradient "
                    "all-reduce (bf16 or block-wise int8) — the payload is "
                    "large and step-to-step stable, the profile where "
                    "quantization error stays negligible."
                ),
                metric="allreduce_fp32_bytes_per_step",
                score=float(min(1.0, mib / 256.0)),
                confidence=confidence_from(
                    mean_bytes,
                    float(p.quantizable_min_bytes),
                    coverage=ctx.coverage,
                ),
                evidence={
                    "fp32_allreduce_mib_per_step": round(mib, 2),
                    "bytes_cv": round(cv, 4),
                    "steps_with_fp32_allreduce": len(nz),
                    "allreduce_duration_ms": round(
                        float(ar.get("duration_ms", 0.0)), 3
                    ),
                },
            )
        ]


DEFAULT_RULES = (
    CommBoundRule(),
    PoorOverlapRule(),
    AllreduceQuantizableRule(),
)
