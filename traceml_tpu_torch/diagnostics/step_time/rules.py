"""Step-time diagnostic rules, scalar arm.

Counterpart of ``traceml_tpu/diagnostics/step_time/rules.py`` without the
vectorized branches: the JAX package takes those only for a window that
carries the columnar engine's cubes (``vector.gate``), and this port's
windows carry none, so the scalar golden-reference arm is the whole rule.

Rules:

* ``InputBoundRule``    — INPUT_BOUND when the input-wait share of the
  step crosses policy thresholds on the median rank.
* ``CleanStragglerRule`` — the clean-straggler math:  in synchronous
  data-parallel training, a FAST rank's sync phase is inflated by
  waiting for the slowest rank, so raw per-phase comparison misattributes
  skew.  Discount the sync phase by the wait explainable by other ranks'
  non-sync skew::

      clean_sync_r = max(0, sync_r − max(0, max(non_sync) − non_sync_r))
      clean_step_r = non_sync_r + clean_sync_r
      score        = (max(clean_step) − median(clean_step))
                     / median(actual_step)

  fire at score ≥ 0.10; attribute to the phase whose worst-rank delta
  dominates the runner-up by ≥1.25×, else a mixed STRAGGLER.

  TPU generalization: the sync phase is ``backward`` when present
  (torch DDP — allreduce overlaps backward) else the fused ``compute``
  phase (JAX pjit — collectives live inside the compiled step).
* ``ResidualHeavyRule`` — untyped time (neither input, h2d, compute,
  …) above policy share.
* ``ComputeBoundRule``  — info-grade: the device is the bottleneck and
  healthy (share ≥ 0.85 / 0.92).
* ``CompileBoundRule``  — TPU-new: recompilation storms surface as a
  first-class verdict instead of a straggler artifact.

Kinds, severities, metrics, scores and evidence are the JAX rules'; the
actions (and the COMPILE_BOUND summary) name PyTorch/CUDA remedies, where
the JAX texts name JAX and TPU ones.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from traceml_tpu_torch.diagnostics.common import (
    SEVERITY_CRITICAL,
    SEVERITY_INFO,
    SEVERITY_WARNING,
    DiagnosticIssue,
    confidence_from,
)
from traceml_tpu_torch.diagnostics.step_time.policy import StepTimePolicy
from traceml_tpu_torch.utils.step_time_window import RESIDUAL_KEY, STEP_KEY, StepTimeWindow

_STRAGGLER_KIND_BY_PHASE = {
    "input": "INPUT_STRAGGLER",
    "h2d": "H2D_STRAGGLER",
    "residual": "RESIDUAL_STRAGGLER",
    "forward": "COMPUTE_STRAGGLER",
    "backward": "COMPUTE_STRAGGLER",
    "optimizer": "COMPUTE_STRAGGLER",
    "compute": "COMPUTE_STRAGGLER",
    "collective": "COLLECTIVE_STRAGGLER",
    "compile": "COMPILE_STRAGGLER",
    "checkpoint": "CHECKPOINT_STRAGGLER",
}


class _Ctx:
    """Evaluation context: the window + policy (+ the section's MFU
    block when model FLOPs were declared)."""

    def __init__(self, window: StepTimeWindow, policy: StepTimePolicy,
                 efficiency=None):
        self.window = window
        self.policy = policy
        self.efficiency = efficiency or None


def build_context(window: StepTimeWindow, policy: StepTimePolicy,
                  efficiency=None) -> _Ctx:
    return _Ctx(window, policy, efficiency=efficiency)


def _enough_data(ctx: _Ctx) -> bool:
    return ctx.window is not None and ctx.window.n_steps >= ctx.policy.min_steps


def _coverage(ctx: _Ctx) -> float:
    """Window fullness vs 2× the policy minimum (a window at the bare
    minimum fired legitimately but with less evidence than a full one)."""
    want = max(1, 2 * ctx.policy.min_steps)
    return min(1.0, ctx.window.n_steps / want)


class InputBoundRule:
    @staticmethod
    def _global_share(ctx: _Ctx) -> Optional[float]:
        """Input share on the LOW-quantile rank — the "globally slow
        pipeline" statistic.  The cross-rank median is contaminated by a
        single straggler rank in small worlds (2 ranks: median = the
        midpoint of healthy and straggler), which let INPUT_STRAGGLER
        degrade into INPUT_BOUND under host contention.  A genuinely
        input-bound job has a high input share on (nearly) EVERY rank,
        so the gate reads the min (≤4 ranks) / 25th percentile share
        over per-rank MEANS — the same statistic share_of_step fires
        on, so a bursty-but-global pipeline (prefetch refills every Nth
        step: median input ≈ 0 on every rank) cannot be suppressed by
        a statistic mismatch."""
        w = ctx.window
        shares = []
        for r in w.ranks:
            avg = w.rank_windows[r].averages
            step = avg.get(STEP_KEY, 0.0)
            if step > 0:
                shares.append(avg.get("input", 0.0) / step)
        if not shares:
            return None
        shares.sort()
        if len(shares) <= 4:
            return shares[0]
        return shares[max(0, (len(shares) - 1) // 4)]

    def evaluate(self, ctx: _Ctx) -> List[DiagnosticIssue]:
        if not _enough_data(ctx):
            return []
        share = ctx.window.share_of_step("input")
        if share is None:
            return []
        p = ctx.policy
        if share < p.input_share_warn:
            return []
        gate = self._global_share(ctx)
        if gate is not None and gate < p.input_share_warn * 0.5:
            # the median-rank share clears the bar only because one
            # straggler rank drags it up — that is the straggler rule's
            # verdict, not a global input problem
            return []
        severity = (
            SEVERITY_CRITICAL if share >= p.input_share_critical else SEVERITY_WARNING
        )
        m = ctx.window.metric("input")
        return [
            DiagnosticIssue(
                kind="INPUT_BOUND",
                severity=severity,
                summary=(
                    f"Input pipeline consumes {share * 100:.0f}% of the median "
                    f"step ({m.median_ms:.1f} ms of "
                    f"{ctx.window.metric(STEP_KEY).median_ms:.1f} ms)."
                ),
                action=(
                    "Speed up the input pipeline: more DataLoader workers "
                    "(num_workers) with pin_memory=True, cache or pre-tokenize "
                    "the dataset, overlap host input with device compute "
                    "(non_blocking=True copies from pinned memory, prefetch "
                    "the next batch)."
                ),
                metric="input_share",
                phase="input",
                score=share,
                share_pct=share,
                confidence=confidence_from(
                    share, p.input_share_warn, coverage=_coverage(ctx)
                ),
                ranks=list(ctx.window.ranks),
                evidence={
                    "input_median_ms": m.median_ms,
                    "step_median_ms": ctx.window.metric(STEP_KEY).median_ms,
                    "clock": ctx.window.clock,
                },
            )
        ]


class CleanStragglerRule:
    def _sync_phase(self, ctx: _Ctx) -> Optional[str]:
        # a first-class collective phase IS where sync waits concentrate
        # (explicit wrap_collective / torch-xla mark_step); otherwise
        # backward (torch DDP overlap) else the fused compute (JAX pjit)
        if "collective" in ctx.window.phases_present:
            return "collective"
        if "backward" in ctx.window.phases_present:
            return "backward"
        if "compute" in ctx.window.phases_present:
            return "compute"
        return None

    @staticmethod
    def _clean_math(w, sync_phase: Optional[str], stat_name: str):
        """The clean-straggler pipeline under one per-rank statistic
        (``"medians"`` or ``"averages"``); returns (score, worst_rank,
        clean_step, clean_sync, step_stat) or None.

        Both statistics run and the STRONGER score wins: medians are
        contention-robust (a host burst inflates a few steps' means
        while the median holds — the round-2 flake), but means are the
        only statistic that can SEE spiky per-rank pathologies (a rank
        checkpointing/recompiling on 1-in-10 steps has median ≈ healthy;
        cf. CompileBoundRule's means-over-medians rationale)."""
        step_stat = {
            r: getattr(w.rank_windows[r], stat_name)[STEP_KEY] for r in w.ranks
        }
        if not step_stat:  # empty-window early-out (satellite guard)
            return None
        sync_stat = {
            r: (
                getattr(w.rank_windows[r], stat_name).get(sync_phase, 0.0)
                if sync_phase
                else 0.0
            )
            for r in w.ranks
        }
        non_sync = {r: max(0.0, step_stat[r] - sync_stat[r]) for r in w.ranks}
        max_non_sync = max(non_sync.values())
        clean_sync = {
            r: max(0.0, sync_stat[r] - max(0.0, max_non_sync - non_sync[r]))
            for r in w.ranks
        }
        clean_step = {r: non_sync[r] + clean_sync[r] for r in w.ranks}
        med_clean = statistics.median(clean_step.values())
        worst_rank = max(clean_step, key=lambda r: clean_step[r])
        med_actual = statistics.median(step_stat.values())
        if med_actual <= 0:
            return None
        score = (clean_step[worst_rank] - med_clean) / med_actual
        return score, worst_rank, clean_step, clean_sync, step_stat

    def evaluate(self, ctx: _Ctx) -> List[DiagnosticIssue]:
        w = ctx.window
        if not _enough_data(ctx) or len(w.ranks) < 2:
            return []
        p = ctx.policy
        step_m = w.metric(STEP_KEY)
        if step_m is None or step_m.median_ms <= 0:
            return []
        sync_phase = self._sync_phase(ctx)
        candidates = [
            (self._clean_math(w, sync_phase, stat), stat)
            for stat in ("medians", "averages")
        ]
        candidates = [(c, s) for c, s in candidates if c is not None]
        if not candidates:
            return []
        (score, worst_rank, clean_step, clean_sync, step_avg), stat_name = max(
            candidates, key=lambda cs: cs[0][0]
        )
        if score < p.straggler_score_fire:
            return []
        # statistic agreement: did BOTH per-rank statistics clear the
        # bar, or only the winner?  (confidence ingredient)
        both_fired = all(
            c[0] >= p.straggler_score_fire for c, _ in candidates
        ) and len(candidates) == 2

        # Component attribution on the worst rank: per-phase delta vs the
        # cross-rank median, with the sync phase replaced by its clean
        # form — read from the SAME statistic that produced the score.
        keys = list(w.phases_present) + [RESIDUAL_KEY]
        deltas: Dict[str, float] = {}
        for key in keys:
            per_rank = {
                r: (
                    clean_sync[r]
                    if key == sync_phase
                    else getattr(w.rank_windows[r], stat_name).get(key, 0.0)
                )
                for r in w.ranks
            }
            med = statistics.median(per_rank.values())
            deltas[key] = max(0.0, per_rank[worst_rank] - med)
        ordered = sorted(deltas.items(), key=lambda kv: -kv[1])
        kind = "STRAGGLER"
        dominant_phase: Optional[str] = None
        if ordered and ordered[0][1] > 0:
            top_key, top_delta = ordered[0]
            second = ordered[1][1] if len(ordered) > 1 else 0.0
            if second <= 0 or top_delta / max(second, 1e-9) >= p.straggler_dominance:
                kind = _STRAGGLER_KIND_BY_PHASE.get(top_key, "STRAGGLER")
                dominant_phase = top_key
        severity = SEVERITY_CRITICAL if score >= 0.25 else SEVERITY_WARNING
        phase_label = dominant_phase or "mixed"
        return [
            DiagnosticIssue(
                kind=kind,
                severity=severity,
                summary=(
                    f"Rank {worst_rank} runs {score * 100:.0f}% behind the "
                    f"median step after discounting sync waits "
                    f"(dominant component: {phase_label})."
                ),
                action=(
                    "Inspect the slow rank's host (input sharding, CPU "
                    "contention, thermal) and its chip; a persistent single-"
                    "rank lag gates every synchronous step."
                ),
                metric="clean_straggler_score",
                phase=dominant_phase,
                score=score,
                skew_pct=score,
                confidence=confidence_from(
                    score, p.straggler_score_fire,
                    coverage=_coverage(ctx), agreement=both_fired,
                ),
                ranks=[worst_rank],
                evidence={
                    "clean_step_ms": {str(r): v for r, v in clean_step.items()},
                    # per-rank step statistic that produced the score —
                    # see "statistic" for whether these are medians or
                    # means (they diverge under bursty load)
                    "step_stat_ms": {str(r): v for r, v in step_avg.items()},
                    "statistic": (
                        "median" if stat_name == "medians" else "mean"
                    ),
                    "sync_phase": sync_phase,
                    "component_deltas_ms": {k: v for k, v in ordered[:4]},
                    "clock": w.clock,
                },
            )
        ]


class ResidualHeavyRule:
    def evaluate(self, ctx: _Ctx) -> List[DiagnosticIssue]:
        if not _enough_data(ctx):
            return []
        share = ctx.window.share_of_step(RESIDUAL_KEY)
        if share is None:
            return []
        p = ctx.policy
        if share < p.residual_share_warn:
            return []
        severity = (
            SEVERITY_CRITICAL
            if share >= p.residual_share_critical
            else SEVERITY_WARNING
        )
        return [
            DiagnosticIssue(
                kind="RESIDUAL_HEAVY",
                severity=severity,
                summary=(
                    f"{share * 100:.0f}% of the step is unattributed time "
                    "(outside input/h2d/compute/optimizer phases)."
                ),
                action=(
                    "Look for untimed host work between phases: logging, "
                    "metric syncs (device→host reads such as .item() or "
                    ".cpu()), checkpoint writes, Python overhead; also check "
                    "for hidden host-device round trips forcing early sync "
                    "(torch.cuda.synchronize, printing a CUDA tensor)."
                ),
                metric="residual_share",
                phase=RESIDUAL_KEY,
                score=share,
                share_pct=share,
                confidence=confidence_from(
                    share, p.residual_share_warn, coverage=_coverage(ctx)
                ),
                ranks=list(ctx.window.ranks),
            )
        ]


def _compute_share(window) -> Optional[float]:
    """The step's share in device compute: the ``compute`` phase of a
    wrapped step function, or the ``forward``, ``backward`` and
    ``optimizer`` phases of a patched one, summed.  None without any."""
    compute_keys = [
        k for k in ("compute", "forward", "backward", "optimizer")
        if k in window.phases_present
    ]
    if not compute_keys:
        return None
    return sum(window.share_of_step(k) or 0.0 for k in compute_keys)


class ComputeBoundRule:
    def evaluate(self, ctx: _Ctx) -> List[DiagnosticIssue]:
        if not _enough_data(ctx):
            return []
        share = _compute_share(ctx.window)
        if share is None:
            return []
        p = ctx.policy
        if share < p.compute_share_info:
            return []
        return [
            DiagnosticIssue(
                kind="COMPUTE_BOUND",
                severity=SEVERITY_INFO,
                summary=(
                    f"Device compute accounts for {share * 100:.0f}% of the "
                    "step — the accelerator is the bottleneck (healthy for "
                    "a well-fed training job)."
                ),
                action=(
                    "To go faster: larger per-GPU batch, bf16 autocast and "
                    "TF32 for f32 matmuls, activation checkpointing "
                    "(torch.utils.checkpoint) tuned to fit that batch, or "
                    "scale out over more GPUs."
                ),
                metric="compute_share",
                phase="compute",
                score=share,
                share_pct=share,
                ranks=list(ctx.window.ranks),
            )
        ]


class CompileBoundRule:
    """Recompilation eating wall-clock."""

    def evaluate(self, ctx: _Ctx) -> List[DiagnosticIssue]:
        w = ctx.window
        if w is None or "compile" not in w.phases_present:
            return []
        # Warmup compiles are expected — only RE-compilation is
        # pathological.  Warmup = compile events within the first
        # ``compile_warmup_steps`` ABSOLUTE steps of the run (the window
        # carries absolute step ids, so this stays correct after warmup
        # scrolls out of a live window).  Share is computed over MEANS
        # (not medians) because recompiles are spiky: a few huge steps,
        # most zero.
        step = w.metric(STEP_KEY)
        if step is None or step.mean_ms <= 0:
            return []
        p = ctx.policy
        recompile_ms_per_rank = []
        n_compile_steps = 0
        for rw in w.rank_windows.values():
            series = rw.series.get("compile", [])
            recompile_total = 0.0
            for step_id, v in zip(rw.steps, series):
                if v > 0 and step_id > p.compile_warmup_steps:
                    recompile_total += v
                    n_compile_steps += 1
            recompile_ms_per_rank.append(
                recompile_total / max(1, len(series))
            )
        if n_compile_steps == 0 or not recompile_ms_per_rank:
            return []
        mean_recompile = sum(recompile_ms_per_rank) / len(
            recompile_ms_per_rank
        )
        share = mean_recompile / step.mean_ms
        if share < p.compile_share_warn:
            return []
        severity = (
            SEVERITY_CRITICAL
            if share >= p.compile_share_critical
            else SEVERITY_WARNING
        )
        return [
            DiagnosticIssue(
                kind="COMPILE_BOUND",
                severity=severity,
                summary=(
                    f"Re-compilation consumes {share * 100:.0f}% of mean "
                    f"step time across the window ({n_compile_steps} steps "
                    "recompiled after warmup)."
                ),
                action=(
                    "Eliminate recompiles: pad/bucket batch shapes to a fixed "
                    "set, mark dynamic dimensions "
                    "(torch._dynamo.mark_dynamic), remove graph breaks and "
                    "Python-value-dependent branches under torch.compile "
                    "(TORCH_LOGS=recompiles,graph_breaks names them), check "
                    "for dtype or device churn between steps."
                ),
                metric="compile_share",
                phase="compile",
                score=share,
                share_pct=share,
                confidence=confidence_from(
                    share, p.compile_share_warn, coverage=_coverage(ctx)
                ),
                ranks=list(w.ranks),
                evidence={"compile_steps": n_compile_steps},
            )
        ]


class LowDeviceOccupancyRule:
    """LOW_DEVICE_UTILIZATION — the chip is mostly idle.

    TPU stand-in for the reference's GPUUtilizationRule
    (reference: diagnostics/system/rules.py:22-120): libtpu exposes no
    duty-cycle counter here, but occupancy — Σ phase device durations /
    Σ host(step envelope) over the window, see
    utils/step_time_window.py:row_occupancy_parts — is the same signal
    derived from the timing core.  Fires alongside whatever explains
    the idleness (INPUT_BOUND, COMPILE_BOUND); the composer ranks them.
    """

    def evaluate(self, ctx: _Ctx) -> List[DiagnosticIssue]:
        if not _enough_data(ctx):
            return []
        w = ctx.window
        occ = w.median_occupancy
        if occ is None or occ >= ctx.policy.occupancy_warn:
            return []
        severity = (
            SEVERITY_CRITICAL
            if occ <= ctx.policy.occupancy_critical
            else SEVERITY_WARNING
        )
        worst_rank = min(w.occupancy_by_rank, key=lambda r: w.occupancy_by_rank[r])
        return [
            DiagnosticIssue(
                kind="LOW_DEVICE_UTILIZATION",
                severity=severity,
                summary=(
                    f"The device is busy only {occ * 100:.0f}% of wall clock "
                    f"(median rank; worst rank {worst_rank} at "
                    f"{w.occupancy_by_rank[worst_rank] * 100:.0f}%)."
                ),
                action=(
                    "The chip is idle most of the step: overlap input with "
                    "compute (prefetch), batch more work per dispatch, and "
                    "check the phase table for what eats the host time."
                ),
                metric="device_occupancy",
                score=1.0 - occ,
                share_pct=occ,
                # inverted threshold (fires BELOW the bar): the margin
                # ratio is warn/occ − 1, so feed (warn, occ) in
                confidence=confidence_from(
                    ctx.policy.occupancy_warn, max(occ, 1e-6),
                    coverage=_coverage(ctx),
                ),
                ranks=[worst_rank],
                evidence={
                    "occupancy_by_rank": {
                        str(r): round(v, 4)
                        for r, v in w.occupancy_by_rank.items()
                    }
                },
            )
        ]


class LowMfuRule:
    """TPU-new: the chip is the bottleneck AND the program wastes it.

    Occupancy answers "is the chip busy?"; MFU answers "is the busy
    time worth anything?".  A compute-dominated step at 8% MFU means
    the MXU starves — tiny/mis-tiled matmuls, f32 where bf16 would do,
    fusion breaks — which no amount of input-pipeline work will fix.
    Gated on: model FLOPs declared, a known chip peak, device clock,
    and compute share ≥ ``mfu_compute_gate`` (an input-bound job's low
    MFU is the input's fault; that verdict already exists).
    """

    def evaluate(self, ctx: _Ctx) -> List[DiagnosticIssue]:
        eff = ctx.efficiency
        if not _enough_data(ctx) or not eff:
            return []
        mfu = eff.get("mfu_median")
        if mfu is None or ctx.window.clock != "device":
            return []
        # the JAX rule reads the "compute" phase alone, so it never fires
        # on a step timed as forward/backward/optimizer; the port reads
        # the compute share as ComputeBoundRule does
        share = _compute_share(ctx.window)
        p = ctx.policy
        if share is None or share < p.mfu_compute_gate:
            return []
        if mfu >= p.mfu_moderate:
            return []
        severity = SEVERITY_WARNING if mfu < p.mfu_low_warn else SEVERITY_INFO
        kind = "LOW_MFU" if mfu < p.mfu_low_warn else "MODERATE_MFU"
        return [
            DiagnosticIssue(
                kind=kind,
                severity=severity,
                summary=(
                    f"Model FLOPs utilization is {mfu * 100:.0f}% "
                    f"({eff.get('achieved_tflops_median', 0):.1f} of "
                    f"{eff.get('peak_tflops', 0):.0f} TFLOP/s peak on "
                    f"{eff.get('device_kind')}) while compute dominates the "
                    f"step ({share * 100:.0f}%) — the chip is busy but the "
                    "program wastes it."
                ),
                action=(
                    "Feed the tensor cores: bf16 autocast (torch.autocast) "
                    "and TF32 for f32 matmuls "
                    "(torch.backends.cuda.matmul.fp32_precision = \"tf32\"), "
                    "larger per-GPU batch/seq so GEMM tiles fill the SMs, "
                    "find tiny kernels and launch gaps with torch.profiler, "
                    "consider activation checkpointing "
                    "(torch.utils.checkpoint) to enable bigger batches."
                ),
                metric="mfu",
                phase="compute",
                score=1.0 - mfu,
                share_pct=mfu,
                # inverted threshold (fires BELOW the moderate bar)
                confidence=confidence_from(
                    p.mfu_moderate, max(mfu, 1e-6),
                    coverage=_coverage(ctx),
                ),
                ranks=list(ctx.window.ranks),
                evidence={
                    "mfu_median": mfu,
                    "achieved_tflops_median": eff.get("achieved_tflops_median"),
                    "peak_tflops": eff.get("peak_tflops"),
                    "flops_source": eff.get("flops_source"),
                    "compute_share": share,
                },
            )
        ]


DEFAULT_RULES = (
    CleanStragglerRule(),
    InputBoundRule(),
    CompileBoundRule(),
    ResidualHeavyRule(),
    LowDeviceOccupancyRule(),
    LowMfuRule(),
    ComputeBoundRule(),
)
