"""Step-memory rules, scalar arm.

Counterpart of ``traceml_tpu/diagnostics/step_memory/rules.py`` without
the columnar context build and the vectorized imbalance gate (the JAX
package's scalar branch is its golden reference).  Rule texts are kept
verbatim, as in the step-time pack.

Context shape: per-rank per-device :class:`MemorySeries` (sorted step
series of ``{step, current_bytes, step_peak_bytes, limit_bytes}``) built
from row dicts.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Mapping, Optional, Sequence

from traceml_tpu_torch.analytics.trends.core import (
    compute_trend_evidence,
    compute_window_trend,
    summarize_across,
)
from traceml_tpu_torch.diagnostics.common import (
    SEVERITY_CRITICAL,
    SEVERITY_WARNING,
    DiagnosticIssue,
    confidence_from,
)
from traceml_tpu_torch.diagnostics.step_memory.policy import DEFAULT_POLICY, StepMemoryPolicy
from traceml_tpu_torch.utils.columnar import MemorySeries
from traceml_tpu_torch.utils.formatting import fmt_bytes


@dataclasses.dataclass
class MemoryContext:
    # (rank, device_id) → sorted columnar series
    series: Dict[tuple, MemorySeries]
    policy: StepMemoryPolicy = DEFAULT_POLICY
    # per-context creep-evidence cache: both creep rules share one scan
    creep_cache: Optional[List["_CreepEvidence"]] = None

    @property
    def ranks(self) -> List[int]:
        return sorted({r for r, _ in self.series})


def build_memory_context(
    rank_rows: Mapping[int, Sequence[Mapping[str, Any]]],
    policy: StepMemoryPolicy = DEFAULT_POLICY,
) -> MemoryContext:
    groups: Dict[tuple, List[Mapping[str, Any]]] = {}
    for rank, rows in rank_rows.items():
        for row in rows:
            key = (int(rank), int(row.get("device_id", 0)))
            groups.setdefault(key, []).append(row)
    series = {
        key: MemorySeries.from_rows(key[0], key[1], rows)
        for key, rows in groups.items()
    }
    return MemoryContext(series=series, policy=policy)


class HighPressureRule:
    def evaluate(self, ctx: MemoryContext) -> List[DiagnosticIssue]:
        issues = []
        p = ctx.policy
        for (rank, dev), s in ctx.series.items():
            if not len(s):
                continue
            pressure = s.latest_pressure()
            if pressure is None or pressure < p.pressure_warn:
                continue
            severity = (
                SEVERITY_CRITICAL
                if pressure >= p.pressure_critical
                else SEVERITY_WARNING
            )
            last_sp, last_cur, last_lim = s.last_values()
            issues.append(
                DiagnosticIssue(
                    kind="HIGH_MEMORY_PRESSURE",
                    severity=severity,
                    summary=(
                        f"Rank {rank} device {dev} at {pressure * 100:.0f}% of "
                        f"HBM capacity "
                        f"({fmt_bytes(last_sp or last_cur)}"
                        f" / {fmt_bytes(last_lim)})."
                    ),
                    action=(
                        "Reduce per-chip footprint: smaller microbatch, "
                        "jax.checkpoint/remat, optimizer-state sharding "
                        "(ZeRO-style), bf16 activations, or shard the model "
                        "further."
                    ),
                    metric="memory_pressure",
                    score=pressure,
                    share_pct=pressure,
                    # pressure is a DIRECT capacity read, not a
                    # statistic over a window — margin alone drives it
                    confidence=confidence_from(pressure, p.pressure_warn),
                    ranks=[rank],
                    evidence={"device_id": dev},
                )
            )
        return issues


class ImbalanceRule:
    def evaluate(self, ctx: MemoryContext) -> List[DiagnosticIssue]:
        p = ctx.policy
        # latest used bytes per rank (max over that rank's devices)
        per_rank: Dict[int, float] = {}
        per_rank_pressure: Dict[int, float] = {}
        for (rank, _dev), s in ctx.series.items():
            if not len(s):
                continue
            per_rank[rank] = max(per_rank.get(rank, 0.0), s.last_used())
            pres = s.latest_pressure()
            if pres is not None:
                per_rank_pressure[rank] = max(
                    per_rank_pressure.get(rank, 0.0), pres
                )
        if len(per_rank) < 2:
            return []
        med = statistics.median(per_rank.values())
        worst_rank = max(per_rank, key=lambda r: per_rank[r])
        skew = ((per_rank[worst_rank] - med) / med) if med > 0 else 0.0
        if med <= 0:
            return []
        if skew < p.imbalance_warn:
            return []
        # only interesting when somebody is actually under pressure
        if max(per_rank_pressure.values(), default=0.0) < p.imbalance_pressure_gate:
            return []
        severity = (
            SEVERITY_CRITICAL if skew >= p.imbalance_critical else SEVERITY_WARNING
        )
        return [
            DiagnosticIssue(
                kind="MEMORY_IMBALANCE",
                severity=severity,
                summary=(
                    f"Rank {worst_rank} holds {skew * 100:.0f}% more device "
                    f"memory than the median rank "
                    f"({fmt_bytes(per_rank[worst_rank])} vs {fmt_bytes(med)})."
                ),
                action=(
                    "Check sharding balance: uneven parameter/optimizer "
                    "partitions, rank-0-only buffers (eval/logging replicas), "
                    "or padding asymmetries."
                ),
                metric="memory_skew",
                score=skew,
                skew_pct=skew,
                confidence=confidence_from(skew, p.imbalance_warn),
                ranks=[worst_rank],
                evidence={"per_rank_bytes": {str(r): v for r, v in per_rank.items()}},
            )
        ]


@dataclasses.dataclass
class _CreepEvidence:
    rank: int
    dev: int
    banded: Any
    windowed: Any
    confirmed: bool
    cluster_wide: bool


def _collect_creep_evidence(ctx: MemoryContext) -> List[_CreepEvidence]:
    """Shared creep screen for the Early/Confirmed rules: ≥800-row gate,
    banded growth + windowed still-rising slope, peak-pullback recovery
    veto, worst/median cross-rank split."""
    if ctx.creep_cache is not None:
        return ctx.creep_cache
    p = ctx.policy
    candidates: List[_CreepEvidence] = []
    growth_by_key: Dict[tuple, float] = {}
    banded_by_key: Dict[tuple, Any] = {}
    window_by_key: Dict[tuple, Any] = {}
    for (rank, dev), s in ctx.series.items():
        # the row gate applies to EVERYTHING, including the cluster-wide
        # median — a freshly restarted rank's warmup growth over 60 rows
        # must not vote that the whole cluster is creeping
        if len(s) < p.creep_min_steps:
            continue
        series = s.current_list()
        banded = compute_trend_evidence(series)
        windowed = compute_window_trend(
            series,
            short_n=p.creep_short_window,
            long_n=p.creep_long_window,
            pullback_tolerance=p.creep_pullback_max,
        )
        if banded is None or windowed is None:
            continue
        growth_by_key[(rank, dev)] = banded.growth_pct
        banded_by_key[(rank, dev)] = banded
        window_by_key[(rank, dev)] = windowed
    growth_summary = summarize_across(growth_by_key)
    median_growing = (
        growth_summary is not None
        and growth_summary.median >= p.creep_median_growth_pct
    )
    for key, banded in banded_by_key.items():
        rank, dev = key
        windowed = window_by_key[key]
        if (
            banded.delta < p.creep_min_delta_bytes
            or banded.growth_pct < p.creep_min_growth_pct
            or windowed.slope_pct_per_100 < p.creep_min_slope_pct_per_100
            or windowed.recovered  # allocator pulled back — sawtooth, not leak
        ):
            continue
        confirmed = (
            banded.delta >= p.creep_confirmed_delta_bytes
            and banded.monotonic_band_growth
            and windowed.trend_pct > 0  # STILL rising in the tail
        )
        candidates.append(
            _CreepEvidence(
                rank=rank,
                dev=dev,
                banded=banded,
                windowed=windowed,
                confirmed=confirmed,
                cluster_wide=median_growing,
            )
        )
    ctx.creep_cache = candidates
    return candidates


_CREEP_ACTION = (
    "Hunt Python-side references to device arrays (growing metric lists, "
    "retained batches), check for per-step recompiles creating executables, "
    "and confirm donated buffers are actually donated."
)


def _creep_issue(
    c: _CreepEvidence, kind: str, severity: str,
    growth_warn: float = DEFAULT_POLICY.creep_min_growth_pct,
) -> DiagnosticIssue:
    scope = "cluster-wide (median rank is growing too)" if c.cluster_wide else (
        f"rank-local (rank {c.rank} only)"
    )
    return DiagnosticIssue(
        kind=kind,
        severity=severity,
        summary=(
            f"Rank {c.rank} device {c.dev} memory grew "
            f"{fmt_bytes(c.banded.delta)} (+{c.banded.growth_pct * 100:.1f}%) "
            f"over {c.banded.n} rows — {scope}"
            + (
                "; sustained and still rising, likely a leak."
                if kind == "MEMORY_CREEP_CONFIRMED"
                else "."
            )
        ),
        action=_CREEP_ACTION,
        metric="memory_creep",
        score=c.banded.growth_pct,
        # CONFIRMED required two independent trend engines to agree
        # plus monotone bands — that IS the agreement signal; EARLY
        # passed the screen only
        confidence=confidence_from(
            c.banded.growth_pct, growth_warn,
            agreement=(kind == "MEMORY_CREEP_CONFIRMED"),
        ),
        ranks=[c.rank],
        evidence={
            "device_id": c.dev,
            "trend": c.banded.to_dict(),
            "window": c.windowed.to_dict(),
            "cluster_wide": c.cluster_wide,
        },
    )


class CreepEarlyRule:
    """MEMORY_CREEP_EARLY — the screen passed but the confirmed bars
    (≥1 GiB, monotonic, still rising) have not been met yet."""

    def evaluate(self, ctx: MemoryContext) -> List[DiagnosticIssue]:
        return [
            _creep_issue(c, "MEMORY_CREEP_EARLY", SEVERITY_WARNING,
                         ctx.policy.creep_min_growth_pct)
            for c in _collect_creep_evidence(ctx)
            if not c.confirmed
        ]


class CreepConfirmedRule:
    """MEMORY_CREEP_CONFIRMED — large, monotonic, and still rising in
    the tail window."""

    def evaluate(self, ctx: MemoryContext) -> List[DiagnosticIssue]:
        return [
            _creep_issue(c, "MEMORY_CREEP_CONFIRMED", SEVERITY_CRITICAL,
                         ctx.policy.creep_min_growth_pct)
            for c in _collect_creep_evidence(ctx)
            if c.confirmed
        ]


DEFAULT_RULES = (
    HighPressureRule(),
    ImbalanceRule(),
    CreepEarlyRule(),
    CreepConfirmedRule(),
)
