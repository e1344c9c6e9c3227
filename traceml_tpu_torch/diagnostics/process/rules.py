"""Per-process rules.

Counterpart of ``traceml_tpu/diagnostics/process/rules.py``: the same
policy, thresholds, kinds, severities, metrics and scores.  The JAX
package's DEVICE_MEMORY_OVERHANG (allocator peak far above current bytes)
reads the caching allocator's counters here.  Summaries say GPU where the
JAX texts say chip, and the actions name PyTorch/CUDA remedies.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Mapping, Sequence

from traceml_tpu_torch.diagnostics.common import (
    confidence_from,
    SEVERITY_CRITICAL,
    SEVERITY_WARNING,
    DiagnosticIssue,
)
from traceml_tpu_torch.utils.formatting import fmt_bytes


@dataclasses.dataclass(frozen=True)
class ProcessPolicy:
    rss_warn_bytes: int = 48 * 1024**3
    rss_critical_bytes: int = 96 * 1024**3
    # per-process CPU tiers (psutil counts per-core: 400 == 4 cores busy)
    # (reference: process/rules.py:35-347 High/VeryHigh CPU tiers)
    cpu_warn_pct: float = 90.0 * 4
    cpu_critical_pct: float = 90.0 * 8
    device_mem_skew_warn: float = 0.20
    device_mem_skew_critical: float = 0.30
    skew_pressure_gate: float = 0.5
    overhang_ratio: float = 2.0  # peak / current
    overhang_min_frac: float = 0.30  # peak ≥ 30% of capacity


DEFAULT_POLICY = ProcessPolicy()


@dataclasses.dataclass
class ProcessContext:
    # global_rank → process rows
    procs: Dict[int, List[Dict[str, Any]]]
    # (global_rank, device_id) → device rows
    devices: Dict[tuple, List[Dict[str, Any]]]
    policy: ProcessPolicy = DEFAULT_POLICY


def build_process_context(
    proc_rows: Mapping[int, Sequence[Mapping[str, Any]]],
    device_rows: Mapping[tuple, Sequence[Mapping[str, Any]]],
    policy: ProcessPolicy = DEFAULT_POLICY,
) -> ProcessContext:
    return ProcessContext(
        procs={int(k): list(v) for k, v in proc_rows.items()},
        devices={k: list(v) for k, v in device_rows.items()},
        policy=policy,
    )


class HighProcessRSSRule:
    def evaluate(self, ctx: ProcessContext) -> List[DiagnosticIssue]:
        issues = []
        p = ctx.policy
        for rank, rows in ctx.procs.items():
            if not rows:
                continue
            rss = rows[-1].get("rss_bytes")
            if not rss or rss < p.rss_warn_bytes:
                continue
            severity = (
                SEVERITY_CRITICAL if rss >= p.rss_critical_bytes else SEVERITY_WARNING
            )
            issues.append(
                DiagnosticIssue(
                    kind="HIGH_PROCESS_RSS",
                    severity=severity,
                    summary=f"Rank {rank} process RSS is {fmt_bytes(rss)}.",
                    action=(
                        "Host memory in the training process: shrink host-side "
                        "caches, avoid retaining numpy copies of device data."
                    ),
                    metric="process_rss",
                    score=float(rss),
                    ranks=[rank],
                )
            )
        return issues


class RankDeviceMemoryImbalanceRule:
    def evaluate(self, ctx: ProcessContext) -> List[DiagnosticIssue]:
        p = ctx.policy
        per_rank: Dict[int, float] = {}
        pressure = 0.0
        for (rank, _dev), rows in ctx.devices.items():
            if not rows:
                continue
            last = rows[-1]
            used = float(last.get("memory_used_bytes") or 0)
            per_rank[rank] = per_rank.get(rank, 0.0) + used
            total = last.get("memory_total_bytes")
            if used and total:
                pressure = max(pressure, used / float(total))
        if len(per_rank) < 2 or pressure < p.skew_pressure_gate:
            return []
        med = statistics.median(per_rank.values())
        if med <= 0:
            return []
        worst = max(per_rank, key=lambda r: per_rank[r])
        skew = (per_rank[worst] - med) / med
        if skew < p.device_mem_skew_warn:
            return []
        severity = (
            SEVERITY_CRITICAL
            if skew >= p.device_mem_skew_critical
            else SEVERITY_WARNING
        )
        return [
            DiagnosticIssue(
                kind="RANK_DEVICE_MEMORY_IMBALANCE",
                severity=severity,
                summary=(
                    f"Rank {worst} uses {skew * 100:.0f}% more device memory "
                    f"than the median rank."
                ),
                action="Check sharding spec symmetry and rank-0-only buffers.",
                metric="process_device_mem_skew",
                score=skew,
                confidence=confidence_from(skew, p.device_mem_skew_warn),
                skew_pct=skew,
                ranks=[worst],
            )
        ]


class DeviceMemoryOverhangRule:
    def evaluate(self, ctx: ProcessContext) -> List[DiagnosticIssue]:
        p = ctx.policy
        issues = []
        for (rank, dev), rows in ctx.devices.items():
            if not rows:
                continue
            last = rows[-1]
            cur = float(last.get("memory_used_bytes") or 0)
            peak = float(last.get("memory_peak_bytes") or 0)
            total = last.get("memory_total_bytes")
            if not total or cur <= 0 or peak <= 0:
                continue
            if peak / cur >= p.overhang_ratio and peak / float(total) >= p.overhang_min_frac:
                issues.append(
                    DiagnosticIssue(
                        kind="DEVICE_MEMORY_OVERHANG",
                        severity=SEVERITY_WARNING,
                        summary=(
                            f"Rank {rank} GPU {dev}: allocator peak "
                            f"{fmt_bytes(peak)} is ≥{p.overhang_ratio:.0f}× the "
                            f"steady-state {fmt_bytes(cur)} — a transient "
                            "allocation spike dominates the footprint."
                        ),
                        action=(
                            "Find the spike (often eval/checkpoint or the "
                            "first step's allocations) and shave it: "
                            "activation checkpointing "
                            "(torch.utils.checkpoint) of the spiky "
                            "computation, or stage it; "
                            "torch.cuda.empty_cache() then returns the "
                            "cached blocks."
                        ),
                        metric="device_mem_overhang",
                        score=peak / cur,
                        ranks=[rank],
                        evidence={"device_id": dev},
                    )
                )
        return issues


class HighProcessCPURule:
    """HIGH_PROCESS_CPU — a training process burning many host cores
    (reference: process/rules.py:35-347 with VeryHigh tier).  Uses a
    recent mean so one psutil spike doesn't fire it."""

    def evaluate(self, ctx: ProcessContext) -> List[DiagnosticIssue]:
        issues = []
        p = ctx.policy
        for rank, rows in ctx.procs.items():
            vals = [
                float(r["cpu_pct"])
                for r in rows[-30:]
                if r.get("cpu_pct") is not None
            ]
            if not vals:
                continue
            cpu = statistics.mean(vals)
            if cpu < p.cpu_warn_pct:
                continue
            severity = (
                SEVERITY_CRITICAL if cpu >= p.cpu_critical_pct else SEVERITY_WARNING
            )
            issues.append(
                DiagnosticIssue(
                    kind="HIGH_PROCESS_CPU",
                    severity=severity,
                    summary=(
                        f"Rank {rank} process burns {cpu:.0f}% CPU "
                        f"(~{cpu / 100:.1f} cores, recent mean)."
                    ),
                    action=(
                        "A compute-hungry training process starves its own "
                        "dataloader workers and the dispatch thread: move "
                        "preprocessing into workers, check for busy-wait "
                        "loops, cap intra-op threads."
                    ),
                    metric="process_cpu_pct",
                    score=cpu / 100.0,
                    ranks=[rank],
                )
            )
        return issues


DEFAULT_RULES = (
    HighProcessRSSRule(),
    HighProcessCPURule(),
    RankDeviceMemoryImbalanceRule(),
    DeviceMemoryOverhangRule(),
)
