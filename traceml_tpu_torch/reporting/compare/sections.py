"""Per-section comparers.

Counterpart of ``traceml_tpu/reporting/compare/sections.py`` (copied),
against the final-summary schema both packages write.  The
``collectives`` and ``serving`` sections have no comparer, as in JAX.

Each comparer consumes the same section from two ``final_summary.json``
payloads and returns a :class:`SectionComparison`:

* ``status`` — ``OK`` (both sides present), ``MISSING_BASELINE`` /
  ``MISSING_CANDIDATE`` (one side absent or NO_DATA), ``NO_DATA``
  (neither side has the section), ``INSUFFICIENT`` (present but the
  window is too small to trust);
* ``metrics`` — named {baseline, candidate, delta, delta_rel,
  significance} rows, per-metric tiers from the shared policy;
* ``findings`` — ranked finding dicts feeding the verdict ladder;
* ``per_rank`` — per-rank (or per-node) delta rows for the renderers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from traceml_tpu_torch.reporting.compare.policy import (
    DEFAULT_POLICY,
    ComparePolicy,
    classify,
    diagnosis_rank,
)
from traceml_tpu_torch.utils.formatting import fmt_bytes, fmt_ms

OK = "OK"
NO_DATA = "NO_DATA"
MISSING_BASELINE = "MISSING_BASELINE"
MISSING_CANDIDATE = "MISSING_CANDIDATE"
INSUFFICIENT = "INSUFFICIENT"


@dataclasses.dataclass
class SectionComparison:
    section: str
    status: str
    metrics: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    findings: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    per_rank: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    note: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _section(summary: Dict[str, Any], name: str) -> Optional[Dict[str, Any]]:
    sec = (summary.get("sections") or {}).get(name)
    # missing status (hand-built or older artifacts) counts as usable
    if not isinstance(sec, dict) or sec.get("status", "OK") != "OK":
        return None
    return sec


def _presence(b: Optional[dict], c: Optional[dict], name: str) -> Optional[SectionComparison]:
    """Shared missing-data handling; None means both present."""
    if b is None and c is None:
        return SectionComparison(section=name, status=NO_DATA)
    if b is None:
        return SectionComparison(
            section=name,
            status=MISSING_BASELINE,
            note="baseline run has no usable data for this section",
        )
    if c is None:
        return SectionComparison(
            section=name,
            status=MISSING_CANDIDATE,
            note="candidate run has no usable data for this section",
        )
    return None


def _metric(
    baseline: Optional[float],
    candidate: Optional[float],
    significance: str,
) -> Dict[str, Any]:
    delta = None
    delta_rel = None
    if baseline is not None and candidate is not None:
        delta = candidate - baseline
        if baseline:
            delta_rel = delta / baseline
    return {
        "baseline": baseline,
        "candidate": candidate,
        "delta": delta,
        "delta_rel": delta_rel,
        "significance": significance,
    }


# ---------------------------------------------------------------------------
# step time
# ---------------------------------------------------------------------------

def compare_step_time(
    baseline: Dict[str, Any],
    candidate: Dict[str, Any],
    policy: ComparePolicy = DEFAULT_POLICY,
) -> SectionComparison:
    b, c = _section(baseline, "step_time"), _section(candidate, "step_time")
    missing = _presence(b, c, "step_time")
    if missing is not None:
        return missing

    bg, cg = b.get("global") or {}, c.get("global") or {}
    out = SectionComparison(section="step_time", status=OK)
    bn, cn = bg.get("n_steps"), cg.get("n_steps")
    # gate only on DECLARED small windows; absent counts stay comparable
    if bn is not None and cn is not None and min(bn, cn) < policy.min_steps:
        out.status = INSUFFICIENT
        out.note = (
            f"window too small to compare ({bn} vs {cn} steps, "
            f"need ≥{policy.min_steps})"
        )
        return out
    if bg.get("clock") != cg.get("clock"):
        out.note = (
            f"clock changed ({bg.get('clock')} → {cg.get('clock')}); "
            "absolute deltas may not be comparable"
        )

    b_phases, c_phases = bg.get("phases") or {}, cg.get("phases") or {}
    b_step = (b_phases.get("step_time") or {}).get("median_ms")
    c_step = (c_phases.get("step_time") or {}).get("median_ms")
    step_delta_rel = None
    if b_step and c_step:
        step_delta_rel = (c_step - b_step) / b_step
    sig = classify(step_delta_rel, policy.step_avg_minor, policy.step_avg_major)
    out.metrics["step_median_ms"] = _metric(b_step, c_step, sig)
    if sig != "negligible":
        direction = "slower" if step_delta_rel > 0 else "faster"
        out.findings.append(
            {
                "kind": "STEP_TIME_"
                + ("REGRESSION" if step_delta_rel > 0 else "IMPROVEMENT"),
                "section": "step_time",
                "significance": sig,
                "summary": (
                    f"Median step is {abs(step_delta_rel) * 100:.1f}% {direction} "
                    f"({fmt_ms(b_step)} → {fmt_ms(c_step)})."
                ),
                "metric": "step_median_ms",
            }
        )

    # phase share shifts
    b_shares = {
        k: v.get("share_of_step")
        for k, v in b_phases.items()
        if k != "step_time" and v.get("share_of_step") is not None
    }
    c_shares = {
        k: v.get("share_of_step")
        for k, v in c_phases.items()
        if k != "step_time" and v.get("share_of_step") is not None
    }
    for key in sorted(set(b_shares) | set(c_shares)):
        b_v, c_v = b_shares.get(key, 0.0), c_shares.get(key, 0.0)
        shift_pp = (c_v - b_v) * 100.0
        sig = classify(shift_pp, policy.phase_shift_minor_pp, policy.phase_shift_major_pp)
        out.metrics[f"share.{key}"] = _metric(b_v, c_v, sig)
        if sig != "negligible":
            out.findings.append(
                {
                    "kind": "PHASE_SHIFT",
                    "section": "step_time",
                    "significance": sig,
                    "summary": (
                        f"Phase '{key}' share moved {shift_pp:+.1f} pp "
                        f"({b_v * 100:.1f}% → {c_v * 100:.1f}%)."
                    ),
                    "metric": f"share.{key}",
                    "phase": key,
                    "direction": "up" if shift_pp > 0 else "down",
                }
            )

    # per-rank step deltas → straggler appearance/disappearance
    b_rank = (b_phases.get("step_time") or {}).get("per_rank_avg_ms") or {}
    c_rank = (c_phases.get("step_time") or {}).get("per_rank_avg_ms") or {}
    worst_rank, worst_rel = None, 0.0
    for rank in sorted(set(b_rank) & set(c_rank), key=lambda r: int(r)):
        b_v, c_v = b_rank[rank], c_rank[rank]
        rel = (c_v - b_v) / b_v if b_v else None
        out.per_rank[str(rank)] = {
            "baseline_ms": b_v,
            "candidate_ms": c_v,
            "delta_rel": rel,
        }
        if rel is not None and abs(rel) > abs(worst_rel):
            worst_rank, worst_rel = rank, rel
    if (
        worst_rank is not None
        and step_delta_rel is not None
        and abs(worst_rel - step_delta_rel) >= policy.step_avg_major
    ):
        out.findings.append(
            {
                "kind": "RANK_DIVERGENCE",
                "section": "step_time",
                "significance": "major",
                "summary": (
                    f"Rank {worst_rank} moved {worst_rel * 100:+.1f}% vs the "
                    f"run-level {step_delta_rel * 100:+.1f}% — a rank-local "
                    "change (data shard, host, or interconnect), not a "
                    "global one."
                ),
                "metric": "per_rank.step_time",
                "rank": worst_rank,
            }
        )
    return out


# ---------------------------------------------------------------------------
# step memory
# ---------------------------------------------------------------------------

def _mem_stats(summary: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    sec = _section(summary, "step_memory")
    if sec is None:
        return {}
    return (sec.get("global") or {}).get("per_rank") or {}


def compare_step_memory(
    baseline: Dict[str, Any],
    candidate: Dict[str, Any],
    policy: ComparePolicy = DEFAULT_POLICY,
) -> SectionComparison:
    b, c = _section(baseline, "step_memory"), _section(candidate, "step_memory")
    missing = _presence(b, c, "step_memory")
    if missing is not None:
        return missing
    out = SectionComparison(section="step_memory", status=OK)
    b_rank, c_rank = _mem_stats(baseline), _mem_stats(candidate)

    def peak(stats: Dict[str, Any]) -> Optional[int]:
        peaks = [v.get("step_peak_bytes") or 0 for v in stats.values()]
        return max(peaks) if peaks else None

    b_peak, c_peak = peak(b_rank), peak(c_rank)
    delta = (c_peak - b_peak) if b_peak is not None and c_peak is not None else None
    sig = classify(delta, policy.memory_minor_bytes, policy.memory_major_bytes)
    out.metrics["peak_bytes"] = _metric(b_peak, c_peak, sig)
    if sig != "negligible":
        out.findings.append(
            {
                "kind": "MEMORY_" + ("REGRESSION" if delta > 0 else "IMPROVEMENT"),
                "section": "step_memory",
                "significance": sig,
                "summary": (
                    f"Peak device memory {'grew' if delta > 0 else 'shrank'} "
                    f"{fmt_bytes(abs(delta))} "
                    f"({fmt_bytes(b_peak)} → {fmt_bytes(c_peak)})."
                ),
                "metric": "peak_bytes",
            }
        )

    # per-rank peaks + skew shift
    common = sorted(set(b_rank) & set(c_rank), key=lambda r: int(r))
    for rank in common:
        b_v = b_rank[rank].get("step_peak_bytes")
        c_v = c_rank[rank].get("step_peak_bytes")
        out.per_rank[str(rank)] = {
            "baseline_bytes": b_v,
            "candidate_bytes": c_v,
            "delta_bytes": (c_v - b_v)
            if b_v is not None and c_v is not None
            else None,
        }

    def skew_pp(stats: Dict[str, Any]) -> Optional[float]:
        import statistics as st

        peaks = [v.get("step_peak_bytes") for v in stats.values()]
        peaks = [p for p in peaks if p]
        if len(peaks) < 2:
            return None
        med = st.median(peaks)
        return (max(peaks) - min(peaks)) / med * 100.0 if med else None

    b_skew, c_skew = skew_pp(b_rank), skew_pp(c_rank)
    if b_skew is not None and c_skew is not None:
        shift = c_skew - b_skew
        sig = classify(shift, policy.memory_skew_minor_pp, policy.memory_skew_major_pp)
        out.metrics["rank_skew_pp"] = _metric(b_skew, c_skew, sig)
        if sig != "negligible" and shift > 0:
            out.findings.append(
                {
                    "kind": "MEMORY_IMBALANCE_GREW",
                    "section": "step_memory",
                    "significance": sig,
                    "summary": (
                        f"Cross-rank peak-memory skew grew {shift:+.1f} pp "
                        f"({b_skew:.1f}% → {c_skew:.1f}% of the median)."
                    ),
                    "metric": "rank_skew_pp",
                }
            )
    return out


# ---------------------------------------------------------------------------
# system
# ---------------------------------------------------------------------------

def compare_system(
    baseline: Dict[str, Any],
    candidate: Dict[str, Any],
    policy: ComparePolicy = DEFAULT_POLICY,
) -> SectionComparison:
    b, c = _section(baseline, "system"), _section(candidate, "system")
    missing = _presence(b, c, "system")
    if missing is not None:
        return missing
    out = SectionComparison(section="system", status=OK)
    b_nodes = (b.get("global") or {}).get("nodes") or {}
    c_nodes = (c.get("global") or {}).get("nodes") or {}
    for node in sorted(set(b_nodes) & set(c_nodes), key=str):
        b_n, c_n = b_nodes[node], c_nodes[node]
        b_cpu, c_cpu = b_n.get("cpu_pct_mean"), c_n.get("cpu_pct_mean")
        cpu_pp = (c_cpu - b_cpu) if b_cpu is not None and c_cpu is not None else None
        b_mem, c_mem = b_n.get("memory_used_bytes"), c_n.get("memory_used_bytes")
        mem_d = (c_mem - b_mem) if b_mem is not None and c_mem is not None else None
        out.per_rank[str(node)] = {
            "hostname": c_n.get("hostname") or b_n.get("hostname"),
            "cpu_pp": cpu_pp,
            "memory_delta_bytes": mem_d,
        }
        cpu_sig = classify(cpu_pp, policy.system_cpu_minor_pp, policy.system_cpu_major_pp)
        if cpu_sig != "negligible":
            out.findings.append(
                {
                    "kind": "HOST_CPU_SHIFT",
                    "section": "system",
                    "significance": cpu_sig,
                    "summary": (
                        f"Node {node} mean host CPU moved {cpu_pp:+.0f} pp "
                        f"({b_cpu:.0f}% → {c_cpu:.0f}%)."
                    ),
                    "metric": f"node.{node}.cpu_pct_mean",
                }
            )
        mem_sig = classify(
            mem_d, policy.system_memory_minor_bytes, policy.system_memory_major_bytes
        )
        if mem_sig != "negligible":
            out.findings.append(
                {
                    "kind": "HOST_MEMORY_SHIFT",
                    "section": "system",
                    "significance": mem_sig,
                    "summary": (
                        f"Node {node} host memory moved "
                        f"{'+' if mem_d > 0 else '-'}{fmt_bytes(abs(mem_d))}."
                    ),
                    "metric": f"node.{node}.memory_used_bytes",
                }
            )
    out.metrics["nodes_compared"] = _metric(
        float(len(b_nodes)), float(len(c_nodes)), "negligible"
    )
    return out


# ---------------------------------------------------------------------------
# process
# ---------------------------------------------------------------------------

def compare_process(
    baseline: Dict[str, Any],
    candidate: Dict[str, Any],
    policy: ComparePolicy = DEFAULT_POLICY,
) -> SectionComparison:
    b, c = _section(baseline, "process"), _section(candidate, "process")
    missing = _presence(b, c, "process")
    if missing is not None:
        return missing
    out = SectionComparison(section="process", status=OK)
    b_rank = (b.get("global") or {}).get("per_rank") or {}
    c_rank = (c.get("global") or {}).get("per_rank") or {}
    for rank in sorted(set(b_rank) & set(c_rank), key=lambda r: int(r)):
        b_r, c_r = b_rank[rank], c_rank[rank]
        b_cpu, c_cpu = b_r.get("cpu_pct"), c_r.get("cpu_pct")
        cpu_pp = (c_cpu - b_cpu) if b_cpu is not None and c_cpu is not None else None
        b_rss, c_rss = b_r.get("rss_bytes"), c_r.get("rss_bytes")
        rss_d = (c_rss - b_rss) if b_rss is not None and c_rss is not None else None
        out.per_rank[str(rank)] = {"cpu_pp": cpu_pp, "rss_delta_bytes": rss_d}
        cpu_sig = classify(cpu_pp, policy.process_cpu_minor_pp, policy.process_cpu_major_pp)
        if cpu_sig != "negligible":
            out.findings.append(
                {
                    "kind": "PROCESS_CPU_SHIFT",
                    "section": "process",
                    "significance": cpu_sig,
                    "summary": (
                        f"Rank {rank} process CPU moved {cpu_pp:+.0f} pp "
                        f"({b_cpu:.0f}% → {c_cpu:.0f}%)."
                    ),
                    "metric": f"rank.{rank}.cpu_pct",
                }
            )
        rss_sig = classify(
            rss_d, policy.process_rss_minor_bytes, policy.process_rss_major_bytes
        )
        if rss_sig != "negligible":
            out.findings.append(
                {
                    "kind": "PROCESS_RSS_" + ("GREW" if rss_d > 0 else "SHRANK"),
                    "section": "process",
                    "significance": rss_sig,
                    "summary": (
                        f"Rank {rank} host RSS "
                        f"{'grew' if rss_d > 0 else 'shrank'} "
                        f"{fmt_bytes(abs(rss_d))}."
                    ),
                    "metric": f"rank.{rank}.rss_bytes",
                }
            )
    return out


# ---------------------------------------------------------------------------
# diagnosis transitions (cross-section)
# ---------------------------------------------------------------------------

def compare_diagnoses(
    baseline: Dict[str, Any], candidate: Dict[str, Any]
) -> List[Dict[str, Any]]:
    findings: List[Dict[str, Any]] = []
    b_primary = baseline.get("primary_diagnosis") or {}
    c_primary = candidate.get("primary_diagnosis") or {}
    b_kind, c_kind = b_primary.get("kind"), c_primary.get("kind")
    if b_kind != c_kind:
        regressed = diagnosis_rank(c_kind) > diagnosis_rank(b_kind)
        pathological = c_primary.get("severity") in ("warning", "critical")

        def _lbl(p):
            lab = p.get("confidence_label")
            return f" ({lab} confidence)" if lab else ""

        finding = {
            "kind": "DIAGNOSIS_" + ("REGRESSION" if regressed else "CHANGED"),
            "section": "diagnosis",
            "significance": "major" if regressed and pathological else "minor",
            "summary": (
                f"Primary diagnosis changed: {b_kind}{_lbl(b_primary)}"
                f" → {c_kind}{_lbl(c_primary)}."
            ),
            "metric": "primary_diagnosis",
            "baseline": b_kind,
            "candidate": c_kind,
        }
        # the transition is only as trustworthy as its weaker side: the
        # MIN of the two evidence-derived confidences rides along so the
        # verdict ladder can weight it
        confs = [
            p.get("confidence")
            for p in (b_primary, c_primary)
            if isinstance(p.get("confidence"), (int, float))
        ]
        if confs:
            from traceml_tpu_torch.diagnostics.common import confidence_label

            finding["confidence"] = min(confs)
            finding["confidence_label"] = confidence_label(min(confs))
        findings.append(finding)
    return findings


ALL_COMPARERS = {
    "step_time": compare_step_time,
    "step_memory": compare_step_memory,
    "system": compare_system,
    "process": compare_process,
}
