"""Priority verdict ladder.

Counterpart of ``traceml_tpu/reporting/compare/verdict.py`` (copied): a
sequential priority order chooses the PRIMARY finding.

Ladder (first matching rung wins):

1. ``INSUFFICIENT_DATA``  — the primary signal (step time) is missing on
   both sides or too small a window on either;
2. ``PARTIAL_DATA``       — step time present, but a side lost a whole
   section (degraded run) — comparison continues, flagged;
3. ``REGRESSION``         — a major regression finding in step time,
   memory, or a diagnosis transition to a pathological state;
4. ``LIKELY_REGRESSION``  — minor regression findings only;
5. ``IMPROVEMENT``        — major improvement with no regression signal;
6. ``MIXED``              — significant findings pulling both ways;
7. ``EQUIVALENT``         — nothing significant anywhere.

Confidence weighting: findings that carry an
evidence-derived confidence label argue at reduced strength when that
label is "low" — a low-confidence major counts as minor in the ladder,
and ONLY regressions held with ≥medium confidence (or statistical
findings, which carry no label) can force MIXED against a major
improvement.  The demoted findings still appear in the ranked list,
sorted below confident peers of the same tier.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from traceml_tpu_torch.reporting.compare.sections import (
    INSUFFICIENT,
    MISSING_BASELINE,
    MISSING_CANDIDATE,
    NO_DATA,
    SectionComparison,
)

_REGRESSION_KINDS = (
    "STEP_TIME_REGRESSION",
    "MEMORY_REGRESSION",
    "DIAGNOSIS_REGRESSION",
    "MEMORY_IMBALANCE_GREW",
    "RANK_DIVERGENCE",
    "PROCESS_RSS_GREW",
)
_IMPROVEMENT_KINDS = ("STEP_TIME_IMPROVEMENT", "MEMORY_IMPROVEMENT", "PROCESS_RSS_SHRANK")

# findings are ranked for display: regressions > improvements > context,
# major before minor within each class, low confidence last within a tier
_CLASS_ORDER = {"regression": 0, "improvement": 1, "context": 2}


def _finding_class(f: Dict[str, Any]) -> str:
    kind = f.get("kind", "")
    if kind in _REGRESSION_KINDS:
        return "regression"
    if kind in _IMPROVEMENT_KINDS:
        return "improvement"
    return "context"


def _effective_significance(f: Dict[str, Any]) -> str:
    """Significance weighted by evidence confidence: a major finding the
    engine itself only holds with LOW confidence argues like a minor one
    in the ladder (an uncertain DIAGNOSIS_REGRESSION must not outrank a
    solid STEP_TIME_IMPROVEMENT).  Findings without a confidence label
    (statistical delta findings) keep their significance untouched."""
    sig = f.get("significance", "minor")
    if sig == "major" and f.get("confidence_label") == "low":
        return "minor"
    return sig


def rank_findings(findings: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return sorted(
        findings,
        key=lambda f: (
            _CLASS_ORDER[_finding_class(f)],
            _effective_significance(f) != "major",
            f.get("confidence_label") == "low",
            f.get("section", ""),
        ),
    )


def decide_verdict(
    sections: Dict[str, SectionComparison],
    diagnosis_findings: List[Dict[str, Any]],
) -> Tuple[str, List[Dict[str, Any]]]:
    """(verdict, ranked findings) from the section comparisons."""
    all_findings: List[Dict[str, Any]] = list(diagnosis_findings)
    for comp in sections.values():
        all_findings.extend(comp.findings)
    ranked = rank_findings(all_findings)

    step = sections.get("step_time")
    # rung 1: primary signal unusable
    if step is None or step.status in (NO_DATA, INSUFFICIENT) or (
        step.status in (MISSING_BASELINE, MISSING_CANDIDATE)
    ):
        if step is not None and step.status == INSUFFICIENT:
            return "INSUFFICIENT_DATA", ranked
        if step is None or step.status == NO_DATA:
            return "INSUFFICIENT_DATA", ranked
        return "PARTIAL_DATA", ranked

    # rung 2: a secondary section lost a side
    partial = any(
        comp.status in (MISSING_BASELINE, MISSING_CANDIDATE)
        for name, comp in sections.items()
        if name != "step_time"
    )

    majors_reg = [
        f
        for f in ranked
        if _finding_class(f) == "regression"
        and _effective_significance(f) == "major"
    ]
    minors_reg = [f for f in ranked if _finding_class(f) == "regression"]
    # regressions the engine holds with at least medium confidence (or
    # no label at all — statistical findings): only these can force
    # MIXED against a major improvement
    confident_reg = [
        f for f in minors_reg if f.get("confidence_label") != "low"
    ]
    majors_imp = [
        f
        for f in ranked
        if _finding_class(f) == "improvement"
        and _effective_significance(f) == "major"
    ]
    improvements = [f for f in ranked if _finding_class(f) == "improvement"]

    step_major_reg = any(
        f.get("kind") == "STEP_TIME_REGRESSION"
        and _effective_significance(f) == "major"
        for f in ranked
    )
    step_major_imp = any(
        f.get("kind") == "STEP_TIME_IMPROVEMENT"
        and _effective_significance(f) == "major"
        for f in ranked
    )
    # the primary signal (step time) dominates; majors pulling against
    # it read as MIXED, not as whichever class sorts first
    if step_major_reg:
        verdict = "REGRESSION"
    elif majors_reg and step_major_imp:
        verdict = "MIXED"
    elif majors_reg:
        verdict = "REGRESSION"
    elif confident_reg and improvements:
        verdict = "MIXED"
    elif minors_reg and majors_imp:
        # only low-confidence regressions oppose a major improvement:
        # the improvement wins, the regressions stay listed below it
        verdict = "IMPROVEMENT"
    elif minors_reg and improvements:
        verdict = "MIXED"
    elif minors_reg:
        verdict = "LIKELY_REGRESSION"
    elif majors_imp:
        verdict = "IMPROVEMENT"
    elif improvements:
        verdict = "LIKELY_IMPROVEMENT"
    elif any(f.get("significance") == "major" for f in ranked):
        verdict = "MIXED"
    elif partial:
        verdict = "PARTIAL_DATA"
    else:
        verdict = "EQUIVALENT"
    return verdict, ranked

