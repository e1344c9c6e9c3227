"""Shared diagnostic contracts.

Counterpart of ``traceml_tpu/diagnostics/common.py`` (copied).

``DiagnosticResult.issues`` is always non-empty — when nothing fires,
the domain emits a HEALTHY info issue — and ``diagnosis`` is the
top-ranked issue after :func:`sort_issues` (severity → score →
breadth).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Sequence

SEVERITY_INFO = "info"
SEVERITY_WARNING = "warning"
SEVERITY_CRITICAL = "critical"

_SEVERITY_ORDER = {SEVERITY_CRITICAL: 2, SEVERITY_WARNING: 1, SEVERITY_INFO: 0}

STATUS_OK = "ok"
STATUS_ISSUE = "issue"


@dataclasses.dataclass
class DiagnosticIssue:
    kind: str  # e.g. "INPUT_BOUND", "COMPUTE_STRAGGLER"
    severity: str = SEVERITY_INFO
    status: str = STATUS_ISSUE
    summary: str = ""
    action: str = ""
    metric: Optional[str] = None  # canonical metric name
    phase: Optional[str] = None  # phase key (input/h2d/.../residual)
    score: float = 0.0  # rule-specific magnitude (higher = worse)
    share_pct: Optional[float] = None  # phase share of step (0..1)
    skew_pct: Optional[float] = None  # cross-rank skew (0..1+)
    ranks: List[int] = dataclasses.field(default_factory=list)
    evidence: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # EVIDENCE-DERIVED confidence (0..1) — from threshold margin,
    # window coverage, and statistic agreement (confidence_from), not a
    # per-rule constant (reference carries static confidences;
    # DIAGNOSIS.md documents our formula).  None = rule predates the
    # confidence contract or has no meaningful margin.
    confidence: Optional[float] = None
    # topology attribution: {kind, label, group, axis, ranks, explained}
    # when the anomaly maps onto physical structure (a host, a DCN side,
    # a mesh-axis shard — diagnostics/attribution.py); None keeps the
    # flat rank list AND the serialized dict byte-identical to the
    # pre-topology contract (the key is omitted, see to_dict).
    attribution: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if d.get("attribution") is None:
            d.pop("attribution", None)
        d["confidence_label"] = confidence_label(self.confidence)
        return d


def confidence_label(confidence: Optional[float]) -> Optional[str]:
    """low / medium / high at the reference's 0.60 / 0.85 breakpoints."""
    if confidence is None:
        return None
    value = float(confidence)
    if value >= 0.85:
        return "high"
    if value >= 0.60:
        return "medium"
    return "low"


def confidence_from(
    value: float,
    warn_threshold: float,
    *,
    coverage: float = 1.0,
    agreement: Optional[bool] = None,
) -> float:
    """Evidence-derived confidence for a fired rule.

    Three measurable ingredients, multiplied:

    * **margin** — how far past the warn threshold the statistic landed:
      at the bar → 0.55, at 2× the bar → ~0.9, asymptote 1.0.  A verdict
      that barely fired is a verdict that barely fired.
    * **coverage** — window fullness vs what the policy wanted (0..1):
      a half-full window scales confidence toward 0.75 (never below —
      the rule DID meet its minimum to fire at all).
    * **agreement** — for dual-statistic rules: True (both the median
      and mean pipelines fired) keeps full confidence; False (only one)
      scales by 0.85; None (single-statistic rule) is neutral.
    """
    if warn_threshold <= 0:
        margin_conf = 0.75
    else:
        ratio = max(0.0, value / warn_threshold - 1.0)
        margin_conf = 0.55 + 0.45 * min(1.0, ratio)
    cov = min(1.0, max(0.0, coverage))
    cov_conf = 0.75 + 0.25 * cov
    agree_conf = 1.0 if agreement in (True, None) else 0.85
    return round(min(1.0, margin_conf * cov_conf * agree_conf), 3)


def healthy_issue(domain: str, summary: str = "") -> DiagnosticIssue:
    return DiagnosticIssue(
        kind="HEALTHY",
        severity=SEVERITY_INFO,
        status=STATUS_OK,
        summary=summary or f"No {domain} issues detected in the analyzed window.",
    )


def sort_issues(issues: Sequence[DiagnosticIssue]) -> List[DiagnosticIssue]:
    """severity desc → score desc → breadth (#ranks) desc → kind asc."""
    return sorted(
        issues,
        key=lambda i: (
            -_SEVERITY_ORDER.get(i.severity, 0),
            -(i.score or 0.0),
            -len(i.ranks),
            i.kind,
        ),
    )


@dataclasses.dataclass
class DiagnosticResult:
    domain: str
    issues: List[DiagnosticIssue]

    def __post_init__(self) -> None:
        if not self.issues:
            self.issues = [healthy_issue(self.domain)]
        self.issues = sort_issues(self.issues)

    @property
    def diagnosis(self) -> DiagnosticIssue:
        return self.issues[0]

    @property
    def healthy(self) -> bool:
        return self.diagnosis.status == STATUS_OK

    def to_dict(self) -> Dict[str, Any]:
        return {
            "domain": self.domain,
            "diagnosis": self.diagnosis.to_dict(),
            "issues": [i.to_dict() for i in self.issues],
        }


class DiagnosticRule(Protocol):
    """A rule inspects a domain context and yields issues (possibly none)."""

    def evaluate(self, ctx: Any) -> List[DiagnosticIssue]: ...


# lifetime rule-evaluation counters per domain: the tick profiler reads
# these to prove a diagnosis-cache hit really ran ZERO rules (pinned by
# the version-idle assertions in tests and bench_tick_pipeline)
_RULE_EVALS: Dict[str, int] = {}


def rule_eval_counts() -> Dict[str, int]:
    return dict(_RULE_EVALS)


def run_rules(domain: str, rules: Sequence[DiagnosticRule], ctx: Any) -> DiagnosticResult:
    issues: List[DiagnosticIssue] = []
    for rule in rules:
        _RULE_EVALS[domain] = _RULE_EVALS.get(domain, 0) + 1
        try:
            issues.extend(rule.evaluate(ctx) or [])
        except Exception:
            # a broken rule must never take down the report
            continue
    return DiagnosticResult(domain=domain, issues=issues)
