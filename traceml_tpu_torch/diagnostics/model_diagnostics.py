"""Model-diagnostics composer.

Counterpart of ``traceml_tpu/diagnostics/model_diagnostics.py`` (copied).
The JAX module also declares a ``DOMAIN_REGISTRY`` that nothing reads
(``compose`` takes its domains as arguments), so the port has no copy of
it nor of ``core/registry.py``.

Merges the per-domain results (step-time + step-memory are the "model"
domains; system/process are environment) into one card for dashboards
and the summary: the ordered union of issues, a composed headline, and a
per-domain health map.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from traceml_tpu_torch.diagnostics.common import (
    DiagnosticIssue,
    DiagnosticResult,
    sort_issues,
)

MODEL_DOMAINS = ("step_time", "step_memory", "collectives", "serving")
ENV_DOMAINS = ("system", "process")


@dataclasses.dataclass
class ComposedDiagnostics:
    headline: DiagnosticIssue
    issues: List[DiagnosticIssue]  # ordered, cross-domain
    domain_health: Dict[str, bool]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "headline": self.headline.to_dict(),
            "issues": [i.to_dict() for i in self.issues],
            "domain_health": dict(self.domain_health),
        }


def compose(
    results: Dict[str, Optional[DiagnosticResult]],
    model_domains_first: bool = True,
) -> ComposedDiagnostics:
    """Merge domain results into one ranked card.

    Model-domain issues (step time / memory — things the user's code
    causes) outrank environment findings of equal severity.
    """
    issues: List[DiagnosticIssue] = []
    health: Dict[str, bool] = {}
    for domain, result in results.items():
        if result is None:
            continue
        health[domain] = result.healthy
        for issue in result.issues:
            if issue.status == "ok":
                continue
            tagged = dataclasses.replace(issue)
            tagged.evidence = dict(issue.evidence)
            tagged.evidence["domain"] = domain
            issues.append(tagged)
    ordered = sort_issues(issues)
    if model_domains_first:
        ordered.sort(
            key=lambda i: 0 if i.evidence.get("domain") in MODEL_DOMAINS else 1
        )
        # sort is stable: severity order is preserved within each group;
        # re-rank so a critical env issue still beats a warning model one
        ordered = sorted(
            ordered,
            key=lambda i: (
                -{"critical": 2, "warning": 1, "info": 0}.get(i.severity, 0),
                0 if i.evidence.get("domain") in MODEL_DOMAINS else 1,
                -(i.score or 0.0),
            ),
        )
    if ordered:
        headline = ordered[0]
    else:
        from traceml_tpu_torch.diagnostics.common import healthy_issue

        headline = healthy_issue(
            "model", "Model and environment look healthy in the analyzed window."
        )
    return ComposedDiagnostics(
        headline=headline, issues=ordered, domain_health=health
    )
