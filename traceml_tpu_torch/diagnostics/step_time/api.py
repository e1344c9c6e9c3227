"""Step-time diagnosis entrypoint.

Counterpart of ``traceml_tpu/diagnostics/step_time/api.py``: a rank's step
rows become an aligned window, the rules run over it, and the result's
``diagnosis`` is the verdict (INPUT_BOUND, COMPUTE_BOUND, LOW_MFU, …).
With a captured mesh (``topology``), fired issues whose ranks map onto a
host, mesh-axis or node-boundary grouping of the per-rank step times
gain an ``attribution`` block (``diagnostics/attribution.py``).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

from traceml_tpu_torch.diagnostics.common import (
    DiagnosticIssue,
    DiagnosticResult,
    SEVERITY_INFO,
    run_rules,
)
from traceml_tpu_torch.diagnostics.step_time.policy import policy_for
from traceml_tpu_torch.diagnostics.step_time.rules import DEFAULT_RULES, build_context
from traceml_tpu_torch.utils.step_time_window import StepTimeWindow, build_step_time_window

DOMAIN = "step_time"


def diagnose_window(
    window: Optional[StepTimeWindow],
    mode: str = "summary",
    efficiency: Optional[Mapping[str, Any]] = None,
    topology: Optional[Any] = None,
) -> DiagnosticResult:
    """``efficiency`` is the MFU block when model FLOPs are known (feeds
    the LowMfuRule; the final report passes it, live views do not yet).
    ``topology`` is the captured ``MeshTopology`` (or None, which leaves
    the result byte-identical to the output without one)."""
    policy = policy_for(mode)
    if window is None or window.n_steps < policy.min_steps:
        return DiagnosticResult(
            domain=DOMAIN,
            issues=[
                DiagnosticIssue(
                    kind="INSUFFICIENT_STEP_TIME_DATA",
                    severity=SEVERITY_INFO,
                    status="ok",
                    summary=(
                        "Not enough aligned steps for a reliable step-time "
                        f"diagnosis (have {0 if window is None else window.n_steps}, "
                        f"need {policy.min_steps})."
                    ),
                )
            ],
        )
    ctx = build_context(window, policy, efficiency=efficiency)
    result = _prefer_cause_over_symptom(run_rules(DOMAIN, DEFAULT_RULES, ctx))
    if topology is not None:
        from traceml_tpu_torch.diagnostics.attribution import attach_attribution
        from traceml_tpu_torch.utils.step_time_window import STEP_KEY

        step = window.metric(STEP_KEY)
        result = attach_attribution(result, topology, step.per_rank_avg_ms if step else None)
    return result


#: kinds that EXPLAIN idleness — when one fires at the symptom's
#: severity or above, it is the actionable verdict and must outrank it
_CAUSE_KINDS = (
    "INPUT_BOUND", "COMPILE_BOUND", "RESIDUAL_HEAVY",
    "INPUT_STRAGGLER", "COMPUTE_STRAGGLER", "H2D_STRAGGLER",
    "COLLECTIVE_STRAGGLER", "RESIDUAL_STRAGGLER", "STRAGGLER",
)
_SYMPTOM_KINDS = ("LOW_DEVICE_UTILIZATION",)
_SEV_RANK = {"info": 0, "warning": 1, "critical": 2}


def _prefer_cause_over_symptom(result: DiagnosticResult) -> DiagnosticResult:
    """LOW_DEVICE_UTILIZATION is a SYMPTOM (the device idles); when a
    same-or-higher-severity cause fired in the same window, the cause is
    the actionable verdict and leads the result."""
    issues = result.issues
    causes = [i for i in issues if i.kind in _CAUSE_KINDS]
    if not causes:
        return result
    changed = False
    for issue in issues:
        if issue.kind not in _SYMPTOM_KINDS:
            continue
        sev = _SEV_RANK.get(issue.severity, 0)
        peers = [
            c for c in causes if _SEV_RANK.get(c.severity, 0) >= sev
        ]
        if not peers:
            continue
        best = max(peers, key=lambda c: c.score or 0.0)
        # sort is severity → score: nudge the symptom just under its
        # best explaining cause so the cause leads the result
        issue.score = min(issue.score, (best.score or 0.0) - 1e-6)
        issue.evidence.setdefault("explained_by", best.kind)
        changed = True
    if not changed:
        return result
    return DiagnosticResult(domain=result.domain, issues=issues)


def diagnose_rank_rows(
    rank_rows: Mapping[int, Sequence[Mapping[str, Any]]],
    mode: str = "summary",
    max_steps: int = 200,
    topology: Optional[Any] = None,
) -> DiagnosticResult:
    window = build_step_time_window(rank_rows, max_steps=max_steps)
    return diagnose_window(window, mode=mode, topology=topology)
