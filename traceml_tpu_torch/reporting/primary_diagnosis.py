"""Run-level primary diagnosis.

Counterpart of ``traceml_tpu/reporting/primary_diagnosis.py`` for the two
domains this slice diagnoses.  Promotes the step-time finding to run
level; a non-healthy memory finding of higher severity can outrank an
info-grade step-time verdict; otherwise it falls back to
``NO_CLEAR_PERFORMANCE_BOTTLENECK`` / ``INSUFFICIENT_STEP_TIME_DATA``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from traceml_tpu_torch.diagnostics.common import (
    SEVERITY_CRITICAL,
    SEVERITY_WARNING,
    DiagnosticResult,
)

_SEV_ORDER = {SEVERITY_CRITICAL: 2, SEVERITY_WARNING: 1}


def build_primary_diagnosis(
    step_time: Optional[DiagnosticResult],
    step_memory: Optional[DiagnosticResult] = None,
    step_time_error: Optional[str] = None,
) -> Dict[str, Any]:
    candidates = []
    if step_time is not None:
        issue = step_time.diagnosis
        if issue.kind == "INSUFFICIENT_STEP_TIME_DATA":
            candidates.append((0.5, "step_time", issue))
        elif not step_time.healthy or issue.kind == "COMPUTE_BOUND":
            # step-time issues get a priority bump: they ARE the
            # performance story
            candidates.append((_SEV_ORDER.get(issue.severity, 0) + 0.6, "step_time", issue))
    if step_memory is not None and not step_memory.healthy:
        issue = step_memory.diagnosis
        candidates.append((_SEV_ORDER.get(issue.severity, 0), "step_memory", issue))

    if not candidates:
        if step_time is None and step_time_error:
            # the section BUILDER failed: send the user to the error
            return {
                "kind": "INSUFFICIENT_STEP_TIME_DATA",
                "domain": "run",
                "severity": "info",
                "summary": f"Step-time analysis failed: {step_time_error}",
                "action": "See sections.step_time.error in the summary.",
            }
        if step_time is None:
            # nothing was measured: "no bottleneck" would imply a healthy run
            return {
                "kind": "INSUFFICIENT_STEP_TIME_DATA",
                "domain": "run",
                "severity": "info",
                "summary": "No step telemetry was recorded.",
                "action": (
                    "Check that trace_step() brackets the loop and the "
                    "runtime started (TRACEML_DISABLE unset)."
                ),
            }
        return {
            "kind": "NO_CLEAR_PERFORMANCE_BOTTLENECK",
            "domain": "run",
            "severity": "info",
            "summary": "No dominant bottleneck or anomaly detected in the analyzed window.",
            "action": "",
        }
    candidates.sort(key=lambda c: -c[0])
    _prio, domain, issue = candidates[0]
    out = issue.to_dict()
    out["domain"] = domain
    return out
