"""Run-level primary diagnosis.

Counterpart of ``traceml_tpu/reporting/primary_diagnosis.py`` for the
six domains the port diagnoses.  A non-healthy liveness finding (a lost
rank) scores its severity rank plus 0.7 and outranks every performance
finding: the run's world shrank, and the cross-rank metrics past the
loss cover the survivors only.  Promotes the step-time finding to run
level (a severity rank plus 0.6); a non-healthy step-memory, system or
process finding scores its severity rank alone, so a warning there (1.0)
outranks an info-grade step-time verdict such as COMPUTE_BOUND (0.6) but
not a step-time warning (1.6); a non-healthy collectives finding scores
its severity rank plus 0.5 (a COMM_BOUND verdict outranks environment
findings of its severity but defers to a step-time one); otherwise it
falls back to
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
    system: Optional[DiagnosticResult] = None,
    process: Optional[DiagnosticResult] = None,
    step_time_error: Optional[str] = None,
    collectives: Optional[DiagnosticResult] = None,
    liveness: Optional[DiagnosticResult] = None,
) -> Dict[str, Any]:
    candidates = []
    if liveness is not None and not liveness.healthy:
        issue = liveness.diagnosis
        candidates.append((_SEV_ORDER.get(issue.severity, 0) + 0.7, "liveness", issue))
    if step_time is not None:
        issue = step_time.diagnosis
        if issue.kind == "INSUFFICIENT_STEP_TIME_DATA":
            candidates.append((0.5, "step_time", issue))
        elif not step_time.healthy or issue.kind == "COMPUTE_BOUND":
            # step-time issues get a priority bump: they ARE the
            # performance story
            candidates.append((_SEV_ORDER.get(issue.severity, 0) + 0.6, "step_time", issue))
    if collectives is not None and not collectives.healthy:
        # the user's schedule causes it, as it does a step-time finding,
        # but step time is where the comm tax is paid
        issue = collectives.diagnosis
        candidates.append((_SEV_ORDER.get(issue.severity, 0) + 0.5, "collectives", issue))
    for domain, result in (("step_memory", step_memory), ("system", system), ("process", process)):
        if result is not None and not result.healthy:
            issue = result.diagnosis
            candidates.append((_SEV_ORDER.get(issue.severity, 0), domain, issue))

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
