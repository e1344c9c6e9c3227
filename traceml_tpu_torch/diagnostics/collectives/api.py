"""Collectives diagnosis entrypoint.

Counterpart of ``traceml_tpu/diagnostics/collectives/api.py`` (copied).
The cross-domain join happens here via ``step_time_ms``: the caller
(``renderers/compute.py``, ``reporting/final.py``) passes the median step
duration from the step_time window so COMM_BOUND can express exposed
collective time as a share of the step.  Without it the comm/compute
ratio rules stay silent and only overlap-shape rules can fire.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

from traceml_tpu_torch.diagnostics.common import (
    DiagnosticIssue,
    DiagnosticResult,
    SEVERITY_INFO,
    run_rules,
)
from traceml_tpu_torch.diagnostics.collectives.policy import policy_for
from traceml_tpu_torch.diagnostics.collectives.rules import DEFAULT_RULES, build_context
from traceml_tpu_torch.utils.columnar import (
    CollectivesWindow,
    build_collectives_window_rows,
)

DOMAIN = "collectives"


def diagnose_collectives_window(
    window: Optional[CollectivesWindow],
    mode: str = "summary",
    step_time_ms: Optional[float] = None,
    topology: Optional[Any] = None,
) -> DiagnosticResult:
    """``topology``: the captured mesh (or None).  Fired issues whose
    ranks map onto a host / axis / DCN-side grouping of per-rank
    exposed comm time gain an ``attribution`` block."""
    policy = policy_for(mode)
    if window is None or window.n_steps < policy.min_steps:
        return DiagnosticResult(
            domain=DOMAIN,
            issues=[
                DiagnosticIssue(
                    kind="INSUFFICIENT_COLLECTIVES_DATA",
                    severity=SEVERITY_INFO,
                    status="ok",
                    summary=(
                        "Not enough steps with collective telemetry for a "
                        "reliable overlap diagnosis (have "
                        f"{0 if window is None else window.n_steps}, "
                        f"need {policy.min_steps})."
                    ),
                )
            ],
        )
    ctx = build_context(window, policy, step_time_ms=step_time_ms)
    result = run_rules(DOMAIN, DEFAULT_RULES, ctx)
    if topology is not None:
        from traceml_tpu_torch.diagnostics.attribution import attach_attribution

        result = attach_attribution(
            result,
            topology,
            {
                r: float(v.get("exposed_ms", 0.0) or 0.0)
                for r, v in window.per_rank.items()
            },
        )
    return result


def diagnose_rank_rows(
    rank_rows: Mapping[int, Sequence[Mapping[str, Any]]],
    mode: str = "summary",
    max_steps: int = 200,
    step_time_ms: Optional[float] = None,
    topology: Optional[Any] = None,
) -> DiagnosticResult:
    window = build_collectives_window_rows(rank_rows, max_steps=max_steps)
    return diagnose_collectives_window(
        window, mode=mode, step_time_ms=step_time_ms, topology=topology
    )
