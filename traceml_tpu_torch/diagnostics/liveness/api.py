"""Liveness diagnosis entrypoint.

Counterpart of ``traceml_tpu/diagnostics/liveness/api.py`` without the
topology attribution (the port captures no mesh yet).  Consumes a
persisted ``rank_status.json`` snapshot (written by the aggregator on
the ingest-stats cadence and at settle-end).  The states
are used exactly as written — at report time every rank is silent, so
re-deriving from wall clock would mark the whole world LOST.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from traceml_tpu_torch.diagnostics.common import (
    DiagnosticIssue,
    DiagnosticResult,
    SEVERITY_INFO,
    run_rules,
)
from traceml_tpu_torch.diagnostics.liveness.policy import policy_for
from traceml_tpu_torch.diagnostics.liveness.rules import DEFAULT_RULES, build_context

DOMAIN = "liveness"


def diagnose_rank_status(
    snapshot: Optional[Dict[str, Any]],
    mode: str = "summary",
) -> DiagnosticResult:
    policy = policy_for(mode)
    if not snapshot or not isinstance(snapshot.get("ranks"), dict):
        return DiagnosticResult(
            domain=DOMAIN,
            issues=[
                DiagnosticIssue(
                    kind="NO_LIVENESS_DATA",
                    severity=SEVERITY_INFO,
                    status="ok",
                    summary=(
                        "No rank_status.json snapshot — liveness tracking "
                        "was unavailable (pre-heartbeat producers or an "
                        "untraced run)."
                    ),
                )
            ],
        )
    ctx = build_context(snapshot, policy)
    if len(ctx.ranks) < policy.min_ranks:
        return DiagnosticResult(domain=DOMAIN, issues=[])
    return run_rules(DOMAIN, DEFAULT_RULES, ctx)
