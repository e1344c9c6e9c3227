"""Liveness diagnosis entrypoint.

Counterpart of ``traceml_tpu/diagnostics/liveness/api.py``.  Consumes a
persisted ``rank_status.json`` snapshot (written by the aggregator on
the ingest-stats cadence and at settle-end).  The states
are used exactly as written — at report time every rank is silent, so
re-deriving from wall clock would mark the whole world LOST.  With a
captured mesh (``topology``), a lost or stale cohort that maps onto one
host or one side of a node boundary gains an ``attribution`` block.
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
    topology: Optional[Any] = None,
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
    result = run_rules(DOMAIN, DEFAULT_RULES, ctx)
    if topology is not None:
        from traceml_tpu_torch.diagnostics.attribution import attach_attribution

        # binary per-rank indicator: unhealthy (lost/stale) vs fine — eta
        # squared then measures how cleanly the dead set tiles a grouping
        values = {}
        for rank_s, info in (snapshot.get("ranks") or {}).items():
            try:
                rank = int(rank_s)
            except (TypeError, ValueError):
                continue
            state = str((info or {}).get("state", "")).upper()
            values[rank] = 1.0 if state in ("LOST", "STALE") else 0.0
        result = attach_attribution(result, topology, values)
    return result
