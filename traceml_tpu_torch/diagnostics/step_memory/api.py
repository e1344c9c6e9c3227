"""Step-memory diagnosis entrypoint.

Counterpart of ``traceml_tpu/diagnostics/step_memory/api.py``: the rules
over row dicts (the scalar reference) or straight over the snapshot
store's per-rank memory ring buffers (``diagnose_columns``); both build
the same series.  With a captured mesh (``topology``) a fired imbalance
gains an ``attribution`` block over the per-rank used bytes (the last
sample), as in JAX.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

from traceml_tpu_torch.diagnostics.common import DiagnosticResult, run_rules
from traceml_tpu_torch.diagnostics.step_memory.policy import DEFAULT_POLICY, StepMemoryPolicy
from traceml_tpu_torch.diagnostics.step_memory.rules import (
    DEFAULT_RULES,
    build_memory_context,
    build_memory_context_from_columns,
)
from traceml_tpu_torch.utils.columnar import MemoryColumns

DOMAIN = "step_memory"


def diagnose_rank_rows(
    rank_rows: Mapping[int, Sequence[Mapping[str, Any]]],
    policy: StepMemoryPolicy = DEFAULT_POLICY,
    topology: Optional[Any] = None,
) -> DiagnosticResult:
    result = run_rules(DOMAIN, DEFAULT_RULES, build_memory_context(rank_rows, policy))
    return _attribute(result, topology, {
        rank: float((rows[-1].get("step_peak_bytes") or 0) or (rows[-1].get("current_bytes") or 0))
        for rank, rows in rank_rows.items()
        if rows
    })


def diagnose_columns(
    rank_columns: Mapping[int, MemoryColumns],
    policy: StepMemoryPolicy = DEFAULT_POLICY,
    topology: Optional[Any] = None,
) -> DiagnosticResult:
    """Columnar fast path: diagnose straight from the snapshot store's
    per-rank memory ring buffers (no row-dict walk)."""
    result = run_rules(DOMAIN, DEFAULT_RULES, build_memory_context_from_columns(rank_columns, policy))
    return _attribute(result, topology, {
        rank: cols.last_used()
        for rank, cols in rank_columns.items()
        if len(cols) and cols.columnar_ok
    })


def _attribute(result, topology, per_rank_used):
    """Imbalance grouping over per-rank used bytes (last sample): the
    memory analogue of the step-time straggler attribution."""
    if topology is None:
        return result
    from traceml_tpu_torch.diagnostics.attribution import attach_attribution

    return attach_attribution(result, topology, per_rank_used)
