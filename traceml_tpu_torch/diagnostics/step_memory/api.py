"""Step-memory diagnosis entrypoint.

Counterpart of ``traceml_tpu/diagnostics/step_memory/api.py``: the rules
over row dicts (the scalar reference) or straight over the snapshot
store's per-rank memory ring buffers (``diagnose_columns``); both build
the same series.  Topology attribution comes later.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

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
) -> DiagnosticResult:
    return run_rules(DOMAIN, DEFAULT_RULES, build_memory_context(rank_rows, policy))


def diagnose_columns(
    rank_columns: Mapping[int, MemoryColumns],
    policy: StepMemoryPolicy = DEFAULT_POLICY,
) -> DiagnosticResult:
    """Columnar fast path: diagnose straight from the snapshot store's
    per-rank memory ring buffers (no row-dict walk)."""
    return run_rules(DOMAIN, DEFAULT_RULES, build_memory_context_from_columns(rank_columns, policy))
