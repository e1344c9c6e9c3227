"""Step-memory diagnosis entrypoint.

Counterpart of ``traceml_tpu/diagnostics/step_memory/api.py``, scalar arm
(from row dicts); topology attribution comes later.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from traceml_tpu_torch.diagnostics.common import DiagnosticResult, run_rules
from traceml_tpu_torch.diagnostics.step_memory.policy import DEFAULT_POLICY, StepMemoryPolicy
from traceml_tpu_torch.diagnostics.step_memory.rules import DEFAULT_RULES, build_memory_context

DOMAIN = "step_memory"


def diagnose_rank_rows(
    rank_rows: Mapping[int, Sequence[Mapping[str, Any]]],
    policy: StepMemoryPolicy = DEFAULT_POLICY,
) -> DiagnosticResult:
    return run_rules(DOMAIN, DEFAULT_RULES, build_memory_context(rank_rows, policy))
