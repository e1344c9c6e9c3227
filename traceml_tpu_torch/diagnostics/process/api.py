"""Process diagnosis entrypoint.

Counterpart of ``traceml_tpu/diagnostics/process/api.py`` (copied).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from traceml_tpu_torch.diagnostics.common import DiagnosticResult, run_rules
from traceml_tpu_torch.diagnostics.process.rules import (
    DEFAULT_POLICY,
    DEFAULT_RULES,
    ProcessPolicy,
    build_process_context,
)

DOMAIN = "process"


def diagnose(
    proc_rows: Mapping[int, Sequence[Mapping[str, Any]]],
    device_rows: Mapping[tuple, Sequence[Mapping[str, Any]]],
    policy: ProcessPolicy = DEFAULT_POLICY,
) -> DiagnosticResult:
    ctx = build_process_context(proc_rows, device_rows, policy)
    return run_rules(DOMAIN, DEFAULT_RULES, ctx)
