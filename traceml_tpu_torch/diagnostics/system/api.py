"""System diagnosis entrypoint.

Counterpart of ``traceml_tpu/diagnostics/system/api.py`` (copied).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from traceml_tpu_torch.diagnostics.common import DiagnosticResult, run_rules
from traceml_tpu_torch.diagnostics.system.rules import (
    DEFAULT_POLICY,
    DEFAULT_RULES,
    SystemPolicy,
    build_system_context,
)

DOMAIN = "system"


def diagnose(
    host_rows: Mapping[int, Sequence[Mapping[str, Any]]],
    device_rows: Mapping[tuple, Sequence[Mapping[str, Any]]],
    policy: SystemPolicy = DEFAULT_POLICY,
) -> DiagnosticResult:
    ctx = build_system_context(host_rows, device_rows, policy)
    return run_rules(DOMAIN, DEFAULT_RULES, ctx)
