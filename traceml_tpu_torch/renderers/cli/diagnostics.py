"""Composed cross-domain diagnostics card.

Counterpart of ``traceml_tpu/renderers/cli/diagnostics.py`` (copied): the
one place the live view lists findings from every domain.
"""

from __future__ import annotations

from typing import Any, Dict

from rich.panel import Panel
from rich.text import Text

_SEV_STYLE = {"critical": "bold red", "warning": "yellow", "info": "cyan"}


def diagnostics_panel(payload: Dict[str, Any]) -> Panel:
    from traceml_tpu_torch.diagnostics.model_diagnostics import compose

    results = {
        "step_time": (payload.get("step_time") or {}).get("diagnosis"),
        "step_memory": payload.get("step_memory_diagnosis"),
        "system": payload.get("system_diagnosis"),
        "process": payload.get("process_diagnosis"),
    }
    try:
        composed = compose(results)
    except Exception:
        return Panel(Text("—", style="dim"), title="diagnostics")
    if not composed.issues:
        return Panel(
            Text("no active findings", style="dim green"), title="diagnostics"
        )
    from traceml_tpu_torch.diagnostics.common import confidence_label

    text = Text()
    for issue in composed.issues[:6]:
        domain = issue.evidence.get("domain", "?")
        text.append(
            f"[{issue.severity:>8}] {domain}/{issue.kind}: ",
            style=_SEV_STYLE.get(issue.severity, "white"),
        )
        text.append(issue.summary)
        label = confidence_label(getattr(issue, "confidence", None))
        if label:
            text.append(f"  ({label} confidence)", style="dim")
        text.append("\n")
    return Panel(text, title="diagnostics")
