"""Rank-0 output tail panel.

Counterpart of ``traceml_tpu/renderers/cli/output.py`` (copied).
"""

from __future__ import annotations

from typing import Any, Dict

from rich.panel import Panel
from rich.text import Text


def stdout_panel(payload: Dict[str, Any]) -> Panel:
    lines = payload.get("stdout") or []
    if not lines:
        return Panel(Text("—", style="dim"), title="rank 0 output")
    text = Text()
    for stream, line in lines[-10:]:
        style = "red" if stream == "stderr" else ""
        text.append(line[:160] + "\n", style=style)
    return Panel(text, title="rank 0 output")
