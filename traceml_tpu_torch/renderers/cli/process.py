"""Process CLI panel.

Counterpart of ``traceml_tpu/renderers/cli/process.py`` (copied): the
per-rank process table with the busiest rank highlighted and per-row
staleness.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from rich.panel import Panel
from rich.table import Table
from rich.text import Text

from traceml_tpu_torch.renderers.views import ProcessView
from traceml_tpu_torch.utils.formatting import fmt_bytes


def process_panel(payload: Dict[str, Any]) -> Panel:
    view: Optional[ProcessView] = (payload.get("views") or {}).get("process")
    if view is None:
        return Panel(Text("no process telemetry", style="dim"), title="processes")
    table = Table(expand=True, box=None)
    table.add_column("rank", justify="right")
    table.add_column("host")
    table.add_column("pid", justify="right")
    table.add_column("cpu", justify="right")
    table.add_column("rss", justify="right")
    table.add_column("threads", justify="right")
    table.add_column("", justify="right")
    for s in view.ranks:
        cpu_style = "bold yellow" if s.rank == view.busiest_rank else ""
        table.add_row(
            str(s.rank),
            s.hostname,
            str(s.pid or "—"),
            Text(
                f"{s.cpu_pct:.0f}%" if s.cpu_pct is not None else "n/a",
                style=cpu_style,
            ),
            fmt_bytes(s.rss_bytes),
            str(s.num_threads or "—"),
            Text("stale", style="yellow") if s.stale else "",
        )
    return Panel(
        table,
        title="processes",
        subtitle=f"total rss {fmt_bytes(view.total_rss_bytes)}",
    )
