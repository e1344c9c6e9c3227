"""Device-memory CLI panel.

Counterpart of ``traceml_tpu/renderers/cli/memory.py`` (copied): per-rank
rows with pressure highlighting and window growth.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from rich.panel import Panel
from rich.table import Table
from rich.text import Text

from traceml_tpu_torch.renderers.views import MemoryView
from traceml_tpu_torch.utils.formatting import fmt_bytes, fmt_pct

_PRESSURE_WARN = 0.92
_PRESSURE_CRIT = 0.97


def step_memory_panel(payload: Dict[str, Any]) -> Panel:
    view: Optional[MemoryView] = (payload.get("views") or {}).get("memory")
    if view is None:
        return Panel(Text("no memory telemetry", style="dim"), title="device memory")
    table = Table(expand=True, box=None)
    table.add_column("rank", justify="right")
    table.add_column("device")
    table.add_column("current", justify="right")
    table.add_column("step peak", justify="right")
    table.add_column("limit", justify="right")
    table.add_column("pressure", justify="right")
    table.add_column("growth", justify="right")
    for s in view.ranks:
        style = ""
        if s.pressure is not None and s.pressure >= _PRESSURE_WARN:
            style = "bold red" if s.pressure >= _PRESSURE_CRIT else "yellow"
        growth = ""
        if s.growth_bytes:
            sign = "+" if s.growth_bytes > 0 else ""
            growth = f"{sign}{fmt_bytes(abs(s.growth_bytes))}"
            if s.growth_bytes < 0:
                growth = "-" + fmt_bytes(abs(s.growth_bytes))
        table.add_row(
            str(s.rank),
            s.device_kind,
            fmt_bytes(s.current_bytes),
            fmt_bytes(s.step_peak_bytes),
            fmt_bytes(s.limit_bytes),
            Text(fmt_pct(s.pressure) if s.pressure else "—", style=style),
            growth or "—",
        )
    sub = f"total {fmt_bytes(view.total_current_bytes)}"
    if view.worst_pressure_rank is not None:
        sub += f" · worst pressure rank {view.worst_pressure_rank}"
    # multi-rank: median/worst peak + skew (reference formatter's
    # summary rows, step_memory/formatter.py:102-166, as one line)
    peaks = {
        s.rank: s.step_peak_bytes
        for s in view.ranks
        if s.step_peak_bytes
    }
    if len(peaks) > 1:
        import statistics

        from traceml_tpu_torch.utils.rankstats import worst_rank

        med = statistics.median(peaks.values())
        wr = worst_rank(peaks)
        if med > 0:
            skew = (peaks[wr] - med) / med
            sub += (
                f" · peak med {fmt_bytes(int(med))} / worst "
                f"{fmt_bytes(peaks[wr])} (r{wr}, +{skew * 100:.0f}%)"
            )
    return Panel(table, title="device memory", subtitle=sub)
