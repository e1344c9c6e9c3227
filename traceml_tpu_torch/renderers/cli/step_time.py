"""Step-time CLI panel.

Counterpart of ``traceml_tpu/renderers/cli/step_time.py`` (copied): the
phase table, the coverage subtitle with the efficiency block, and the
per-rank phase breakdown for small worlds.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from rich.console import Group
from rich.panel import Panel
from rich.table import Table
from rich.text import Text

from traceml_tpu_torch.renderers.views import StepTimeView
from traceml_tpu_torch.utils.formatting import fmt_ms, fmt_pct
from traceml_tpu_torch.utils.step_time_window import RESIDUAL_KEY, STEP_KEY

_MAX_RANK_COLUMNS = 8
_SKEW_WARN = 0.10


def _phase_table(view: StepTimeView) -> Table:
    table = Table(expand=True, box=None, pad_edge=False)
    table.add_column("phase")
    table.add_column("median", justify="right")
    table.add_column("share", justify="right")
    # both ends of the spread name a rank: median-closest / worst
    table.add_column("rank m/w", justify="right")
    table.add_column("skew", justify="right")
    for p in view.phases:
        skew_style = "yellow" if p.skew_pct >= _SKEW_WARN and p.key != RESIDUAL_KEY else ""
        rank_pair = (
            f"r{p.median_rank}/r{p.worst_rank}"
            if p.median_rank is not None
            else str(p.worst_rank)
        )
        table.add_row(
            p.key,
            fmt_ms(p.median_ms),
            fmt_pct(p.share) if p.share is not None else "—",
            rank_pair,
            Text(fmt_pct(p.skew_pct), style=skew_style),
        )
    return table


def _rank_breakdown(view: StepTimeView) -> Optional[Table]:
    """rank × phase window-average matrix — only for small worlds where
    the table is readable; large worlds rely on worst/skew columns."""
    ranks = sorted(view.per_rank_avg_ms)
    if not 1 < len(ranks) <= _MAX_RANK_COLUMNS:
        return None
    phase_keys = [p.key for p in view.phases if p.key != STEP_KEY]
    table = Table(expand=True, box=None, pad_edge=False, title="per-rank avg (ms)")
    table.add_column("rank", justify="right")
    for k in [STEP_KEY] + phase_keys:
        table.add_column(k.replace("_time", ""), justify="right")
    for r in ranks:
        avgs = view.per_rank_avg_ms[r]
        cells = [f"{avgs.get(k, 0.0):.1f}" for k in [STEP_KEY] + phase_keys]
        table.add_row(str(r), *cells)
    return table


def step_time_panel(payload: Dict[str, Any]) -> Panel:
    view: Optional[StepTimeView] = (payload.get("views") or {}).get("step_time")
    if view is None:
        return Panel(
            Text("waiting for step telemetry…", style="dim"), title="step time"
        )
    parts = [_phase_table(view)]
    breakdown = _rank_breakdown(view)
    if breakdown is not None:
        parts.append(breakdown)
    cov = view.coverage
    sub = (
        f"{view.n_steps} steps · {view.clock} clock · "
        f"{cov.ranks_present}/{cov.world_size} ranks"
    )
    if view.median_occupancy is not None:
        sub += f" · chip busy {view.median_occupancy * 100:.0f}%"
    eff = view.efficiency
    if eff:
        if eff.get("achieved_tflops_median") is not None:
            sub += f" · {eff['achieved_tflops_median']:.1f} TFLOP/s"
            if eff.get("mfu_median") is not None:
                sub += f" (MFU {eff['mfu_median'] * 100:.0f}%)"
        if eff.get("tokens_per_sec_median") is not None:
            sub += f" · {eff['tokens_per_sec_median']:,.0f} tok/s"
    if cov.incomplete:
        sub += " · INCOMPLETE"
    return Panel(Group(*parts), title="step time", subtitle=sub)
