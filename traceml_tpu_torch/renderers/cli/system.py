"""System CLI panels.

Counterpart of ``traceml_tpu/renderers/cli/system.py`` (copied): the
per-node table, the device table, and the multi-node cluster rollup.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from rich.console import Group
from rich.panel import Panel
from rich.table import Table
from rich.text import Text

from traceml_tpu_torch.renderers.views import SystemView
from traceml_tpu_torch.utils.formatting import fmt_bytes, fmt_pct


def _node_table(view: SystemView) -> Table:
    table = Table(expand=True, box=None)
    table.add_column("node")
    table.add_column("cpu", justify="right")
    table.add_column("host mem", justify="right")
    table.add_column("load", justify="right")
    table.add_column("", justify="right")  # staleness flag
    for n in view.nodes:
        used, total = n.memory_used_bytes, n.memory_total_bytes
        frac = used / total if used and total else None
        mem = f"{fmt_bytes(used)} / {fmt_bytes(total)}"
        if frac is not None:
            mem += f" ({fmt_pct(frac)})"
        table.add_row(
            f"{n.hostname} (#{n.node_rank})",
            f"{n.cpu_pct:.0f}%" if n.cpu_pct is not None else "n/a",
            mem,
            f"{n.load_1m:.1f}" if n.load_1m is not None else "—",
            Text("stale", style="yellow") if n.stale else "",
        )
    return table


def _device_table(view: SystemView) -> Optional[Table]:
    rows = [(n, d) for n in view.nodes for d in n.devices]
    if not rows:
        return None
    table = Table(expand=True, box=None, title="devices")
    table.add_column("node")
    table.add_column("dev", justify="right")
    table.add_column("kind")
    table.add_column("mem", justify="right")
    table.add_column("util", justify="right")
    table.add_column("temp", justify="right")
    table.add_column("power", justify="right")
    for n, d in rows:
        util = f"{d.utilization_pct:.0f}%" if d.utilization_pct is not None else "—"
        temp = f"{d.temperature_c:.0f}°C" if d.temperature_c is not None else "—"
        power = f"{d.power_w:.0f}W" if d.power_w is not None else "—"
        mem = (
            f"{fmt_bytes(d.memory_used_bytes)} / {fmt_bytes(d.memory_total_bytes)}"
            if d.memory_used_bytes is not None
            else "—"
        )
        table.add_row(n.hostname, str(d.device_id), d.device_kind, mem, util, temp, power)
    return table


def system_panel(payload: Dict[str, Any]) -> Panel:
    view: Optional[SystemView] = (payload.get("views") or {}).get("system")
    if view is None:
        return Panel(Text("no system telemetry", style="dim"), title="system")
    parts = [_node_table(view)]
    devices = _device_table(view)
    if devices is not None:
        parts.append(devices)
    return Panel(Group(*parts), title="system")


def cluster_panel(payload: Dict[str, Any]) -> Optional[Panel]:
    """min/median/max rollups across nodes — only rendered for clusters
    (reference: system/cli_cluster.py SystemCLIClusterBuilder.build)."""
    view: Optional[SystemView] = (payload.get("views") or {}).get("system")
    if view is None or not view.is_cluster:
        return None
    table = Table(expand=True, box=None)
    table.add_column("metric")
    table.add_column("min", justify="right")
    table.add_column("median", justify="right")
    table.add_column("max", justify="right")
    table.add_column("max node")
    fmt = {
        "cpu_pct": lambda v: f"{v:.0f}%",
        "memory_pct": lambda v: f"{v:.0f}%",
        "load_1m": lambda v: f"{v:.1f}",
    }
    for r in view.rollups:
        f = fmt.get(r.metric, lambda v: f"{v:.2f}")
        table.add_row(r.metric, f(r.min_value), f(r.median_value), f(r.max_value), r.max_node)
    sub = f"{len(view.nodes)}/{view.expected_nodes} nodes"
    if view.missing_nodes:
        sub += f" · {view.missing_nodes} MISSING"
    return Panel(table, title="cluster", subtitle=sub)
