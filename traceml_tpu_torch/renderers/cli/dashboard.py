"""Live CLI dashboard composition.

Counterpart of ``traceml_tpu/renderers/cli/dashboard.py``: a header with
the staleness badge and the rank liveness strip, then the panels in the
JAX order (step time first, then findings, then resources; the cluster
panel only in multi-node runs).  The JAX header's mesh strip waits for
the mesh topology (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import time
from typing import Any, Dict

from rich.console import Group
from rich.text import Text

from traceml_tpu_torch.renderers.cli.diagnostics import diagnostics_panel
from traceml_tpu_torch.renderers.cli.memory import step_memory_panel
from traceml_tpu_torch.renderers.cli.output import stdout_panel
from traceml_tpu_torch.renderers.cli.process import process_panel
from traceml_tpu_torch.renderers.cli.step_time import step_time_panel
from traceml_tpu_torch.renderers.cli.system import cluster_panel, system_panel


_STATE_STYLE = {
    "active": "green",
    "finished": "dim",
    "stale": "yellow",
    "lost": "bold red",
}


def _append_rank_strip(header: Text, payload: Dict[str, Any]) -> None:
    """Per-rank liveness strip in the header: which ranks the live
    numbers actually average (a STALE/LOST rank silently shrinks every
    cross-rank aggregate — the strip makes that visible)."""
    status = payload.get("rank_status") or {}
    states = status.get("states") or {}
    if not states:
        return
    counts: Dict[str, int] = {}
    for s in states.values():
        counts[s] = counts.get(s, 0) + 1
    header.append("   ranks: ", style="dim")
    first = True
    for state in ("active", "finished", "stale", "lost"):
        n = counts.get(state, 0)
        if n == 0:
            continue
        if not first:
            header.append(" · ", style="dim")
        first = False
        header.append(f"{n} {state}", style=_STATE_STYLE.get(state, ""))
    lost = sorted(int(r) for r, s in states.items() if s == "lost")
    if lost:
        shown = ",".join(str(r) for r in lost[:8])
        more = "…" if len(lost) > 8 else ""
        header.append(f" (rank {shown}{more})", style="red")


def dashboard(payload: Dict[str, Any], session: str) -> Group:
    header = Text(f"TraceML (PyTorch) — live · session {session}", style="bold")
    # staleness = age of the NEWEST telemetry row, not of the payload
    # (the payload is recomputed every tick regardless)
    ts = payload.get("latest_row_ts")
    if ts:
        age = time.time() - ts
        if age > 5.0:
            header.append(f"   ⚠ telemetry {age:.0f}s stale", style="yellow")
    _append_rank_strip(header, payload)
    parts = [header, step_time_panel(payload), diagnostics_panel(payload)]
    cluster = cluster_panel(payload)
    if cluster is not None:
        parts.append(cluster)
    parts += [
        step_memory_panel(payload),
        system_panel(payload),
        process_panel(payload),
        stdout_panel(payload),
    ]
    return Group(*parts)
