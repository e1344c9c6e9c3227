"""The self-contained HTML summary, ``final_summary.html``.

Counterpart of ``traceml_tpu/reporting/html/writer.py``: no JS, inline
SVG charts, one file that opens anywhere.  ``style.py`` owns the chrome
and the functional colors, ``svg.py`` the charts, ``sections.py`` the
per-domain fragments; this module composes the document and writes it
atomically.  The title and heading name the port as its text report
does, "TraceML (PyTorch)" (JAX: "TraceML-TPU").
"""

from __future__ import annotations

import html
from pathlib import Path
from typing import Any, Dict

from traceml_tpu_torch.reporting.html.sections import (
    build_banner,
    build_findings,
    build_process,
    build_status_chips,
    build_step_memory,
    build_step_time,
    build_system,
)
from traceml_tpu_torch.reporting.html.style import CSS
from traceml_tpu_torch.utils.atomic_io import atomic_write_text

PRODUCT = "TraceML (PyTorch)"


def _esc(x: Any) -> str:
    return html.escape(str(x))


def render_html_summary(payload: Dict[str, Any]) -> str:
    meta = payload.get("meta") or {}
    topo = meta.get("topology") or {}
    out = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{PRODUCT} — {_esc(meta.get('session_id', 'summary'))}</title>",
        f"<style>{CSS}</style></head><body>",
        f"<h1>{PRODUCT} — final training summary</h1>",
        f"<p class='muted'>session <code>{_esc(meta.get('session_id'))}</code>"
        f" · mode {_esc(topo.get('mode'))}"
        f" · world size {_esc(topo.get('world_size'))}</p>",
        build_banner(payload),
        build_status_chips(payload),
        build_step_time(payload),
        build_step_memory(payload),
        build_system(payload),
        build_process(payload),
        build_findings(payload),
    ]
    stats = meta.get("telemetry_stats") or {}
    if stats:
        out.append(
            "<p class='muted'>telemetry: "
            + " · ".join(f"{_esc(k)} {_esc(v)}" for k, v in stats.items())
            + "</p>"
        )
    out.append("</body></html>")
    return "".join(out)


def write_html_summary(payload: Dict[str, Any], path: Path) -> None:
    atomic_write_text(path, render_html_summary(payload))
