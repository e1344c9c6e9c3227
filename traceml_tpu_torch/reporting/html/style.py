"""The HTML report's chrome: its CSS and functional colors.

Counterpart of ``traceml_tpu/reporting/html/style.py`` (copied).  A
print-friendly light theme (the report is attached to tickets and
printed) with the same phase and severity palette as the CLI panels and
the browser dashboard: the colors carry meaning across surfaces.
"""

from __future__ import annotations

SEV_COLOR = {"critical": "#c0392b", "warning": "#e67e22", "info": "#2d7dd2"}

PHASE_COLORS = {
    "input": "#e74c3c",
    "h2d": "#e67e22",
    "forward": "#2d7dd2",
    "backward": "#2255a4",
    "optimizer": "#7d3dd2",
    "compute": "#2d7dd2",
    "compile": "#f1c40f",
    "collective": "#16a085",
    "checkpoint": "#8e5a2b",
    "residual": "#95a5a6",
}

CSS = """
body{font-family:system-ui,-apple-system,sans-serif;margin:2rem auto;
     max-width:980px;color:#1a1a2e;background:#fafafa;padding:0 1rem}
h1{font-size:1.4rem}
h2{font-size:1.1rem;margin-top:2rem;border-bottom:1px solid #ddd;
   padding-bottom:.3rem}
.verdict{border-radius:10px;padding:1rem 1.25rem;color:#fff;margin:1rem 0}
.verdict small{opacity:.85}
.verdict .ev{margin-top:.5rem;font-size:.8rem;opacity:.92;
  font-family:ui-monospace,Menlo,monospace}
table{border-collapse:collapse;width:100%;font-size:.9rem}
th,td{text-align:left;padding:.35rem .6rem;border-bottom:1px solid #eee}
th{background:#f0f0f5;font-weight:600}
td.num,th.num{text-align:right;font-variant-numeric:tabular-nums}
.bar{height:18px;border-radius:3px;display:inline-block;vertical-align:middle}
.muted{color:#777;font-size:.85rem}
code{background:#eee;padding:.05rem .3rem;border-radius:3px}
.kpis{display:flex;gap:10px;flex-wrap:wrap;margin:.8rem 0}
.kpi{background:#fff;border:1px solid #e4e4ec;border-left:4px solid
  var(--acc,#2d7dd2);border-radius:8px;padding:.5rem .8rem;min-width:110px}
.klab{font-size:.65rem;letter-spacing:.08em;text-transform:uppercase;
  color:#888;font-weight:600}
.kval{font-size:1.15rem;font-weight:600;font-variant-numeric:tabular-nums}
.kunit{font-size:.7em;color:#999;margin-left:2px}
.chips{margin:.6rem 0}
.chip{display:inline-block;font-size:.72rem;border-radius:999px;
  padding:.15rem .6rem;background:#ececf2;margin-right:.35rem}
.pill{display:inline-block;font-size:.7rem;font-weight:600;color:#fff;
  border-radius:999px;padding:.1rem .55rem;text-transform:uppercase}
@media print{body{background:#fff}.kpi{break-inside:avoid}}
"""


def kpi(label: str, value: str, unit: str = "", accent: str = "#2d7dd2") -> str:
    """One KPI tile (matches the dashboard's tile treatment)."""
    u = f"<span class='kunit'>{unit}</span>" if unit else ""
    return (
        f"<div class='kpi' style='--acc:{accent}'>"
        f"<div class='klab'>{label}</div>"
        f"<div class='kval'>{value}{u}</div></div>"
    )
