"""Inline-SVG chart builders for the HTML report.

Counterpart of ``traceml_tpu/reporting/html/svg.py`` (copied):
dependency-free charts that open anywhere, survive attachment to an
email or a ticket, and print.
"""

from __future__ import annotations

import html
from typing import Any, Dict, List, Optional

from traceml_tpu_torch.reporting.html.style import PHASE_COLORS

_HUES = [210, 0, 120, 280, 30, 170, 330, 60]


def _esc(x: Any) -> str:
    return html.escape(str(x))


def step_series_svg(
    series: Dict[str, Any], width: int = 900, height: int = 120
) -> str:
    """One polyline per rank over the aligned step window, shared scale."""
    all_vals = [v for vs in series.values() for v in vs if v is not None]
    if not all_vals:
        return ""
    vmax = max(all_vals) or 1.0
    lines = []
    for i, (rank, vs) in enumerate(
        sorted(series.items(), key=lambda kv: int(kv[0]))
    ):
        if not vs:
            continue
        n = len(vs)
        pts = " ".join(
            f"{(j / max(1, n - 1)) * width:.1f},"
            f"{height - 4 - (v / vmax) * (height - 10):.1f}"
            for j, v in enumerate(vs)
        )
        hue = _HUES[i % len(_HUES)]
        lines.append(
            f'<polyline fill="none" stroke="hsl({hue},65%,45%)" '
            f'stroke-width="1.2" points="{pts}"><title>rank {_esc(rank)}'
            f"</title></polyline>"
        )
    legend = " ".join(
        f'<tspan fill="hsl({_HUES[i % len(_HUES)]},65%,45%)">rank {_esc(r)}</tspan>'
        for i, r in enumerate(sorted(series, key=int))
    )
    return (
        f'<svg viewBox="0 0 {width} {height}" '
        f'style="width:100%;height:{height}px;background:#f4f4f8;'
        f'border-radius:6px">{"".join(lines)}'
        f'<text x="6" y="14" font-size="11">{legend} · max {vmax:.1f} ms</text>'
        f"</svg>"
    )


def phase_share_bar(phases: Dict[str, Any]) -> str:
    """One stacked horizontal share bar + legend."""
    parts: List[str] = []
    total = 0.0
    for key, info in phases.items():
        if key == "step_time":
            continue
        share = info.get("share_of_step")
        if not share or share <= 0:
            continue
        share = min(share, 1.0 - total)
        total += share
        color = PHASE_COLORS.get(key, "#888")
        parts.append(
            f'<span class="bar" title="{_esc(key)}: {share * 100:.1f}%" '
            f'style="width:{share * 100:.2f}%;background:{color}"></span>'
        )
    legend = " ".join(
        f'<span class="muted"><span class="bar" style="width:10px;'
        f'background:{PHASE_COLORS.get(k, "#888")}"></span> {_esc(k)}</span>'
        for k in phases
        if k != "step_time"
    )
    return (
        f'<div style="width:100%;background:#eee;border-radius:3px">'
        f'{"".join(parts)}</div><div>{legend}</div>'
    )


def median_worst_bars(
    rollup: Dict[str, Any],
    *,
    unit: str = "ms",
    width: int = 900,
    row_h: int = 22,
    exclude: tuple = ("step_time",),
) -> str:
    """Per-metric median→worst range bars from the uniform rollup:
    each row draws median (solid) and worst (hatched extension) on a
    shared scale with both ranks labeled — the spread AND its owners
    in one glance."""
    med = rollup.get("median") or {}
    wor = rollup.get("worst") or {}
    keys = [
        k for k in med
        if k not in exclude and (med[k] or {}).get("value") is not None
    ]
    if not keys:
        return ""
    vmax = max((wor.get(k) or {}).get("value") or 0 for k in keys) or 1.0
    rows = []
    label_w = 110
    bar_w = width - label_w - 180
    for i, k in enumerate(sorted(keys, key=lambda k: -(
        (wor.get(k) or {}).get("value") or 0
    ))):
        m, w = med[k], wor.get(k) or {}
        mv, wv = m.get("value") or 0.0, w.get("value") or 0.0
        y = i * row_h
        color = PHASE_COLORS.get(k, "#2d7dd2")
        m_px = bar_w * mv / vmax
        w_px = bar_w * max(wv - mv, 0) / vmax
        rows.append(
            f'<text x="0" y="{y + 14}" font-size="11">{_esc(k)}</text>'
            f'<rect x="{label_w}" y="{y + 4}" width="{m_px:.1f}" height="12" '
            f'rx="2" fill="{color}"><title>median {mv:.1f} {unit} '
            f"(r{_esc(m.get('idx'))})</title></rect>"
            f'<rect x="{label_w + m_px:.1f}" y="{y + 4}" width="{w_px:.1f}" '
            f'height="12" rx="2" fill="{color}" opacity="0.38">'
            f"<title>worst {wv:.1f} {unit} (r{_esc(w.get('idx'))})</title></rect>"
            f'<text x="{label_w + m_px + w_px + 6:.1f}" y="{y + 14}" '
            f'font-size="10" fill="#666">{mv:.1f}/{wv:.1f} {unit} · '
            f"r{_esc(m.get('idx'))}/r{_esc(w.get('idx'))}</text>"
        )
    h = len(keys) * row_h + 6
    return (
        f'<svg viewBox="0 0 {width} {h}" style="width:100%;height:{h}px">'
        f'{"".join(rows)}</svg>'
        '<div class="muted">solid = median rank · faded extension = worst '
        "rank (values and owning ranks in the hover/labels)</div>"
    )


def sparkline(
    values: List[float], width: int = 100, height: int = 18,
    color: str = "#2d7dd2", vmax: Optional[float] = None,
) -> str:
    """Tiny inline sparkline for table cells."""
    vals = [v for v in values if v is not None]
    if len(vals) < 2:
        return "—"
    m = vmax or max(vals) or 1.0
    pts = " ".join(
        f"{(i / (len(vals) - 1)) * width:.1f},"
        f"{height - 2 - (v / m) * (height - 4):.1f}"
        for i, v in enumerate(vals)
    )
    return (
        f'<svg width="{width}" height="{height}" '
        f'viewBox="0 0 {width} {height}"><polyline fill="none" '
        f'stroke="{color}" stroke-width="1" points="{pts}"/></svg>'
    )
