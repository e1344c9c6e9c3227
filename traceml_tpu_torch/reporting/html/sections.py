"""Per-domain section builders for the HTML report.

Counterpart of ``traceml_tpu/reporting/html/sections.py``; its one label
change: the occupancy tile reads "GPU busy" (JAX: "chip busy").

Every builder takes the final-summary payload and returns an HTML
fragment, or "" when its section has nothing to show: the report
degrades section by section, as the JSON does.  Every string from the
payload goes through ``html.escape`` (hostnames, rank keys and diagnosis
text come from an unauthenticated ingest port).
"""

from __future__ import annotations

import html
from typing import Any, Dict, List

from traceml_tpu_torch.reporting.html.style import SEV_COLOR, kpi
from traceml_tpu_torch.reporting.html.svg import (
    median_worst_bars,
    phase_share_bar,
    step_series_svg,
)
from traceml_tpu_torch.utils.formatting import fmt_bytes, fmt_ms


def _esc(x: Any) -> str:
    return html.escape(str(x))


def _sec(payload: Dict[str, Any], key: str) -> Dict[str, Any]:
    return (payload.get("sections") or {}).get(key) or {}


def build_banner(payload: Dict[str, Any]) -> str:
    """Verdict banner: kind, severity, summary, action, and the
    evidence key-values that justify the verdict (reference banner.py
    role — the numbers behind the words, not just the words)."""
    primary = payload.get("primary_diagnosis") or {}
    color = SEV_COLOR.get(primary.get("severity", "info"), "#2d7dd2")
    ev = primary.get("evidence") or {}
    ev_items = []
    for k, v in list(ev.items())[:8]:
        # format to plain text first; ONE escape at append time (inner
        # escaping here would double-encode in the final _esc)
        if isinstance(v, float):
            v = f"{v:.3g}"
        elif isinstance(v, dict):
            v = "{" + ", ".join(
                f"{ik}: {iv:.3g}" if isinstance(iv, float)
                else f"{ik}: {iv}"
                for ik, iv in list(v.items())[:6]
            ) + "}"
        ev_items.append(f"{_esc(k)}={_esc(v)}")
    ranks = primary.get("ranks")
    return (
        f"<div class='verdict' style='background:{color}'>"
        f"<strong>{_esc(primary.get('kind'))}</strong>"
        f" <small>[{_esc(primary.get('severity'))}]</small>"
        + (f" <small>ranks {_esc(ranks)}</small>" if ranks else "")
        + f"<br>{_esc(primary.get('summary', ''))}"
        + (
            f"<br><small>→ {_esc(primary.get('action'))}</small>"
            if primary.get("action")
            else ""
        )
        + (f"<div class='ev'>{' · '.join(ev_items)}</div>" if ev_items else "")
        + "</div>"
    )


def build_status_chips(payload: Dict[str, Any]) -> str:
    """Per-section status chips — which domains actually reported."""
    chips = []
    for key, sec in (payload.get("sections") or {}).items():
        status = sec.get("status", "?")
        diag = (sec.get("diagnosis") or {}).get("kind", "")
        chips.append(
            f"<span class='chip'>{_esc(key)}: {_esc(status)}"
            + (f" · {_esc(diag)}" if diag and status == "OK" else "")
            + "</span>"
        )
    return f"<div class='chips'>{''.join(chips)}</div>" if chips else ""


def build_step_time(payload: Dict[str, Any]) -> str:
    st = _sec(payload, "step_time")
    g = st.get("global") or {}
    phases = g.get("phases") or {}
    series = g.get("step_series_ms") or {}
    if not phases and not series:
        return ""
    out: List[str] = []

    # KPI strip: the numbers a capacity plan reads first
    step = phases.get("step_time") or {}
    steady = g.get("steady_state") or {}
    eff = g.get("efficiency") or {}
    tiles = []
    if step.get("median_ms") is not None:
        tiles.append(kpi("median step", f"{step['median_ms']:.1f}", "ms"))
    if steady.get("median_ms") is not None:
        tiles.append(kpi("steady state", f"{steady['median_ms']:.1f}", "ms",
                         "#16a085"))
    occ = g.get("median_occupancy")
    if occ is not None:
        tiles.append(kpi("GPU busy", f"{occ * 100:.0f}", "%", "#7d3dd2"))
    if eff.get("achieved_tflops_median") is not None:
        tiles.append(kpi("achieved", f"{eff['achieved_tflops_median']:.1f}",
                         "TFLOP/s", "#e67e22"))
    if eff.get("mfu_median") is not None:
        tiles.append(kpi("MFU", f"{eff['mfu_median'] * 100:.0f}", "%",
                         "#c0392b"))
    if eff.get("tokens_per_sec_median") is not None:
        tiles.append(kpi("tokens", f"{eff['tokens_per_sec_median']:,.0f}",
                         "tok/s", "#2255a4"))
    if step.get("skew_pct") is not None:
        tiles.append(kpi("rank gap", f"{step['skew_pct'] * 100:.0f}", "%",
                         "#f1c40f"))

    out.append("<h2>Step time</h2>")
    sub = f"{_esc(g.get('n_steps'))} steps, {_esc(g.get('clock'))} clock"
    infl = steady.get("warmup_inflation_pct")
    if infl is not None and infl > 0.02:
        sub += f" · warmup inflated the overall median {infl * 100:.0f}%"
    out.append(f"<p class='muted'>{sub}</p>")
    if tiles:
        out.append(f"<div class='kpis'>{''.join(tiles)}</div>")
    if eff and eff.get("flops_per_step"):
        line = (
            f"model {eff['flops_per_step'] / 1e12:.2f} TFLOP/step"
            f" ({_esc(eff.get('flops_source'))})"
        )
        if eff.get("peak_tflops"):
            line += (
                f" · peak {eff['peak_tflops']:.0f} TFLOP/s ×"
                f" {int(eff.get('device_count') or 1)} "
                f"{_esc(eff.get('device_kind'))}"
            )
        out.append(f"<p class='muted'>{line}</p>")

    if series:
        out.append(step_series_svg(series))
    if phases:
        out.append(phase_share_bar(phases))
        out.append(
            "<table><tr><th>phase</th><th class='num'>median</th>"
            "<th class='num'>share</th><th class='num'>worst rank</th>"
            "<th class='num'>skew</th></tr>"
        )
        for key, info in phases.items():
            share = info.get("share_of_step")
            out.append(
                f"<tr><td>{_esc(key)}</td>"
                f"<td class='num'>{fmt_ms(info.get('median_ms'))}</td>"
                f"<td class='num'>{'' if share is None else f'{share * 100:.1f}%'}</td>"
                f"<td class='num'>{_esc(info.get('worst_rank'))}</td>"
                f"<td class='num'>{(info.get('skew_pct') or 0) * 100:.1f}%</td></tr>"
            )
        out.append("</table>")

    # median→worst spread per phase with owning ranks (uniform rollup)
    rollup = g.get("rollup") or {}
    if rollup.get("median"):
        bars = median_worst_bars(rollup)
        if bars:
            out.append("<h2>Cross-rank spread (median → worst)</h2>")
            out.append(bars)

    out.append(_per_rank_matrix(g, phases))
    return "".join(out)


def _per_rank_matrix(g: Dict[str, Any], phases: Dict[str, Any]) -> str:
    rank_cards = g.get("per_rank") or {}
    if not (1 < len(rank_cards) <= 8 and phases):
        return ""
    phase_keys = [k for k in phases if k != "step_time"]
    show_host = any(
        (c.get("identity") or {}).get("hostname") for c in rank_cards.values()
    )
    out = ["<h2>Per-rank breakdown (window avg, ms)</h2><table><tr>"
           "<th>rank</th>" + ("<th>host</th>" if show_host else "")
           + "<th class='num'>step</th>"
           + "".join(f"<th class='num'>{_esc(k)}</th>" for k in phase_keys)
           + "<th class='num'>busy</th></tr>"]
    for rank, card in sorted(rank_cards.items(), key=lambda kv: int(kv[0])):
        avgs = card.get("avg_ms") or {}
        occ_r = card.get("occupancy")
        ident = card.get("identity") or {}
        if show_host:
            host_cell = (
                f"<td>{_esc(ident.get('hostname'))}"
                f"#{_esc(ident.get('node_rank'))}</td>"
                if ident.get("hostname")
                else "<td></td>"
            )
        else:
            host_cell = ""
        out.append(
            f"<tr><td>{_esc(rank)}</td>" + host_cell
            + f"<td class='num'>{avgs.get('step_time', 0):.1f}</td>"
            + "".join(
                f"<td class='num'>{avgs.get(k, 0):.1f}</td>"
                for k in phase_keys
            )
            + f"<td class='num'>{'' if occ_r is None else f'{occ_r * 100:.0f}%'}</td></tr>"
        )
    out.append("</table>")
    return "".join(out)


def build_step_memory(payload: Dict[str, Any]) -> str:
    sm = _sec(payload, "step_memory")
    per_rank = (sm.get("global") or {}).get("per_rank") or {}
    if not per_rank:
        return ""
    out = ["<h2>Device memory</h2><table><tr><th>rank</th>"
           "<th class='num'>current</th><th class='num'>peak</th>"
           "<th class='num'>limit</th><th class='num'>pressure</th>"
           "<th class='num'>growth</th><th class='num'>trend</th></tr>"]
    for rank, info in sorted(per_rank.items(), key=lambda kv: int(kv[0])):
        pressure = info.get("pressure")
        growth = info.get("growth_bytes")
        trend = (info.get("trend") or {}).get("trend_pct")
        out.append(
            f"<tr><td>{_esc(rank)}</td>"
            f"<td class='num'>{fmt_bytes(info.get('current_bytes'))}</td>"
            f"<td class='num'>{fmt_bytes(info.get('step_peak_bytes'))}</td>"
            f"<td class='num'>{fmt_bytes(info.get('limit_bytes'))}</td>"
            f"<td class='num'>{'' if pressure is None else f'{pressure * 100:.0f}%'}</td>"
            f"<td class='num'>{'' if not growth else ('+' if growth > 0 else '') + fmt_bytes(growth)}</td>"
            f"<td class='num'>{'' if trend is None else f'{trend * 100:+.1f}%'}</td>"
            f"</tr>"
        )
    out.append("</table>")
    rollup = (sm.get("global") or {}).get("rollup") or {}
    if rollup:
        bits = [
            f"total {fmt_bytes(rollup.get('total_current_bytes'))}",
            f"max peak {fmt_bytes(rollup.get('max_peak_bytes'))}",
        ]
        worst = (rollup.get("worst") or {}).get("step_peak_bytes") or {}
        med = (rollup.get("median") or {}).get("step_peak_bytes") or {}
        if worst.get("idx") is not None:
            bits.append(
                f"peak median/worst r{_esc(med.get('idx'))}/r{_esc(worst.get('idx'))}"
            )
        skew = rollup.get("peak_skew_pct")
        if skew is not None:
            bits.append(f"peak skew {skew * 100:.0f}%")
        out.append(f"<p class='muted'>{' · '.join(bits)}</p>")
    return "".join(out)


def build_system(payload: Dict[str, Any]) -> str:
    sysg = (_sec(payload, "system")).get("global") or {}
    nodes = sysg.get("nodes") or {}
    if not nodes:
        return ""

    def _node_key(kv):
        try:
            return (0, int(kv[0]))
        except (TypeError, ValueError):
            return (1, kv[0])

    out = ["<h2>System</h2><table><tr><th>node</th>"
           "<th class='num'>cpu mean/max</th><th class='num'>host mem</th>"
           "<th class='num'>load</th></tr>"]
    for node, info in sorted(nodes.items(), key=_node_key):
        cpu_m, cpu_x = info.get("cpu_pct_mean"), info.get("cpu_pct_max")
        load = info.get("load_1m")
        out.append(
            f"<tr><td>{_esc(info.get('hostname'))} (#{_esc(node)})</td>"
            f"<td class='num'>{'' if cpu_m is None else f'{cpu_m:.0f}%'}/"
            f"{'' if cpu_x is None else f'{cpu_x:.0f}%'}</td>"
            f"<td class='num'>{fmt_bytes(info.get('memory_used_bytes'))} / "
            f"{fmt_bytes(info.get('memory_total_bytes'))}</td>"
            f"<td class='num'>{'—' if load is None else _esc(load)}</td></tr>"
        )
    out.append("</table>")
    cluster = sysg.get("cluster")
    if cluster:
        out.append(
            f"<p class='muted'>cluster: {cluster['n_nodes']} nodes · host "
            f"CPU {cluster['cpu_pct_min']:.0f}/"
            f"{cluster['cpu_pct_median']:.0f}/{cluster['cpu_pct_max']:.0f}% "
            f"(min/median/max, busiest {_esc(cluster.get('busiest_node'))})</p>"
        )
    return "".join(out)


def build_process(payload: Dict[str, Any]) -> str:
    procg = (_sec(payload, "process")).get("global") or {}
    pranks = procg.get("per_rank") or {}
    if not pranks:
        return ""
    out = ["<h2>Processes</h2><table><tr><th>rank</th><th class='num'>pid</th>"
           "<th class='num'>cpu mean/max</th><th class='num'>rss / peak</th>"
           "<th class='num'>threads</th></tr>"]
    for rank, info in sorted(pranks.items(), key=lambda kv: int(kv[0])):
        cpu_m, cpu_x = info.get("cpu_pct_mean"), info.get("cpu_pct_max")
        out.append(
            f"<tr><td>{_esc(rank)}</td>"
            f"<td class='num'>{_esc(info.get('pid') or '—')}</td>"
            f"<td class='num'>{'' if cpu_m is None else f'{cpu_m:.0f}%'}/"
            f"{'' if cpu_x is None else f'{cpu_x:.0f}%'}</td>"
            f"<td class='num'>{fmt_bytes(info.get('rss_bytes'))} / "
            f"{fmt_bytes(info.get('rss_peak_bytes'))}</td>"
            f"<td class='num'>{_esc(info.get('num_threads') or '—')}</td></tr>"
        )
    out.append("</table>")
    rollup = procg.get("rollup") or {}
    if rollup:
        bits = [f"total rss {fmt_bytes(rollup.get('total_rss_bytes'))}"]
        if rollup.get("busiest_rank") is not None:
            bits.append(f"busiest r{_esc(rollup['busiest_rank'])}")
        out.append(f"<p class='muted'>{' · '.join(bits)}</p>")
    return "".join(out)


def build_findings(payload: Dict[str, Any]) -> str:
    out = ["<h2>All findings</h2><table><tr><th>domain</th><th>kind</th>"
           "<th>severity</th><th>summary</th></tr>"]
    n = 0
    for key, sec in (payload.get("sections") or {}).items():
        for issue in sec.get("issues") or []:
            n += 1
            out.append(
                f"<tr><td>{_esc(key)}</td><td>{_esc(issue.get('kind'))}</td>"
                f"<td style='color:{SEV_COLOR.get(issue.get('severity'), '#333')}'>"
                f"{_esc(issue.get('severity'))}</td>"
                f"<td>{_esc(issue.get('summary'))}</td></tr>"
            )
    out.append("</table>")
    return "".join(out) if n else ""
