"""Final summary generator.

Counterpart of ``traceml_tpu/reporting/final.py`` for the step-time and
step-memory domains.  Reads the SQLite projections through
``reporting/loaders.py``, builds the step-time window with the scalar
``utils/step_time_window.py`` (the JAX package's golden reference arm),
runs each domain's diagnosis, promotes a run-level primary diagnosis,
and writes ``final_summary.json`` and ``final_summary.txt`` atomically.
A failed section degrades to a NO_DATA payload: the report never fails
because one domain did.

The ``system``, ``process``, ``collectives`` and ``liveness`` sections
are NO_DATA stubs (their samplers come later), and the payload leaves
out what the JAX report adds only when it has something for it: the
cross-run ``regressions``, the stitched ``history`` and
``meta.window_build``; no HTML artifact is written yet.
"""

from __future__ import annotations

import statistics
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

from traceml_tpu_torch.analytics.trends.core import compute_window_trend
from traceml_tpu_torch.diagnostics.common import DiagnosticResult
from traceml_tpu_torch.diagnostics.step_memory.api import diagnose_rank_rows as diagnose_memory
from traceml_tpu_torch.diagnostics.step_time.api import diagnose_window
from traceml_tpu_torch.reporting import loaders
from traceml_tpu_torch.reporting.primary_diagnosis import build_primary_diagnosis
from traceml_tpu_torch.reporting.rollup import build_rollup
from traceml_tpu_torch.sdk import protocol
from traceml_tpu_torch.utils.atomic_io import atomic_write_json, atomic_write_text, read_json
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.formatting import fmt_bytes, fmt_ms, fmt_pct
from traceml_tpu_torch.utils.step_time_window import (
    RESIDUAL_KEY,
    STEP_KEY,
    StepTimeWindow,
    build_step_time_window,
)

SCHEMA_VERSION = "traceml-tpu/1"
# the report's step window, out of the last WINDOW_READ_STEPS rows read per rank
REPORT_WINDOW_STEPS = 200
WINDOW_READ_STEPS = 600
MEMORY_READ_ROWS = 20000


def _no_data_section(key: str, error: Optional[str] = None) -> Dict[str, Any]:
    out: Dict[str, Any] = {"status": "NO_DATA", "diagnosis": None, "issues": []}
    if error:
        out["error"] = error
    return out


def _safe_section(key: str, builder: Callable[[], Dict[str, Any]]) -> Dict[str, Any]:
    try:
        section = builder()
        return section if section is not None else _no_data_section(key)
    except Exception as exc:
        get_error_log().warning(f"summary section {key} failed", exc)
        return _no_data_section(key, error=str(exc))


# -- section builders ----------------------------------------------------


def _steady_state(window: StepTimeWindow) -> Dict[str, Any]:
    """Warmup vs steady-state split: the first quarter of the window
    carries warm-up effects; steady-state medians are the number a
    capacity plan should use."""
    if window.n_steps < 12:
        return {}
    cut = max(3, window.n_steps // 4)
    per_rank_steady = {}
    for r, w in window.rank_windows.items():
        vals = w.series[STEP_KEY][cut:]
        if vals:
            per_rank_steady[str(r)] = statistics.median(vals)
    if not per_rank_steady:
        return {}
    overall = statistics.median(per_rank_steady.values())
    step_m = window.metric(STEP_KEY)
    return {
        "warmup_steps_excluded": cut,
        "median_ms": overall,
        "per_rank_median_ms": per_rank_steady,
        "warmup_inflation_pct": (step_m.median_ms - overall) / overall if overall > 0 else None,
    }


def _build_step_time_section(rank_rows, mode: str, identities=None):
    if not rank_rows:
        return _no_data_section("step_time"), None
    window = build_step_time_window(rank_rows, max_steps=REPORT_WINDOW_STEPS)
    steady = _steady_state(window) if window else {}
    # MFU needs model FLOPs, which come with FLOPs counting in a later
    # slice: no efficiency block yet
    efficiency = None
    result = diagnose_window(window, mode=mode, efficiency=efficiency)
    section: Dict[str, Any] = {
        "status": "OK" if window else "NO_DATA",
        "diagnosis": result.diagnosis.to_dict(),
        "issues": [i.to_dict() for i in result.issues],
        "units": {"time": "ms"},
    }
    if window:
        phases = {}
        for key in [STEP_KEY] + window.phases_present + [RESIDUAL_KEY]:
            m = window.metric(key)
            if m is None:
                continue
            phases[key] = {
                "median_ms": m.median_ms,
                "mean_ms": m.mean_ms,
                "worst_ms": m.worst_ms,
                "worst_rank": m.worst_rank,
                "skew_pct": m.skew_pct,
                "share_of_step": window.share_of_step(key),
                "per_rank_avg_ms": {str(r): v for r, v in m.per_rank_avg_ms.items()},
            }
        # short per-rank step series for charts
        tail = 120
        series = {
            str(r): [round(v, 3) for v in w.series[STEP_KEY][-tail:]]
            for r, w in window.rank_windows.items()
        }
        identities = identities or {}
        rank_cards = {
            str(r): {
                "identity": identities.get(r),
                "avg_ms": {k: round(v, 4) for k, v in w.averages.items()},
                "occupancy": w.occupancy,
                "steps_seen": len(w.steps),
            }
            for r, w in window.rank_windows.items()
        }
        rollup = build_rollup(
            {key: p["per_rank_avg_ms"] for key, p in phases.items()},
            window={
                "kind": "step_window",
                "alignment": "common_steps",
                "steps_analyzed": window.n_steps,
                "end_step": window.steps[-1],
            },
        )
        section["global"] = {
            "clock": window.clock,
            "n_steps": window.n_steps,
            "step_range": [window.steps[0], window.steps[-1]],
            "ranks": window.ranks,
            "efficiency": efficiency,
            "phases": phases,
            "rollup": rollup,
            "occupancy_by_rank": {str(r): round(v, 4) for r, v in window.occupancy_by_rank.items()},
            "median_occupancy": window.median_occupancy,
            "steady_state": steady or None,
            "per_rank": rank_cards,
            "step_series_ms": series,
            "step_series_steps": window.steps[-tail:],
        }
    return section, result


def _build_step_memory_section(rank_rows, identities=None):
    if not rank_rows:
        return _no_data_section("step_memory"), None
    result = diagnose_memory(rank_rows)
    identities = identities or {}
    per_rank = {}
    for rank, rows in rank_rows.items():
        if not rows:
            continue
        last = rows[-1]
        series = [r.get("current_bytes") or 0 for r in rows]
        peak = max((r.get("step_peak_bytes") or 0 for r in rows), default=0)
        limit = last.get("limit_bytes")
        first_cur = next((v for v in series if v), None)
        trend = compute_window_trend(series) if len(series) >= 8 else None
        per_rank[str(rank)] = {
            "identity": identities.get(rank),
            "devices": sorted({int(r.get("device_id") or 0) for r in rows}),
            "current_bytes": last.get("current_bytes"),
            "step_peak_bytes": peak,
            "limit_bytes": limit,
            "pressure": (peak / limit) if peak and limit else None,
            "mean_bytes": int(statistics.mean(series)) if series else 0,
            "growth_bytes": (
                (last.get("current_bytes") or 0) - first_cur if first_cur is not None else None
            ),
            "trend": {
                "trend_pct": trend.trend_pct,
                "slope_pct_per_100": trend.slope_pct_per_100,
                "recovered": trend.recovered,
            }
            if trend
            else None,
            "n_rows": len(rows),
        }
    peaks = [v["step_peak_bytes"] for v in per_rank.values() if v["step_peak_bytes"]]
    rollup = {
        "total_current_bytes": sum(v["current_bytes"] or 0 for v in per_rank.values()),
        "max_peak_bytes": max(peaks, default=0),
        "peak_skew_pct": (
            (max(peaks) - statistics.median(peaks)) / statistics.median(peaks)
            if len(peaks) > 1 and statistics.median(peaks) > 0
            else None
        ),
        **build_rollup({
            "step_peak_bytes": {r: v["step_peak_bytes"] for r, v in per_rank.items()},
            "current_bytes": {r: v["current_bytes"] for r, v in per_rank.items()},
        }),
    }
    section = {
        "status": "OK",
        "diagnosis": result.diagnosis.to_dict(),
        "issues": [i.to_dict() for i in result.issues],
        "global": {"per_rank": per_rank, "rollup": rollup},
        "units": {"memory": "bytes"},
    }
    return section, result


# -- text rendering ------------------------------------------------------


def _box(lines) -> str:
    width = max((len(l) for l in lines), default=0)
    top = "┌" + "─" * (width + 2) + "┐"
    bottom = "└" + "─" * (width + 2) + "┘"
    body = "\n".join(f"│ {l.ljust(width)} │" for l in lines)
    return f"{top}\n{body}\n{bottom}"


def _ident_suffix(info: Dict[str, Any]) -> str:
    ident = info.get("identity") or {}
    host = ident.get("hostname")
    return f"  [{host}#{ident.get('node_rank')}]" if host else ""


def _step_time_card(sec: Dict[str, Any]) -> str:
    g = sec.get("global") or {}
    phases = g.get("phases") or {}
    if not phases:
        return ""
    step_range = g.get("step_range", ["?", "?"])
    header = f"clock {g.get('clock')} · {g.get('n_steps')} steps ({step_range[0]}–{step_range[1]})"
    occ = g.get("median_occupancy")
    if occ is not None:
        header += f" · chip busy {fmt_pct(occ)}"
    out = [header]
    for key, p in phases.items():
        share = p.get("share_of_step")
        skew = p.get("skew_pct")
        out.append(
            f"{key:<11} median {fmt_ms(p.get('median_ms')):>10}  "
            f"share {fmt_pct(share) if share is not None else 'n/a':>6}  "
            f"skew {fmt_pct(skew) if skew is not None else 'n/a':>6}  "
            f"worst rank {p.get('worst_rank')}"
        )
    per_rank = g.get("per_rank") or {}
    if len(per_rank) > 1:
        # median/worst value+rank pairs: both ends name a rank to look at
        rollup = g.get("rollup") or {}
        med, wor = rollup.get("median") or {}, rollup.get("worst") or {}
        pairs, rank_pairs = [], []
        for key in [STEP_KEY] + [k for k in phases if k != STEP_KEY][:4]:
            m, w = med.get(key) or {}, wor.get(key) or {}
            if m.get("value") is None:
                continue
            pairs.append(f"{key} {m['value']:.1f}/{w['value']:.1f}ms")
            rank_pairs.append(f"{key} r{m['idx']}/r{w['idx']}")
        if pairs:
            out.append("stats (median/worst): " + " | ".join(pairs))
            out.append("ranks (median/worst): " + " | ".join(rank_pairs))
        out.append("per rank:")
        for rank, info in sorted(per_rank.items(), key=lambda kv: int(kv[0])):
            occ_r = info.get("occupancy")
            out.append(
                f"  rank {rank}: step {fmt_ms((info.get('avg_ms') or {}).get(STEP_KEY))}"
                + (f"  busy {fmt_pct(occ_r)}" if occ_r is not None else "")
                + _ident_suffix(info)
            )
    return "\n".join(out)


def _step_memory_card(sec: Dict[str, Any]) -> str:
    per_rank = (sec.get("global") or {}).get("per_rank") or {}
    if not per_rank:
        return ""
    out = []
    for rank, info in sorted(per_rank.items(), key=lambda kv: int(kv[0])):
        line = (
            f"rank {rank}: current {fmt_bytes(info.get('current_bytes'))}  "
            f"peak {fmt_bytes(info.get('step_peak_bytes'))}  "
            f"limit {fmt_bytes(info.get('limit_bytes'))}"
        )
        if info.get("pressure") is not None:
            line += f"  pressure {fmt_pct(info['pressure'])}"
        growth = info.get("growth_bytes")
        if growth:
            # fmt_bytes carries the sign for negatives; '+' marks growth
            line += f"  growth {'+' if growth > 0 else ''}{fmt_bytes(growth)}"
        out.append(line + _ident_suffix(info))
    skew = ((sec.get("global") or {}).get("rollup") or {}).get("peak_skew_pct")
    if skew is not None:
        out.append(f"peak skew across ranks: {fmt_pct(skew)}")
    return "\n".join(out)


# every section with a text card in the JAX report (liveness has none);
# the system, process and collectives sections are NO_DATA in this
# slice, so their card is ""
_CARD_BUILDERS = {
    "step_time": _step_time_card,
    "step_memory": _step_memory_card,
    "collectives": None,
    "system": None,
    "process": None,
}


def attach_section_cards(payload: Dict[str, Any]) -> None:
    """Attach each section's detailed text block as its ``card``."""
    for key, sec in (payload.get("sections") or {}).items():
        if key not in _CARD_BUILDERS or not isinstance(sec, dict):
            continue
        builder = _CARD_BUILDERS[key]
        try:
            sec["card"] = builder(sec) if builder is not None and sec.get("status") == "OK" else ""
        except Exception as exc:
            get_error_log().warning(f"section card {key} failed", exc)
            sec["card"] = ""


def render_text_summary(payload: Dict[str, Any]) -> str:
    primary = payload.get("primary_diagnosis") or {}
    meta = payload.get("meta") or {}
    topo = meta.get("topology") or {}
    lines = [
        "TraceML (PyTorch) — final training summary",
        f"session: {meta.get('session_id', '?')}   "
        f"ranks: {topo.get('world_size', '?')}   mode: {topo.get('mode', '?')}",
        "",
        f"VERDICT [{str(primary.get('severity', 'info')).upper()}] "
        f"{primary.get('kind', 'UNKNOWN')}"
        + (
            f"  ({primary['confidence_label']} confidence)"
            if primary.get("confidence_label")
            else ""
        ),
    ]
    if primary.get("summary"):
        lines.append(primary["summary"])
    if primary.get("action"):
        lines.append(f"→ {primary['action']}")
    out = [_box(lines), ""]
    sections = payload.get("sections") or {}

    g = (sections.get("step_time") or {}).get("global") or {}
    phases = g.get("phases") or {}
    if phases:
        step_range = g.get("step_range", ["?", "?"])
        header = (
            f"Step time ({g.get('clock')} clock, {g.get('n_steps')} steps, "
            f"steps {step_range[0]}–{step_range[1]}"
        )
        occ = g.get("median_occupancy")
        if occ is not None:
            header += f", chip busy {fmt_pct(occ)}"
        out.append(header + "):")
        step = phases.get(STEP_KEY, {})
        out.append(
            f"  step: median {fmt_ms(step.get('median_ms'))}  "
            f"worst {fmt_ms(step.get('worst_ms'))} (rank {step.get('worst_rank')})  "
            f"skew {fmt_pct(step.get('skew_pct'))}"
        )
        steady = g.get("steady_state") or {}
        if steady.get("median_ms") is not None:
            line = f"  steady-state median {fmt_ms(steady['median_ms'])}"
            infl = steady.get("warmup_inflation_pct")
            if infl is not None and infl > 0.02:
                line += f"  (warmup inflated the overall median {fmt_pct(infl)})"
            out.append(line)
        for key, p in phases.items():
            if key == STEP_KEY:
                continue
            share = p.get("share_of_step")
            out.append(
                f"  {key:<10} median {fmt_ms(p.get('median_ms')):>10}  "
                f"share {fmt_pct(share) if share is not None else 'n/a':>6}  "
                f"worst rank {p.get('worst_rank')}"
            )
        out.append("")

    sm = sections.get("step_memory") or {}
    mem_card = sm.get("card")
    if mem_card is None and sm.get("status") == "OK":
        mem_card = _step_memory_card(sm)
    if mem_card:
        out.append("Device memory (per rank):")
        out.extend(f"  {l}" for l in mem_card.splitlines())
        out.append("")

    for key in ("step_memory", "step_time"):
        diag = (sections.get(key) or {}).get("diagnosis") or {}
        if diag.get("status") == "issue":
            out.append(f"[{key}] {diag.get('kind')}: {diag.get('summary')}")
    return "\n".join(out) + "\n"


# -- entrypoint ----------------------------------------------------------


def _write(session_dir: Path, payload: Dict[str, Any]) -> None:
    atomic_write_json(protocol.get_final_summary_json_path(session_dir), payload)
    atomic_write_text(protocol.get_final_summary_txt_path(session_dir), render_text_summary(payload))


def generate_summary(
    db_path: Path,
    session_dir: Path,
    settings: Any = None,
    mode: Optional[str] = None,
) -> bool:
    """Build and write final_summary.{json,txt}; True on success."""
    db_path = Path(db_path)
    session_dir = Path(session_dir)
    mode = mode or (getattr(settings, "mode", None) or "summary")
    if not db_path.exists():
        get_error_log().warning(f"no telemetry db at {db_path}")
        _write(session_dir, {
            "schema": SCHEMA_VERSION,
            "meta": {
                "session_id": getattr(settings, "session_id", "unknown"),
                "generated_at": time.time(),
                "topology": {"mode": "unknown", "world_size": 0},
            },
            "primary_diagnosis": {
                "kind": "INSUFFICIENT_STEP_TIME_DATA",
                "severity": "info",
                "summary": "No telemetry was recorded.",
            },
            "sections": {
                k: _no_data_section(k)
                for k in ("system", "process", "step_time", "step_memory", "collectives", "liveness")
            },
        })
        return True

    results: Dict[str, Optional[DiagnosticResult]] = {}
    conn = loaders._connect_ro(db_path)
    try:
        try:
            identities = loaders.load_rank_identities(db_path, conn=conn)
        except Exception:
            identities = {}

        def run_step_time():
            rows = loaders.load_step_time_rows(db_path, max_steps_per_rank=WINDOW_READ_STEPS, conn=conn)
            section, results["step_time"] = _build_step_time_section(rows, mode, identities)
            return section

        def run_step_memory():
            rows = loaders.load_step_memory_rows(db_path, max_rows_per_rank=MEMORY_READ_ROWS, conn=conn)
            section, results["step_memory"] = _build_step_memory_section(rows, identities)
            return section

        built = {
            "step_time": _safe_section("step_time", run_step_time),
            "step_memory": _safe_section("step_memory", run_step_memory),
        }
        try:
            topology = loaders.load_topology(db_path, conn=conn)
        except Exception:
            topology = {"mode": "unknown", "world_size": 0}
    finally:
        conn.close()
    sections = {
        "system": _no_data_section("system"),
        "process": _no_data_section("process"),
        "step_time": built["step_time"],
        "step_memory": built["step_memory"],
        "collectives": _no_data_section("collectives"),
        "liveness": _no_data_section("liveness"),
    }
    primary = build_primary_diagnosis(
        results.get("step_time"),
        results.get("step_memory"),
        step_time_error=sections["step_time"].get("error"),
    )
    meta: Dict[str, Any] = {
        "session_id": getattr(settings, "session_id", "unknown"),
        "run_name": getattr(settings, "run_name", None),
        "generated_at": time.time(),
        "mode": mode,
        "topology": topology,
    }
    stats = read_json(Path(session_dir) / "ingest_stats.json")
    if stats:
        meta["telemetry_stats"] = {
            k: stats[k]
            for k in (
                "envelopes_ingested", "frames_received", "decode_errors",
                "corrupt_frame_drops", "rows_written", "rows_dropped",
                "dropped_by_domain", "unknown_domain_drops",
                "pending_frames_hwm", "queues", "group_commit", "producers",
            )
            if k in stats
        }
    payload = {
        "schema": SCHEMA_VERSION,
        "meta": meta,
        "primary_diagnosis": primary,
        "sections": sections,
    }
    attach_section_cards(payload)
    _write(session_dir, payload)
    return True
