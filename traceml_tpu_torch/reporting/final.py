"""Final summary generator.

Counterpart of ``traceml_tpu/reporting/final.py`` for the system,
process, step-time, step-memory and liveness domains.  Reads the SQLite
projections through ``reporting/loaders.py``, builds the step-time
window as the live store does (the incremental cache over columnar rings
of the rows read, the full columnar build under ``TRACEML_INCR_WINDOW=0``,
the scalar ``utils/step_time_window.py`` under
``TRACEML_COLUMNAR_WINDOW=0`` or for rows a ring cannot hold; the same
window each way), runs each domain's diagnosis, promotes a run-level
primary diagnosis,
and writes ``final_summary.json``, ``final_summary.txt`` and
``final_summary.html`` atomically.  A failed section degrades to a
NO_DATA payload: the report never fails because one domain did, nor
because the HTML artifact did (its failure goes to the error log).  As
in JAX, a session without a telemetry DB gets the JSON and text only.

The liveness section reads the aggregator's ``rank_status.json`` and
``finalization_warning.json``, not the database: a rank killed mid-run
left no closing rows.  The ``collectives`` section, as in JAX, folds the
``collectives_samples`` rows into the union-aligned window (the
incremental cache over ``CollectivesColumns`` rings, or the scalar fold)
and diagnoses it with the step window's median step time as the
denominator of the exposed-comm share (COMM_BOUND); it is NO_DATA when
no rank recorded a collective.  The ``history`` block, as in JAX, holds the whole
run at bounded cost once the writer's retention prune has folded rows
into the rollup tiers: per domain and metric, the stitched series
(``reporting/tiers.py``) collapsed to a cross-rank band and decimated to
at most ``_HISTORY_MAX_POINTS`` points; the text summary gives its
coverage in a "History:" line.

The cross-run ``regressions`` section, as in JAX: the finished run is
judged against the last runs of its fingerprint in the logs dir's
``traceml_baselines.sqlite`` and then recorded there
(``analytics/baselines.py``), before the section cards are attached; the
section goes into the payload and into ``regressions.json`` beside it,
and the text summary gives a "Cross-run regression" or "Cross-run
baseline" line and a ``[baseline] PERF_REGRESSION`` line per issue.
The captured mesh (``loaders.load_mesh_topology``; None when no rank
shipped one) is threaded into every diagnosing section, the liveness
one too, and into the check, so a finding or a step-time regression
whose ranks map onto a host, a mesh axis or one side of a node boundary
carries an ``attribution`` block, and ``meta.topology`` carries the
compact ``mesh`` block.  A store that cannot be used leaves the
regressions section out; nothing else fails.

As in JAX, the report is one profiled tick: its reads are the ``store``
domain's ``refresh`` stage, each section's build its ``diagnose`` stage
less the time its mesh attribution took, which is its ``attribute``
stage (``diagnostics/attribution.py`` ``attribution_ns_total``), and
with the incremental engine on ``meta.window_build`` holds the window
caches' counters and that profile (``utils/columnar.py``
``window_build_snapshot``).
"""

from __future__ import annotations

import statistics
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np

from traceml_tpu_torch.analytics import baselines
from traceml_tpu_torch.analytics.efficiency import build_efficiency
from traceml_tpu_torch.analytics.trends.core import compute_window_trend
from traceml_tpu_torch.diagnostics.attribution import attribution_ns_total
from traceml_tpu_torch.diagnostics.collectives.api import diagnose_collectives_window
from traceml_tpu_torch.diagnostics.common import DiagnosticResult
from traceml_tpu_torch.diagnostics.liveness.api import diagnose_rank_status
from traceml_tpu_torch.diagnostics.process.api import diagnose as diagnose_process
from traceml_tpu_torch.diagnostics.step_memory.api import diagnose_rank_rows as diagnose_memory
from traceml_tpu_torch.diagnostics.step_time.api import diagnose_window
from traceml_tpu_torch.diagnostics.system.api import diagnose as diagnose_system
from traceml_tpu_torch.reporting import loaders, tiers
from traceml_tpu_torch.reporting.primary_diagnosis import build_primary_diagnosis
from traceml_tpu_torch.reporting.rollup import build_rollup
from traceml_tpu_torch.sdk import protocol
from traceml_tpu_torch.utils.atomic_io import atomic_write_json, atomic_write_text, read_json
from traceml_tpu_torch.utils.columnar import (
    KEY_INDEX,
    CollectivesColumns,
    CollectivesWindow,
    ColumnarFallback,
    StepTimeColumns,
    StepTimeWindowCache,
    TickProfile,
    build_collectives_window_rows,
    columnar_window_enabled,
    engine_collectives_window,
    engine_step_time_window,
    incr_window_enabled,
    window_build_snapshot,
)
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
COLLECTIVES_READ_ROWS = WINDOW_READ_STEPS * 8  # several (op, dtype) rows share a step
SAMPLE_READ_ROWS = 2000  # newest system and process rows read


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
    col = getattr(window, "col", None)
    if col is not None:
        # columnar: one median over the (rank × steady-suffix) slab
        steady_slab = col.series_cube[:, KEY_INDEX[STEP_KEY], cut:]
        if steady_slab.shape[1]:
            meds = np.median(steady_slab, axis=1).tolist()
            per_rank_steady = {str(r): m for r, m in zip(col.ranks, meds)}
    else:
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


def _efficiency_block(model_stats, window: StepTimeWindow, steady) -> Optional[Dict[str, Any]]:
    """MFU: each rank's achieved model FLOP/s over its device's peak, on
    the steady-state step medians when there are some (warm-up steps say
    nothing of sustained efficiency).  The formula is
    ``analytics/efficiency.py``'s."""
    per_rank_step = (
        {int(r): v for r, v in steady["per_rank_median_ms"].items()}
        if steady
        else {r: w.averages.get(STEP_KEY) for r, w in window.rank_windows.items()}
    )
    return build_efficiency(model_stats, per_rank_step)


def _report_window(rank_rows, caches: Dict[str, StepTimeWindowCache]) -> Optional[StepTimeWindow]:
    """The report's step window, built as the live store builds it: each
    rank's rows into a columnar ring, then the incremental cache (kept in
    ``caches`` for ``meta.window_build``) or the full columnar build, and
    the scalar arm when the columnar engine is off or a ring is flagged."""
    if columnar_window_enabled():
        cols = {}
        for rank, rows in rank_rows.items():
            ring = cols[rank] = StepTimeColumns(len(rows))
            for row in rows:
                ring.append(row)
        try:
            return engine_step_time_window(cols, caches, REPORT_WINDOW_STEPS)
        except ColumnarFallback:
            pass
    return build_step_time_window(rank_rows, max_steps=REPORT_WINDOW_STEPS)


def _build_step_time_section(rank_rows, mode: str, identities, model_stats, caches, topology=None):
    if not rank_rows:
        return _no_data_section("step_time"), None, None
    window = _report_window(rank_rows, caches)
    steady = _steady_state(window) if window else {}
    efficiency = _efficiency_block(model_stats, window, steady) if window else None
    result = diagnose_window(window, mode=mode, efficiency=efficiency, topology=topology)
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
        col = getattr(window, "col", None)
        if col is not None:
            series = {
                str(r): [round(v, 3) for v in row]
                for r, row in zip(col.ranks, col.series_cube[:, KEY_INDEX[STEP_KEY], -tail:].tolist())
            }
        else:
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
    return section, result, window


def _build_step_memory_section(rank_rows, identities=None, topology=None):
    if not rank_rows:
        return _no_data_section("step_memory"), None
    result = diagnose_memory(rank_rows, topology=topology)
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


def _report_collectives_window(rank_rows, caches: Dict[str, Any]) -> Optional[CollectivesWindow]:
    """The report's collectives window, built as the live store builds
    it: each rank's rows into a ring, then the incremental cache (kept in
    ``caches`` for ``meta.window_build``) or the full columnar build, and
    the scalar fold when the columnar engine is off or a ring is
    flagged."""
    if columnar_window_enabled():
        cols = {}
        for rank, rows in rank_rows.items():
            ring = cols[rank] = CollectivesColumns(len(rows))
            for row in rows:
                ring.append(row)
        try:
            return engine_collectives_window(cols, caches, REPORT_WINDOW_STEPS)
        except ColumnarFallback:
            pass
    return build_collectives_window_rows(rank_rows, max_steps=REPORT_WINDOW_STEPS)


def _build_collectives_section(rank_rows, mode: str, caches, step_time_ms=None, topology=None):
    if not rank_rows:
        return _no_data_section("collectives"), None
    window = _report_collectives_window(rank_rows, caches)
    result = diagnose_collectives_window(
        window, mode=mode, step_time_ms=step_time_ms, topology=topology
    )
    section: Dict[str, Any] = {
        "status": "OK" if window else "NO_DATA",
        "diagnosis": result.diagnosis.to_dict(),
        "issues": [i.to_dict() for i in result.issues],
        "units": {"time": "ms", "volume": "bytes"},
    }
    if window:
        n = window.n_steps
        comm_per_step = window.totals["duration_ms"] / n
        exposed_per_step = window.totals["exposed_ms"] / n
        per_op = {
            op: {
                "count": int(v.get("count", 0)),
                "bytes": int(v.get("bytes", 0)),
                "duration_ms": round(float(v.get("duration_ms", 0.0)), 4),
                "exposed_ms": round(float(v.get("exposed_ms", 0.0)), 4),
            }
            for op, v in sorted(window.per_op.items())
        }
        per_rank = {
            str(r): {
                "duration_ms": round(float(v["duration_ms"]), 4),
                "exposed_ms": round(float(v["exposed_ms"]), 4),
                "bytes": int(v["bytes"]),
                "overlap_efficiency": round(float(v["overlap_efficiency"]), 4),
            }
            for r, v in sorted(window.per_rank.items())
        }
        tail = 120
        section["global"] = {
            "n_steps": n,
            "step_range": [window.steps[0], window.steps[-1]],
            "ranks": window.ranks,
            "group_size": int(window.group_size),
            "comm_ms_per_step": round(comm_per_step, 4),
            "exposed_ms_per_step": round(exposed_per_step, 4),
            "bytes_per_step": round(window.totals["bytes"] / n, 1),
            "overlap_efficiency": round(
                window.totals["overlap_efficiency"], 4
            ),
            "exposed_share_of_step": (
                round(exposed_per_step / step_time_ms, 4)
                if step_time_ms
                else None
            ),
            "comm_share_of_step": (
                round(comm_per_step / step_time_ms, 4)
                if step_time_ms
                else None
            ),
            "per_op": per_op,
            "per_rank": per_rank,
            # aligned per-step series — the acceptance artifact: every
            # step's overlap efficiency is in the final summary
            "series_steps": window.steps[-tail:],
            "overlap_efficiency_series": [
                round(float(v), 4)
                for v in window.per_step["overlap_efficiency"][-tail:]
            ],
            "comm_ms_series": [
                round(float(v), 4)
                for v in window.per_step["duration_ms"][-tail:]
            ],
            "exposed_ms_series": [
                round(float(v), 4)
                for v in window.per_step["exposed_ms"][-tail:]
            ],
        }
    return section, result


def _build_system_section(host, devices):
    if not host and not devices:
        return _no_data_section("system"), None
    result = diagnose_system(host, devices)
    nodes = {}
    for node, rows in host.items():
        if not rows:
            continue
        last = rows[-1]
        cpu_vals = [r["cpu_pct"] for r in rows if r.get("cpu_pct") is not None]
        used, total = last.get("memory_used_bytes"), last.get("memory_total_bytes")
        nodes[str(node)] = {
            "hostname": last.get("hostname"),
            "cpu_pct_mean": statistics.mean(cpu_vals) if cpu_vals else None,
            "cpu_pct_max": max(cpu_vals) if cpu_vals else None,
            "memory_used_bytes": used,
            "memory_total_bytes": total,
            "memory_pct": (used / total * 100.0) if used and total else None,
            "load_1m": last.get("load_1m"),
            "n_samples": len(rows),
        }
    chips = {}
    for (node, dev), rows in devices.items():
        if not rows:
            continue
        last = rows[-1]
        util_vals = [
            r["utilization_pct"] for r in rows if r.get("utilization_pct") is not None
        ]
        chips[f"{node}:{dev}"] = {
            "device_kind": last.get("device_kind"),
            "memory_used_bytes": last.get("memory_used_bytes"),
            "memory_peak_bytes": last.get("memory_peak_bytes"),
            "memory_total_bytes": last.get("memory_total_bytes"),
            "utilization_pct_mean": statistics.mean(util_vals) if util_vals else None,
            "temperature_c": last.get("temperature_c"),
            "power_w": last.get("power_w"),
        }
    global_block: Dict[str, Any] = {"nodes": nodes, "devices": chips}
    if len(nodes) > 1:
        cpu_means = {
            n: v["cpu_pct_mean"]
            for n, v in nodes.items()
            if v["cpu_pct_mean"] is not None
        }
        if cpu_means:
            worst = max(cpu_means, key=lambda n: cpu_means[n])
            global_block["cluster"] = {
                "n_nodes": len(nodes),
                "cpu_pct_min": min(cpu_means.values()),
                "cpu_pct_median": statistics.median(cpu_means.values()),
                "cpu_pct_max": cpu_means[worst],
                "busiest_node": nodes[worst].get("hostname"),
            }
    section = {
        "status": "OK",
        "diagnosis": result.diagnosis.to_dict(),
        "issues": [i.to_dict() for i in result.issues],
        "global": global_block,
        "units": {"memory": "bytes", "cpu": "%"},
    }
    return section, result


def _build_process_section(procs, devices, identities=None):
    if not procs and not devices:
        return _no_data_section("process"), None
    result = diagnose_process(procs, devices)
    identities = identities or {}
    per_rank = {}
    for rank, rows in procs.items():
        if not rows:
            continue
        last = rows[-1]
        cpu_vals = [r["cpu_pct"] for r in rows if r.get("cpu_pct") is not None]
        rss_vals = [r["rss_bytes"] for r in rows if r.get("rss_bytes") is not None]
        per_rank[str(rank)] = {
            "identity": identities.get(rank),
            "pid": last.get("pid"),
            "hostname": last.get("hostname"),
            "rss_bytes": last.get("rss_bytes"),
            "rss_peak_bytes": max(rss_vals) if rss_vals else None,
            "cpu_pct": last.get("cpu_pct"),
            "cpu_pct_mean": statistics.mean(cpu_vals) if cpu_vals else None,
            "cpu_pct_max": max(cpu_vals) if cpu_vals else None,
            "num_threads": last.get("num_threads"),
            "n_samples": len(rows),
        }
    with_cpu = {
        r: v["cpu_pct_mean"] for r, v in per_rank.items() if v["cpu_pct_mean"]
    }
    rollup = {
        "total_rss_bytes": sum(v["rss_bytes"] or 0 for v in per_rank.values()),
        "busiest_rank": max(with_cpu, key=lambda r: with_cpu[r])
        if with_cpu
        else None,
        **build_rollup({
            "rss_bytes": {r: v["rss_bytes"] for r, v in per_rank.items()},
            "cpu_pct_mean": {
                r: v["cpu_pct_mean"] for r, v in per_rank.items()
            },
        }),
    }
    section = {
        "status": "OK",
        "diagnosis": result.diagnosis.to_dict(),
        "issues": [i.to_dict() for i in result.issues],
        "global": {"per_rank": per_rank, "rollup": rollup},
        "units": {"memory": "bytes", "cpu": "%"},
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
    eff = g.get("efficiency")
    if eff:
        bits = []
        if eff.get("achieved_tflops_median") is not None:
            flops = eff.get("flops_per_step")
            bits.append(
                (f"model: {flops / 1e12:.2f} TFLOP/step → " if flops else "")
                + f"{eff['achieved_tflops_median']:.1f} TFLOP/s achieved"
            )
            if eff.get("mfu_median") is not None:
                peak = eff.get("peak_tflops")
                bits.append(
                    f"= {fmt_pct(eff['mfu_median'])} MFU ({eff.get('device_kind')}"
                    + (f", peak {peak:.0f} TFLOP/s" if peak else "")
                    + ")"
                )
        if eff.get("tokens_per_sec_median") is not None:
            bits.append(f"{eff['tokens_per_sec_median']:,.0f} tokens/s")
        if bits:
            out.append(" ".join(bits))
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


def _system_card(sec: Dict[str, Any]) -> str:
    g = sec.get("global") or {}
    out = []
    for node, info in sorted((g.get("nodes") or {}).items(), key=lambda kv: int(kv[0])):
        cpu = info.get("cpu_pct_mean")
        out.append(
            f"node {node} ({info.get('hostname')}): "
            f"cpu {cpu:.0f}%" if cpu is not None else
            f"node {node} ({info.get('hostname')}): cpu n/a"
        )
        if info.get("memory_used_bytes") and info.get("memory_total_bytes"):
            out[-1] += (
                f"  ram {fmt_bytes(info['memory_used_bytes'])}"
                f"/{fmt_bytes(info['memory_total_bytes'])}"
            )
    def _dev_key(kv):  # "node:dev" → numeric order (10 after 2)
        try:
            node, dev = kv[0].split(":", 1)
            return (int(node), int(dev))
        except (ValueError, AttributeError):
            return (1 << 30, 0)

    for key, dev in sorted((g.get("devices") or {}).items(), key=_dev_key):
        line = f"chip {key} ({dev.get('device_kind')})"
        if dev.get("memory_used_bytes") is not None:
            line += f": hbm {fmt_bytes(dev['memory_used_bytes'])}"
            if dev.get("memory_total_bytes"):
                line += f"/{fmt_bytes(dev['memory_total_bytes'])}"
        if dev.get("utilization_pct_mean") is not None:
            line += f"  duty {dev['utilization_pct_mean']:.0f}%"
        out.append(line)
    return "\n".join(out)


def _collectives_card(sec: Dict[str, Any]) -> str:
    g = sec.get("global") or {}
    if not g:
        return ""
    out = [
        f"{g.get('n_steps')} steps · group size {g.get('group_size')} · "
        f"comm {fmt_ms(g.get('comm_ms_per_step'))}/step "
        f"(exposed {fmt_ms(g.get('exposed_ms_per_step'))}) · "
        f"overlap {fmt_pct(g.get('overlap_efficiency'))}"
    ]
    share = g.get("exposed_share_of_step")
    if share is not None:
        out[-1] += f" · exposed share of step {fmt_pct(share)}"
    for op, v in (g.get("per_op") or {}).items():
        dur = v.get("duration_ms") or 0.0
        eff = 1.0 - (v.get("exposed_ms") or 0.0) / dur if dur > 0 else 1.0
        out.append(
            f"{op:<15} {v.get('count', 0):>6}×  {fmt_bytes(v.get('bytes')):>10}  "
            f"{fmt_ms(dur):>10}  overlap {fmt_pct(eff)}"
        )
    per_rank = g.get("per_rank") or {}
    if len(per_rank) > 1:
        worst = min(
            (
                (r, v)
                for r, v in per_rank.items()
                if (v.get("duration_ms") or 0.0) > 0
            ),
            key=lambda kv: kv[1].get("overlap_efficiency", 1.0),
            default=None,
        )
        if worst is not None:
            out.append(
                f"worst-overlap rank {worst[0]}: "
                f"{fmt_pct(worst[1].get('overlap_efficiency'))} "
                f"({fmt_ms(worst[1].get('exposed_ms'))} exposed)"
            )
    return "\n".join(out)


def _process_card(sec: Dict[str, Any]) -> str:
    per_rank = (sec.get("global") or {}).get("per_rank") or {}
    if not per_rank:
        return ""
    out = []
    for rank, info in sorted(per_rank.items(), key=lambda kv: int(kv[0])):
        cpu = info.get("cpu_pct_mean")
        out.append(
            f"rank {rank} (pid {info.get('pid')}): "
            f"cpu {cpu:.0f}%  " if cpu is not None
            else f"rank {rank} (pid {info.get('pid')}): cpu n/a  "
        )
        out[-1] += f"rss {fmt_bytes(info.get('rss_bytes'))}"
        if info.get("num_threads") is not None:
            out[-1] += f"  threads {info['num_threads']}"
        out[-1] += _ident_suffix(info)
    rollup = (sec.get("global") or {}).get("rollup") or {}
    if rollup.get("total_rss_bytes"):
        out.append(f"total rss: {fmt_bytes(rollup['total_rss_bytes'])}")
    return "\n".join(out)


# every section with a text card in the JAX report (liveness has none)
_CARD_BUILDERS = {
    "step_time": _step_time_card,
    "step_memory": _step_memory_card,
    "collectives": _collectives_card,
    "system": _system_card,
    "process": _process_card,
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
        eff = g.get("efficiency")
        if eff:
            line = "  "
            if eff.get("achieved_tflops_median") is not None:
                flops = eff.get("flops_per_step")
                line += (
                    (f"model {flops / 1e12:.2f} TFLOP/step → " if flops else "")
                    + f"{eff['achieved_tflops_median']:.1f} TFLOP/s"
                )
                if eff.get("mfu_median") is not None:
                    line += f"  MFU {fmt_pct(eff['mfu_median'])}"
            if eff.get("tokens_per_sec_median") is not None:
                line += f"  {eff['tokens_per_sec_median']:,.0f} tokens/s"
            if line.strip():
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

    cluster = ((sections.get("system") or {}).get("global") or {}).get("cluster")
    if cluster:
        out.append(
            f"Cluster: {cluster['n_nodes']} nodes · host CPU "
            f"{cluster['cpu_pct_min']:.0f}/{cluster['cpu_pct_median']:.0f}/"
            f"{cluster['cpu_pct_max']:.0f}% (min/median/max, busiest "
            f"{cluster.get('busiest_node')})"
        )
        out.append("")

    for key, title in (
        ("collectives", "Collectives (compute/comm overlap)"),
        ("system", "System"),
        ("process", "Processes"),
    ):
        card = (sections.get(key) or {}).get("card")
        if card:
            out.append(f"{title}:")
            out.extend(f"  {l}" for l in card.splitlines())
            out.append("")

    # the cross-run verdict (analytics/baselines.py): one line when
    # healthy, the per-metric deltas when something regressed
    reg = payload.get("regressions")
    if reg and reg.get("checks"):
        if reg.get("status") == "regression":
            out.append(f"Cross-run regression vs last {reg.get('baseline_runs')} matching run(s):")
            for c in reg["checks"]:
                if c.get("status") != "regression":
                    continue
                delta = c.get("delta_pct")
                out.append(
                    f"  {c['metric']}: {c['current']:.4g} vs baseline {c['baseline_median']:.4g}"
                    + (f" ({delta:+.1f}%)" if delta is not None else "")
                )
        else:
            out.append(f"Cross-run baseline: within bands of last {reg.get('baseline_runs')} matching run(s).")
        out.append("")

    # the full-run history's coverage (stitched rollup tiers)
    hist = (payload.get("history") or {}).get("step_time") or {}
    pts = (hist.get("step_ms") or {}).get("points")
    if pts:
        span_s = pts[-1]["t"] - pts[0]["t"]
        out.append(
            f"History: {len(pts)} stitched buckets covering "
            f"{span_s / 3600.0:.1f} h "
            f"({'/'.join((hist.get('step_ms') or {}).get('resolutions', []))}"
            " resolution)"
        )
        out.append("")

    for key in ("liveness", "system", "process", "collectives", "step_memory", "step_time"):
        diag = (sections.get(key) or {}).get("diagnosis") or {}
        if diag.get("status") == "issue":
            out.append(f"[{key}] {diag.get('kind')}: {diag.get('summary')}")
    for issue in (payload.get("regressions") or {}).get("issues") or []:
        out.append(f"[baseline] {issue.get('kind')}: {issue.get('summary')}")
    return "\n".join(out) + "\n"


def _build_liveness_section(session_dir: Path, mode: str, topology=None):
    """Rank liveness and the data gaps, from the aggregator's persisted
    snapshots (``rank_status.json``, ``finalization_warning.json``)."""
    snap = loaders.load_rank_status(session_dir)
    if not snap:
        return _no_data_section("liveness"), None
    result = diagnose_rank_status(snap, mode=mode, topology=topology)
    ranks = snap.get("ranks") or {}
    # a lost rank's telemetry holds only up to its last contact: past
    # gap_from_ts the cross-rank aggregates cover the survivors
    gaps: Dict[str, Any] = {}
    for rank_s, info in ranks.items():
        if isinstance(info, dict) and info.get("state") == "lost" and not info.get("finished"):
            gaps[rank_s] = {
                "gap_from_ts": info.get("last_seen"),
                "last_progress_ts": info.get("last_progress"),
            }
    section: Dict[str, Any] = {
        "status": "OK",
        "diagnosis": result.diagnosis.to_dict(),
        "issues": [i.to_dict() for i in result.issues],
        "thresholds": snap.get("thresholds"),
        "expected_world_size": snap.get("expected_world_size"),
        "ranks": ranks,
    }
    if gaps:
        section["data_gaps"] = gaps
    warn = read_json(Path(session_dir) / "finalization_warning.json")
    if isinstance(warn, dict) and warn.get("missing_ranks"):
        section["unfinished_ranks"] = warn.get("missing_ranks")
        if warn.get("missing_rank_states"):
            section["unfinished_rank_states"] = warn["missing_rank_states"]
    return section, result


_HISTORY_MAX_POINTS = 1500


def _cross_rank_band(series: Dict[str, Any]) -> list:
    """Per-rank stitched points collapsed into one band: per bucket, the
    mean of the ranks' means, the min of mins and the max of maxs."""
    buckets: Dict[float, Dict[str, Any]] = {}
    for points in series.values():
        for p in points:
            if p.get("mean") is None:
                continue
            b = buckets.get(p["t"])
            if b is None:
                buckets[p["t"]] = {"t": p["t"], "means": [p["mean"]], "min": p["min"], "max": p["max"],
                                   "res": p["res"]}
            else:
                b["means"].append(p["mean"])
                b["min"] = min(b["min"], p["min"])
                b["max"] = max(b["max"], p["max"])
    return [
        {"t": round(t, 3), "mean": sum(b["means"]) / len(b["means"]), "min": b["min"], "max": b["max"],
         "res": b["res"]}
        for t, b in ((t, buckets[t]) for t in sorted(buckets))
    ]


def _decimate_band(points: list, cap: int = _HISTORY_MAX_POINTS) -> list:
    """Bound the history block for arbitrarily long runs: merge groups of
    adjacent points (mean of means, min of mins, max of maxs) until at
    most ``cap`` remain."""
    if len(points) <= cap:
        return points
    stride = -(-len(points) // cap)  # ceil division
    out = []
    for i in range(0, len(points), stride):
        group = points[i:i + stride]
        out.append({
            "t": group[0]["t"],
            "mean": sum(p["mean"] for p in group) / len(group),
            "min": min(p["min"] for p in group),
            "max": max(p["max"] for p in group),
            "res": group[-1]["res"],
        })
    return out


def _build_history_section(conn) -> Dict[str, Any]:
    """Per domain and metric, the full-run cross-rank band of the stitched
    rollup tiers; {} (the key left out) when no fold ever landed or the
    stitch fails."""
    try:
        overview = tiers.stitched_overview(conn)
    except Exception as exc:
        get_error_log().warning("history stitch failed", exc)
        return {}
    out: Dict[str, Any] = {}
    for domain, metrics in overview.items():
        per_metric: Dict[str, Any] = {}
        for metric, series in metrics.items():
            band = _decimate_band(_cross_rank_band(series))
            if band:
                per_metric[metric] = {
                    "points": band,
                    "ranks": len(series),
                    "resolutions": sorted({p["res"] for p in band}),
                }
        if per_metric:
            out[domain] = per_metric
    return out


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
    """Build and write final_summary.{json,txt,html}; True on success."""
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
    # the report is one profiled tick: reads are the store's refresh
    # stage, each section's build and diagnosis its diagnose stage
    prof = TickProfile()
    prof.note_tick()
    caches: Dict[str, Any] = {}
    windows: Dict[str, Any] = {}
    read_ns = 0

    def read(fn):
        nonlocal read_ns
        t0 = time.perf_counter_ns()
        try:
            return fn()
        finally:
            ns = time.perf_counter_ns() - t0
            read_ns += ns
            prof.note_stage("store", "refresh", ns)

    def timed_section(key, builder):
        r0, a0, t0 = read_ns, attribution_ns_total(), time.perf_counter_ns()
        out = _safe_section(key, builder)
        attr_ns = attribution_ns_total() - a0
        prof.note_stage(key, "diagnose", max(0, time.perf_counter_ns() - t0 - (read_ns - r0) - attr_ns))
        prof.note_stage(key, "attribute", attr_ns)
        return out

    conn = loaders._connect_ro(db_path)
    try:
        try:
            identities = read(lambda: loaders.load_rank_identities(db_path, conn=conn))
        except Exception:
            identities = {}
        # the captured mesh (or None), threaded into every diagnosing
        # section: None keeps each diagnosis as it is without a mesh
        try:
            mesh = read(lambda: loaders.load_mesh_topology(db_path, conn=conn))
        except Exception:
            mesh = None

        def run_step_time():
            rows = read(lambda: loaders.load_step_time_rows(db_path, max_steps_per_rank=WINDOW_READ_STEPS,
                                                            conn=conn))
            stats = read(lambda: loaders.load_model_stats(db_path, conn=conn))
            section, results["step_time"], windows["step_time"] = _build_step_time_section(
                rows, mode, identities, stats, caches, topology=mesh)
            return section

        def run_step_memory():
            rows = read(lambda: loaders.load_step_memory_rows(db_path, max_rows_per_rank=MEMORY_READ_ROWS,
                                                              conn=conn))
            section, results["step_memory"] = _build_step_memory_section(rows, identities, topology=mesh)
            return section

        def run_collectives():
            rows = read(lambda: loaders.load_collectives_rows(db_path, max_rows_per_rank=COLLECTIVES_READ_ROWS,
                                                              conn=conn))
            # the cross-domain join: the step window's median step time is
            # the denominator of the exposed-comm share (COMM_BOUND)
            step_time_ms = None
            st = windows.get("step_time")
            if st is not None:
                m = st.metric(STEP_KEY)
                if m is not None and m.median_ms > 0:
                    step_time_ms = m.median_ms
            section, results["collectives"] = _build_collectives_section(
                rows, mode, caches, step_time_ms=step_time_ms, topology=mesh)
            return section

        def run_system():
            host, devices = read(lambda: loaders.load_system_rows(db_path, max_rows=SAMPLE_READ_ROWS, conn=conn))
            section, results["system"] = _build_system_section(host, devices)
            return section

        def run_process():
            procs, devices = read(lambda: loaders.load_process_rows(db_path, max_rows=SAMPLE_READ_ROWS,
                                                                    conn=conn))
            section, results["process"] = _build_process_section(procs, devices, identities)
            return section

        built = {
            "system": timed_section("system", run_system),
            "process": timed_section("process", run_process),
            "step_time": timed_section("step_time", run_step_time),
            "step_memory": timed_section("step_memory", run_step_memory),
            "collectives": timed_section("collectives", run_collectives),
        }
        try:
            topology = read(lambda: loaders.load_topology(db_path, conn=conn))
        except Exception:
            topology = {"mode": "unknown", "world_size": 0}
        if mesh is not None:
            topology["mesh"] = mesh.summary()
        history = read(lambda: _build_history_section(conn))
    finally:
        conn.close()

    def run_liveness():
        section, results["liveness"] = _build_liveness_section(session_dir, mode, topology=mesh)
        return section

    sections = {
        **built,
        "liveness": timed_section("liveness", run_liveness),
    }
    primary = build_primary_diagnosis(
        results.get("step_time"),
        results.get("step_memory"),
        results.get("system"),
        results.get("process"),
        step_time_error=sections["step_time"].get("error"),
        collectives=results.get("collectives"),
        liveness=results.get("liveness"),
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
                "pending_frames_hwm", "queues", "group_commit", "prune", "producers",
                "transports",
            )
            if k in stats
        }
    if incr_window_enabled():
        window_build = window_build_snapshot(caches, prof)
        if window_build:
            meta["window_build"] = window_build
    payload = {
        "schema": SCHEMA_VERSION,
        "meta": meta,
        "primary_diagnosis": primary,
        "sections": sections,
    }
    if history:
        payload["history"] = history
    # evaluate this run against the last matching sessions, then record
    # it; the verdict also goes to regressions.json, which the dashboard's
    # meta fragment serves
    try:
        regressions = baselines.evaluate_and_record(session_dir, payload, topology=mesh)
        if regressions is not None:
            payload["regressions"] = regressions
            atomic_write_json(Path(session_dir) / "regressions.json", regressions)
    except Exception as exc:
        get_error_log().warning("baseline regression check failed", exc)
    attach_section_cards(payload)
    _write(session_dir, payload)
    try:
        from traceml_tpu_torch.reporting.html.writer import write_html_summary

        write_html_summary(payload, protocol.get_final_summary_html_path(session_dir))
    except Exception as exc:  # the HTML artifact is best-effort
        get_error_log().warning("final_summary.html write failed", exc)
    return True
