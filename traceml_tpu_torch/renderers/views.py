"""Typed per-domain views: the one place the live display's metric math
lives (render surfaces only format).

Counterpart of ``traceml_tpu/renderers/views.py`` for the domains the
port writes: step time (with the efficiency block), device memory,
system and process.  The collectives and serving views come with their
queues (ROADMAP queue 1 items 5 and 6).  Views are frozen dataclasses;
``as_dict`` gives the same dict as the JAX view's.

As in JAX, the step-time tables and the memory view's per-row walk have
columnar fast paths: a cube-backed window's series, cross-rank medians
and per-rank averages are read off the cube, and a rank's memory ring
gives its first non-null current bytes and history tail.  Both give the
scalar paths' values exactly.  ``as_dict`` walks the view without
``dataclasses.asdict``'s deep copies unless
``TRACEML_VECTOR_DIAGNOSIS=0``; the dicts are equal either way.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from traceml_tpu_torch.analytics.efficiency import build_efficiency
from traceml_tpu_torch.utils.columnar import (
    C_CUR,
    KEY_INDEX,
    MemoryColumns,
    vector_diagnosis_enabled,
)
from traceml_tpu_torch.utils.rankstats import closest_rank_to_median
from traceml_tpu_torch.utils.step_time_window import (
    ALL_KEYS,
    RESIDUAL_KEY,
    STEP_KEY,
    StepTimeWindow,
)

_STALE_AFTER_S = 5.0


def _fast_asdict(obj: Any) -> Any:
    """Value-identical replacement for the ``dataclasses.asdict`` walk,
    which routes every leaf through ``copy.deepcopy``.  This walk builds
    fresh dicts and lists (callers may cache the result) but passes
    primitives through untouched; the inline float/int test keeps the
    per-step series out of the recursion."""
    if type(obj) is dict:
        return {k: _fast_asdict(v) for k, v in obj.items()}
    if type(obj) is list or type(obj) is tuple:
        return [
            v if type(v) is float or type(v) is int else _fast_asdict(v)
            for v in obj
        ]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: _fast_asdict(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    return obj


def _asdict(obj: Any) -> Any:
    if vector_diagnosis_enabled():
        return _fast_asdict(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    return obj


# ---------------------------------------------------------------------------
# step time
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PhaseStat:
    """Cross-rank stats for one phase over the aligned window."""

    key: str
    median_ms: float
    worst_ms: float
    worst_rank: int
    skew_pct: float
    share: Optional[float]  # median(phase)/median(step); None for step itself
    # rank whose window avg sits closest to the cross-rank median —
    # both ends of the spread name a concrete rank (report parity)
    median_rank: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Coverage:
    """How much of the run the window actually covers
    (reference: StepCombinedTimeCoverage)."""

    world_size: int
    ranks_present: int
    steps_used: int
    last_step: Optional[int]
    incomplete: bool  # fewer ranks reporting than the declared world


@dataclasses.dataclass(frozen=True)
class StepTimeView:
    clock: str
    n_steps: int
    coverage: Coverage
    phases: List[PhaseStat]                      # step first, residual last
    per_rank_avg_ms: Dict[int, Dict[str, float]]  # rank → phase → window avg
    steps: List[int]                              # aligned step ids (tail)
    step_series: Dict[str, List[float]]           # rank(str) → per-step step_ms
    phase_stack: Dict[str, List[float]]           # phase → cross-rank median/step
    occupancy_by_rank: Dict[str, float]           # device-busy share of wall
    median_occupancy: Optional[float]
    # MFU block (achieved TFLOP/s + mfu vs chip peak) when model FLOPs
    # were declared; None otherwise
    efficiency: Optional[Dict[str, Any]]
    latest_ts: Optional[float]

    def as_dict(self) -> Dict[str, Any]:
        return _asdict(self)


def _step_time_tables(window: StepTimeWindow, series_tail: int) -> Dict[str, Any]:
    """Every window-derived table in the step_time view: a pure function
    of the window, so ``LiveComputer`` memoizes it per step_time version
    (``table_cache``) and a model_stats-only tick rebuilds only the MFU
    block."""
    phases: List[PhaseStat] = []
    for key in [STEP_KEY] + window.phases_present + [RESIDUAL_KEY]:
        m = window.metric(key)
        if m is None:
            continue
        med_rank = closest_rank_to_median(m.per_rank_avg_ms)
        phases.append(
            PhaseStat(
                key=key,
                median_ms=m.median_ms,
                worst_ms=m.worst_ms,
                worst_rank=m.worst_rank,
                median_rank=(
                    int(med_rank) if med_rank is not None else None
                ),
                skew_pct=m.skew_pct,
                share=window.share_of_step(key) if key != STEP_KEY else None,
            )
        )
    tail = window.steps[-series_tail:]
    offset = len(window.steps) - len(tail)
    col = getattr(window, "col", None)
    phase_stack: Dict[str, List[float]] = {}
    if col is not None:
        # columnar fast path: series, per-phase cross-rank medians and
        # per-rank averages straight off the cube (tolist() BEFORE
        # round() so the values are native floats, as in the scalar arm)
        step_series = {
            str(r): [round(v, 4) for v in row]
            for r, row in zip(
                col.ranks, col.series_cube[:, KEY_INDEX[STEP_KEY], offset:].tolist()
            )
        }
        for key in window.phases_present + [RESIDUAL_KEY]:
            med = np.median(col.series_cube[:, KEY_INDEX[key], offset:], axis=0)
            phase_stack[key] = [round(v, 4) for v in med.tolist()]
        per_rank_avg = {
            r: {k: round(v, 4) for k, v in zip(ALL_KEYS, row)}
            for r, row in zip(col.ranks, col.averages.tolist())
        }
    else:
        step_series = {
            str(r): [round(v, 4) for v in w.series[STEP_KEY][offset:]]
            for r, w in window.rank_windows.items()
        }
        # cross-rank median per phase per step — the stacking series the
        # dashboard charts consume (reference: StepCombinedTimeSeries)
        rw = list(window.rank_windows.values())
        for key in window.phases_present + [RESIDUAL_KEY]:
            per_step = []
            for i in range(offset, len(window.steps)):
                vals = [w.series[key][i] for w in rw if i < len(w.series[key])]
                per_step.append(
                    round(statistics.median(vals), 4) if vals else 0.0
                )
            phase_stack[key] = per_step
        per_rank_avg = {
            r: {k: round(v, 4) for k, v in w.averages.items()}
            for r, w in window.rank_windows.items()
        }
    return {
        "phases": phases,
        "tail": tail,
        "step_series": step_series,
        "phase_stack": phase_stack,
        "per_rank_avg": per_rank_avg,
        "occupancy": {
            str(r): round(v, 4) for r, v in window.occupancy_by_rank.items()
        },
        "median_occupancy": window.median_occupancy,
    }


def build_step_time_view(
    window: Optional[StepTimeWindow],
    *,
    world_size: Optional[int] = None,
    latest_ts: Optional[float] = None,
    series_tail: int = 60,
    model_stats: Optional[Dict[int, Dict[str, Any]]] = None,
    table_cache: Optional[Dict[str, Any]] = None,
) -> Optional[StepTimeView]:
    if window is None:
        return None
    if table_cache is not None and "tables" in table_cache:
        t = table_cache["tables"]
    else:
        t = _step_time_tables(window, series_tail)
        if table_cache is not None:
            table_cache["tables"] = t
    per_rank_avg = t["per_rank_avg"]
    world = max(world_size or 0, len(window.ranks))
    return StepTimeView(
        clock=window.clock,
        n_steps=window.n_steps,
        coverage=Coverage(
            world_size=world,
            ranks_present=len(window.ranks),
            steps_used=window.n_steps,
            last_step=window.steps[-1] if window.steps else None,
            incomplete=len(window.ranks) < world,
        ),
        phases=t["phases"],
        per_rank_avg_ms=per_rank_avg,
        steps=t["tail"],
        step_series=t["step_series"],
        phase_stack=t["phase_stack"],
        occupancy_by_rank=t["occupancy"],
        median_occupancy=t["median_occupancy"],
        efficiency=_efficiency_from_stats(model_stats, per_rank_avg),
        latest_ts=latest_ts,
    )


def _efficiency_from_stats(model_stats, per_rank_avg) -> Optional[Dict[str, Any]]:
    """Live MFU from model_stats + the window's per-rank step averages
    (the live view has no steady-state split — the rolling window is
    already recent steps only).  Formula shared with the final summary
    via analytics/efficiency.py."""
    return build_efficiency(
        model_stats,
        {r: avgs.get(STEP_KEY) for r, avgs in per_rank_avg.items()},
    )


# ---------------------------------------------------------------------------
# step memory
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MemoryRankStat:
    rank: int
    device_id: Optional[int]
    device_kind: str
    current_bytes: Optional[int]
    step_peak_bytes: Optional[int]
    alloc_peak_bytes: Optional[int]   # allocator cumulative peak
    limit_bytes: Optional[int]
    pressure: Optional[float]         # step_peak/limit when limit known
    growth_bytes: Optional[int]       # last − first current in window
    history: List[int]                # per-sample current_bytes tail


@dataclasses.dataclass(frozen=True)
class MemoryView:
    ranks: List[MemoryRankStat]
    worst_pressure_rank: Optional[int]
    total_current_bytes: int
    latest_ts: Optional[float]

    def as_dict(self) -> Dict[str, Any]:
        return _asdict(self)


def build_memory_view(
    rows_by_rank: Mapping[int, Sequence[Mapping[str, Any]]],
    *,
    history_tail: int = 60,
    columns: Optional[Mapping[int, MemoryColumns]] = None,
) -> Optional[MemoryView]:
    if not isinstance(rows_by_rank, Mapping) or not rows_by_rank:
        return None
    stats: List[MemoryRankStat] = []
    latest_ts: Optional[float] = None
    for rank in sorted(rows_by_rank):
        rows = [r for r in rows_by_rank[rank] if r]
        if not rows:
            continue
        last = rows[-1]
        cur = last.get("current_bytes")
        step_peak = last.get("step_peak_bytes")
        limit = last.get("limit_bytes")
        # the per-row walk (first non-null current and the history tail)
        # has a columnar fast path over the rank's ring; -1 == NULL, and
        # arrival order matches the row list exactly
        col = columns.get(rank) if columns is not None else None
        if col is not None and len(col) == len(rows) and col.columnar_ok:
            cur_col = col.column(C_CUR)
            nn = np.flatnonzero(cur_col >= 0)
            first_cur = int(cur_col[nn[0]]) if nn.size else None
            history = np.maximum(cur_col[-history_tail:], 0).tolist()
        else:
            first_cur = next(
                (r.get("current_bytes") for r in rows if r.get("current_bytes") is not None),
                None,
            )
            history = [int(r.get("current_bytes") or 0) for r in rows[-history_tail:]]
        ts = last.get("timestamp")
        if ts is not None:
            latest_ts = max(latest_ts or 0.0, float(ts))
        stats.append(
            MemoryRankStat(
                rank=int(rank),
                device_id=last.get("device_id"),
                device_kind=str(last.get("device_kind") or "unknown"),
                current_bytes=cur,
                step_peak_bytes=step_peak,
                alloc_peak_bytes=last.get("peak_bytes"),
                limit_bytes=limit,
                pressure=((step_peak or cur or 0) / limit) if limit else None,
                growth_bytes=(cur - first_cur)
                if cur is not None and first_cur is not None
                else None,
                history=history,
            )
        )
    if not stats:
        return None
    with_pressure = [s for s in stats if s.pressure is not None]
    worst = max(with_pressure, key=lambda s: s.pressure).rank if with_pressure else None
    return MemoryView(
        ranks=stats,
        worst_pressure_rank=worst,
        total_current_bytes=sum(s.current_bytes or 0 for s in stats),
        latest_ts=latest_ts,
    )


# ---------------------------------------------------------------------------
# system (host + devices), incl. the multi-node cluster rollup
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceStat:
    device_id: int
    device_kind: str
    memory_used_bytes: Optional[int]
    memory_total_bytes: Optional[int]
    utilization_pct: Optional[float]
    temperature_c: Optional[float]
    power_w: Optional[float]


@dataclasses.dataclass(frozen=True)
class NodeSystemStat:
    node_rank: int
    hostname: str
    cpu_pct: Optional[float]
    memory_used_bytes: Optional[int]
    memory_total_bytes: Optional[int]
    memory_pct: Optional[float]
    load_1m: Optional[float]
    devices: List[DeviceStat]
    cpu_history: List[float]
    latest_ts: Optional[float]
    stale: bool


@dataclasses.dataclass(frozen=True)
class ClusterRollup:
    """min/median/max of one metric across nodes
    (reference: system/cli_cluster.py _MetricRollup)."""

    metric: str
    min_value: float
    median_value: float
    max_value: float
    min_node: str
    max_node: str


@dataclasses.dataclass(frozen=True)
class SystemView:
    nodes: List[NodeSystemStat]
    rollups: List[ClusterRollup]      # non-empty only in multi-node runs
    expected_nodes: int
    missing_nodes: int
    latest_ts: Optional[float]

    @property
    def is_cluster(self) -> bool:
        return len(self.nodes) > 1 or self.expected_nodes > 1

    def as_dict(self) -> Dict[str, Any]:
        d = _asdict(self)
        d["is_cluster"] = self.is_cluster
        return d


def _rollup(metric: str, values: List[Tuple[str, float]]) -> Optional[ClusterRollup]:
    vals = [(n, v) for n, v in values if v is not None]
    if not vals:
        return None
    ordered = sorted(vals, key=lambda t: t[1])
    return ClusterRollup(
        metric=metric,
        min_value=ordered[0][1],
        median_value=statistics.median(v for _, v in ordered),
        max_value=ordered[-1][1],
        min_node=ordered[0][0],
        max_node=ordered[-1][0],
    )


def build_system_view(
    host_rows: Mapping[int, Sequence[Mapping[str, Any]]],
    device_rows: Mapping[tuple, Sequence[Mapping[str, Any]]] | None = None,
    *,
    expected_nodes: Optional[int] = None,
    now: Optional[float] = None,
    history_tail: int = 60,
) -> Optional[SystemView]:
    if not host_rows:
        return None
    now = time.time() if now is None else now
    device_rows = device_rows or {}
    nodes: List[NodeSystemStat] = []
    latest_ts: Optional[float] = None
    for node in sorted(host_rows):
        rows = [r for r in host_rows[node] if r]
        if not rows:
            continue
        last = rows[-1]
        ts = last.get("timestamp")
        if ts is not None:
            latest_ts = max(latest_ts or 0.0, float(ts))
        devices: List[DeviceStat] = []
        for (dnode, did), drows in sorted(device_rows.items()):
            if dnode != node or not drows:
                continue
            dlast = drows[-1]
            devices.append(
                DeviceStat(
                    device_id=int(did),
                    device_kind=str(dlast.get("device_kind") or "unknown"),
                    memory_used_bytes=dlast.get("memory_used_bytes"),
                    memory_total_bytes=dlast.get("memory_total_bytes"),
                    utilization_pct=dlast.get("utilization_pct"),
                    temperature_c=dlast.get("temperature_c"),
                    power_w=dlast.get("power_w"),
                )
            )
        nodes.append(
            NodeSystemStat(
                node_rank=int(node),
                hostname=str(last.get("hostname") or f"node{node}"),
                cpu_pct=last.get("cpu_pct"),
                memory_used_bytes=last.get("memory_used_bytes"),
                memory_total_bytes=last.get("memory_total_bytes"),
                memory_pct=last.get("memory_pct"),
                load_1m=last.get("load_1m"),
                devices=devices,
                cpu_history=[
                    float(r.get("cpu_pct") or 0.0) for r in rows[-history_tail:]
                ],
                latest_ts=float(ts) if ts is not None else None,
                stale=(now - float(ts)) > _STALE_AFTER_S if ts is not None else False,
            )
        )
    if not nodes:
        return None
    rollups: List[ClusterRollup] = []
    if len(nodes) > 1:
        for metric, getter in (
            ("cpu_pct", lambda n: n.cpu_pct),
            ("memory_pct", lambda n: n.memory_pct),
            ("load_1m", lambda n: n.load_1m),
        ):
            r = _rollup(metric, [(n.hostname, getter(n)) for n in nodes])
            if r is not None:
                rollups.append(r)
    expected = max(expected_nodes or 0, len(nodes))
    return SystemView(
        nodes=nodes,
        rollups=rollups,
        expected_nodes=expected,
        missing_nodes=max(0, expected - len(nodes)),
        latest_ts=latest_ts,
    )


# ---------------------------------------------------------------------------
# process
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProcessRankStat:
    rank: int
    hostname: str
    pid: Optional[int]
    cpu_pct: Optional[float]
    rss_bytes: Optional[int]
    vms_bytes: Optional[int]
    num_threads: Optional[int]
    cpu_history: List[float]
    latest_ts: Optional[float]
    stale: bool


@dataclasses.dataclass(frozen=True)
class ProcessView:
    ranks: List[ProcessRankStat]
    busiest_rank: Optional[int]
    total_rss_bytes: int
    latest_ts: Optional[float]

    def as_dict(self) -> Dict[str, Any]:
        return _asdict(self)


def build_process_view(
    procs: Mapping[int, Sequence[Mapping[str, Any]]],
    *,
    now: Optional[float] = None,
    history_tail: int = 60,
) -> Optional[ProcessView]:
    if not procs:
        return None
    now = time.time() if now is None else now
    stats: List[ProcessRankStat] = []
    latest_ts: Optional[float] = None
    for rank in sorted(procs):
        rows = [r for r in procs[rank] if r]
        if not rows:
            continue
        last = rows[-1]
        ts = last.get("timestamp")
        if ts is not None:
            latest_ts = max(latest_ts or 0.0, float(ts))
        stats.append(
            ProcessRankStat(
                rank=int(rank),
                hostname=str(last.get("hostname") or ""),
                pid=last.get("pid"),
                cpu_pct=last.get("cpu_pct"),
                rss_bytes=last.get("rss_bytes"),
                vms_bytes=last.get("vms_bytes"),
                num_threads=last.get("num_threads"),
                cpu_history=[
                    float(r.get("cpu_pct") or 0.0) for r in rows[-history_tail:]
                ],
                latest_ts=float(ts) if ts is not None else None,
                stale=(now - float(ts)) > _STALE_AFTER_S if ts is not None else False,
            )
        )
    if not stats:
        return None
    with_cpu = [s for s in stats if s.cpu_pct is not None]
    busiest = max(with_cpu, key=lambda s: s.cpu_pct).rank if with_cpu else None
    return ProcessView(
        ranks=stats,
        busiest_rank=busiest,
        total_rss_bytes=sum(s.rss_bytes or 0 for s in stats),
        latest_ts=latest_ts,
    )
