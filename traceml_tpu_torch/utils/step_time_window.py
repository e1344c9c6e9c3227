"""Selected-clock step-time window pipeline.

Counterpart of ``traceml_tpu/utils/step_time_window.py`` (copied: the
port keeps its own copy of the pure-Python helpers it needs).

Takes per-rank step rows (as produced by the step-time sampler /
``step_time_samples`` projection) and builds the window every renderer,
diagnostic and report consumes:

1. **suffix alignment** — compare ranks over the common suffix of steps
   all of them have reported (reference: utils/step_windows.py:14);
2. **clock selection** — "device" only if EVERY rank/step has device
   timing for the step envelope, else "host";
3. **phase extraction + residual clamp** — per step:
   ``residual = max(0, step − Σ accounted phases)``;
4. **per-rank averages + cross-rank metrics** — median/worst/skew per
   phase, with per-step series.

Phase vocabulary: input, h2d, forward, backward, optimizer, compute (the
wrapped step function), compile, collective and checkpoint.  Durations
are in milliseconds.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Mapping, Optional, Sequence

from traceml_tpu_torch.utils import timing as T

# phase key → internal event name
PHASES: Dict[str, str] = {
    "input": T.DATALOADER_NEXT,
    "h2d": T.H2D_TIME,
    "forward": T.FORWARD_TIME,
    "backward": T.BACKWARD_TIME,
    "optimizer": T.OPTIMIZER_STEP,
    "compute": T.COMPUTE_TIME,
    "compile": T.COMPILE_TIME,
    "collective": T.COLLECTIVE_TIME,
    "checkpoint": T.CHECKPOINT_TIME,
}
STEP_KEY = "step_time"
RESIDUAL_KEY = "residual"
ACCOUNTED_PHASES = tuple(PHASES.keys())
ALL_KEYS = (STEP_KEY,) + ACCOUNTED_PHASES + (RESIDUAL_KEY,)


@dataclasses.dataclass
class RankWindow:
    """One rank's aligned window."""

    rank: int
    steps: List[int]
    # per phase key → per-step ms values (aligned with ``steps``)
    series: Dict[str, List[float]]
    # per phase key → window average ms
    averages: Dict[str, float]
    # per phase key → window MEDIAN ms — the contention-robust per-rank
    # statistic: a host burst covering a few steps inflates the mean
    # but barely moves the median, so cross-rank comparisons (the
    # straggler math) read medians to keep attribution stable when the
    # host is loaded (round-2 flake: INPUT_STRAGGLER degraded to
    # INPUT_BOUND under full-suite contention)
    medians: Dict[str, float]
    clock: str
    # device-busy share of the wall clock: Σ phase device durations /
    # Σ host(step envelope) over the window — the TPU stand-in for a
    # chip-utilization counter (phase readiness edges tile chip
    # occupancy; host envelopes tile wall)
    occupancy: Optional[float] = None


@dataclasses.dataclass
class StepCombinedTimeMetric:
    """Cross-rank stats for one phase
    (reference: renderers/step_time/schema.py:50)."""

    key: str
    per_rank_avg_ms: Dict[int, float]
    median_ms: float
    worst_ms: float
    worst_rank: int
    skew_pct: float  # (worst − median) / median, 0 when median==0

    @property
    def mean_ms(self) -> float:
        vals = list(self.per_rank_avg_ms.values())
        return sum(vals) / len(vals) if vals else 0.0


@dataclasses.dataclass
class StepTimeWindow:
    clock: str
    steps: List[int]  # the aligned step ids
    ranks: List[int]
    rank_windows: Dict[int, RankWindow]
    metrics: Dict[str, StepCombinedTimeMetric]
    phases_present: List[str]
    n_steps: int

    def metric(self, key: str) -> Optional[StepCombinedTimeMetric]:
        return self.metrics.get(key)

    @property
    def occupancy_by_rank(self) -> Dict[int, float]:
        return {
            r: w.occupancy
            for r, w in self.rank_windows.items()
            if w.occupancy is not None
        }

    @property
    def median_occupancy(self) -> Optional[float]:
        vals = list(self.occupancy_by_rank.values())
        return statistics.median(vals) if vals else None

    def share_of_step(self, key: str) -> Optional[float]:
        """median(phase) / median(step) — the phase-share statistic."""
        m = self.metrics.get(key)
        s = self.metrics.get(STEP_KEY)
        if m is None or s is None or s.median_ms <= 0:
            return None
        return m.median_ms / s.median_ms


def common_suffix_steps(per_rank_steps: Mapping[int, Sequence[int]], max_steps: int) -> List[int]:
    """Steps present in EVERY rank, newest-first truncated to max_steps,
    returned ascending (reference: utils/step_windows.py:14)."""
    if not per_rank_steps:
        return []
    common = None
    for steps in per_rank_steps.values():
        s = set(steps)
        common = s if common is None else (common & s)
    if not common:
        return []
    return sorted(common)[-max_steps:]


def _row_value(row: Mapping[str, Any], event_name: str, clock: str) -> Optional[float]:
    ev = (row.get("events") or {}).get(event_name)
    if not ev:
        return None
    if clock == "device":
        v = ev.get("device_ms")
        if v is not None:
            return float(v)
        # fall back to host for phases that have no device side (input)
        v = ev.get("cpu_ms")
        return float(v) if v is not None else None
    v = ev.get("cpu_ms")
    return float(v) if v is not None else None


def row_occupancy_parts(events: Mapping[str, Any]) -> Optional[tuple]:
    """(device_busy_ms, host_ms) for ONE step row, or None.

    THE chip-occupancy definition — every consumer (window builder,
    live_metrics) routes through here so the definition cannot fork:

    * numerator: Σ PHASE device durations (consecutive readiness edges
      are serial, so they tile device occupancy).  The ENVELOPE's device
      span is NOT used when phase timings exist — its start edge carries
      from the previous step's retirement, so it includes pre-dispatch
      idle (input wait) and reads ~100% busy on an input-bound run;
    * fallback: envelope-only instrumentation (no timed phase regions)
      uses the envelope span — an UPPER bound on busy, but far better
      than silencing the low-utilization rule entirely;
    * 0.0 is a legitimate duration (idle step); only None excludes.
    """
    env = events.get(T.STEP_TIME) or {}
    host = env.get("cpu_ms")
    if host is None:
        return None
    timed = [
        ev.get("device_ms")
        for name, ev in events.items()
        if name != T.STEP_TIME and ev and ev.get("device_ms") is not None
    ]
    if timed:
        return (float(sum(timed)), float(host))
    if env.get("device_ms") is not None:
        return (float(env["device_ms"]), float(host))
    return None


def select_clock(rank_rows: Mapping[int, Sequence[Mapping[str, Any]]]) -> str:
    """"device" only if every rank/step row carries device timing for the
    step envelope (reference: _select_clock_from_events:185)."""
    saw_any = False
    for rows in rank_rows.values():
        for row in rows:
            saw_any = True
            ev = (row.get("events") or {}).get(T.STEP_TIME) or {}
            if row.get("clock") != "device" or ev.get("device_ms") is None:
                return "host"
    return "device" if saw_any else "host"


def build_rank_window(
    rank: int,
    rows: Sequence[Mapping[str, Any]],
    steps: Sequence[int],
    clock: str,
) -> RankWindow:
    """Phase extraction + residual clamp (reference: _build_rank_timing)."""
    by_step = {int(r["step"]): r for r in rows if r.get("step") is not None}
    series: Dict[str, List[float]] = {k: [] for k in ALL_KEYS}
    dev_sum = host_sum = 0.0
    for step in steps:
        row = by_step.get(step)
        if row is None:
            for k in ALL_KEYS:
                series[k].append(0.0)
            continue
        parts = row_occupancy_parts(row.get("events") or {})
        if parts is not None:
            dev_sum += parts[0]
            host_sum += parts[1]
        step_ms = _row_value(row, T.STEP_TIME, clock) or 0.0
        accounted = 0.0
        for key, event_name in PHASES.items():
            v = _row_value(row, event_name, clock) or 0.0
            # clamp any phase to the step envelope (device quantization
            # can make a phase nominally exceed the step)
            v = min(v, step_ms) if step_ms > 0 else v
            series[key].append(v)
            accounted += v
        residual = max(0.0, step_ms - accounted)
        series[STEP_KEY].append(step_ms)
        series[RESIDUAL_KEY].append(residual)
    averages = {
        k: (sum(vs) / len(vs) if vs else 0.0) for k, vs in series.items()
    }
    medians = {
        k: (statistics.median(vs) if vs else 0.0) for k, vs in series.items()
    }
    return RankWindow(
        rank=rank,
        steps=list(steps),
        series=series,
        averages=averages,
        medians=medians,
        clock=clock,
        # cap: device readiness quantization can nominally exceed wall.
        # host_sum>0 alone gates (dual-clock rows existed): a fully idle
        # window must read 0.0, not None — None would silence the
        # LOW_DEVICE_UTILIZATION rule exactly when it matters most
        occupancy=min(dev_sum / host_sum, 1.0) if host_sum > 0 else None,
    )


def build_step_time_metrics(rank_windows: Mapping[int, RankWindow]) -> Dict[str, StepCombinedTimeMetric]:
    metrics: Dict[str, StepCombinedTimeMetric] = {}
    if not rank_windows:
        return metrics
    for key in ALL_KEYS:
        per_rank = {r: w.averages.get(key, 0.0) for r, w in rank_windows.items()}
        vals = list(per_rank.values())
        if not vals:  # empty-window early-out: never reach median([])
            continue
        med = statistics.median(vals)
        worst_rank = max(per_rank, key=lambda r: per_rank[r])
        worst = per_rank[worst_rank]
        skew = (worst - med) / med if med > 0 else 0.0
        metrics[key] = StepCombinedTimeMetric(
            key=key,
            per_rank_avg_ms=per_rank,
            median_ms=med,
            worst_ms=worst,
            worst_rank=worst_rank,
            skew_pct=skew,
        )
    return metrics


def build_step_time_window(
    rank_rows: Mapping[int, Sequence[Mapping[str, Any]]],
    max_steps: int = 200,
) -> Optional[StepTimeWindow]:
    """rank → step rows ⇒ aligned cross-rank window
    (reference: build_step_time_window_from_events:437)."""
    rank_rows = {r: list(rows) for r, rows in rank_rows.items() if rows}
    if not rank_rows:
        return None
    steps = common_suffix_steps(
        {r: [int(row["step"]) for row in rows if row.get("step") is not None]
         for r, rows in rank_rows.items()},
        max_steps,
    )
    if not steps:
        return None
    clock = select_clock(rank_rows)
    windows = {
        r: build_rank_window(r, rows, steps, clock)
        for r, rows in rank_rows.items()
    }
    metrics = build_step_time_metrics(windows)
    phases_present = [
        k
        for k in ACCOUNTED_PHASES
        if any(any(v > 0 for v in w.series[k]) for w in windows.values())
    ]
    return StepTimeWindow(
        clock=clock,
        steps=steps,
        ranks=sorted(windows),
        rank_windows=windows,
        metrics=metrics,
        phases_present=phases_present,
        n_steps=len(steps),
    )
