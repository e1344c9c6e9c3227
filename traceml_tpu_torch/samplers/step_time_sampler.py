"""Step-time sampler.

Counterpart of ``traceml_tpu/samplers/step_time_sampler.py``.  Drains the
global step queue, waits for device markers **in step order** (FIFO: a
later step never emits before an earlier one — the window builder depends
on contiguous step rows), and aggregates each step's events into ONE row:

    {step, timestamp, events: {name: {cpu_ms, device_ms, count}},
     clock: "device"|"host"}

Device durations come from consecutive readiness edges (work on one CUDA
stream runs in order): for the events of one step ordered by host start,

    device_ms(e) = ready(e) − max(ready(prev_marked), cpu_start(e))

and the ``step_time`` envelope's device duration is the span from its host
start to the LAST readiness edge in the step.  On CUDA a readiness edge is
the marker event's own GPU timestamp.

An unresolved step blocks emission (keeps FIFO) until
``resolve_timeout_s``; on timeout the step emits host-only.

It also publishes the ``model_stats`` table: one row each time the step's
FLOPs declaration (``set_step_flops`` / ``estimate_step_flops``) changes,
with the device's peak FLOP/s, the MFU inputs of the final report.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from traceml_tpu_torch.samplers.base_sampler import BaseSampler
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.timing import (
    GLOBAL_STEP_QUEUE,
    STEP_TIME,
    StepTimeBatch,
    TimeEvent,
)

TABLE = "step_time"
MODEL_STATS_TABLE = "model_stats"
_RESOLVE_TIMEOUT_S = 10.0


def _aggregate_step(
    events: List[TimeEvent], prev_last_ready: Optional[float] = None
) -> tuple:
    """One step's events → (aggregate row, last readiness edge).

    ``prev_last_ready`` is the previous STEP's final readiness edge.
    Under async dispatch the host runs ahead of the device, so step N's
    device work begins when step N−1's work retires — not at step N's
    host start.  Carrying the edge across steps turns dispatch-to-
    completion spans into true device occupancy (the CUDA analogue: an
    event pair brackets stream work regardless of when the host enqueued
    it).  The FIFO emission order of the sampler makes this well-defined.
    """
    # Events arrive in host-issue order in the common case (the SDK
    # appends as the step executes) — detect that in one pass and skip
    # the per-step sort + list copy entirely.
    ordered = events
    for i in range(1, len(events)):
        if events[i].cpu_start < events[i - 1].cpu_start:
            ordered = sorted(events, key=lambda e: e.cpu_start)
            break
    # Late stamps (shutdown drain / timeout) carry observation times far
    # from the true completion — their device durations would be fiction,
    # so they are excluded and counted instead.
    late_markers = sum(
        1 for e in ordered if e.marker is not None and e.marker.late_stamp
    )
    prev_ready: Optional[float] = prev_last_ready
    device_ms: Dict[int, float] = {}
    last_ready: Optional[float] = prev_last_ready
    for i, ev in enumerate(ordered):
        if ev.name == STEP_TIME:
            continue  # envelope handled after the last edge is known
        if ev.marker is not None and ev.marker.late_stamp:
            continue
        ready = ev.device_ready_at
        if ready is None:
            continue
        start_edge = ev.cpu_start if prev_ready is None else max(prev_ready, ev.cpu_start)
        device_ms[i] = max(0.0, (ready - start_edge) * 1000.0)
        prev_ready = ready
        last_ready = ready

    agg: Dict[str, Dict[str, Any]] = {}
    have_device = False
    for i, ev in enumerate(ordered):
        if ev.cpu_ms is None:
            continue
        d_ms: Optional[float] = None
        if ev.name == STEP_TIME:
            if ev.marker is not None and ev.marker.late_stamp:
                d_ms = None
            elif ev.device_ready_at is not None:
                start_edge = ev.cpu_start
                if prev_last_ready is not None:
                    start_edge = max(start_edge, prev_last_ready)
                d_ms = max(0.0, (ev.device_ready_at - start_edge) * 1000.0)
            elif last_ready is not None and last_ready != prev_last_ready:
                d_ms = max(ev.cpu_ms, (last_ready - ev.cpu_start) * 1000.0)
        else:
            d_ms = device_ms.get(i)
        # get-then-insert instead of setdefault: setdefault builds a
        # fresh dict literal per EVENT even when the slot already exists
        # (hot path — every event of every step passes through here)
        slot = agg.get(ev.name)
        if slot is None:
            slot = agg[ev.name] = {"cpu_ms": 0.0, "device_ms": None, "count": 0}
        slot["cpu_ms"] += ev.cpu_ms
        slot["count"] += 1
        if d_ms is not None:
            slot["device_ms"] = (slot["device_ms"] or 0.0) + d_ms
            have_device = True
        if ev.meta:
            slot.setdefault("meta", {}).update(ev.meta)
    row = {"events": agg, "clock": "device" if have_device else "host"}
    if late_markers:
        row["late_markers"] = late_markers
    return row, last_ready


class StepTimeSampler(BaseSampler):
    name = "step_time"

    def __init__(self, resolve_timeout_s: float = _RESOLVE_TIMEOUT_S,
                 disk_backup_dir: Optional[Path] = None) -> None:
        super().__init__(disk_backup_dir)
        self._pending: List[StepTimeBatch] = []
        self._resolve_timeout = resolve_timeout_s
        self._last_ready: Optional[float] = None  # cross-step device edge
        self._stats_sent: Optional[tuple] = None
        self.steps_emitted = 0
        self.steps_timed_out = 0

    def _publish_model_stats(self) -> None:
        """One ``model_stats`` row whenever the declaration changes (keyed
        on all of it: a device-kind correction with the same FLOPs must
        still republish)."""
        try:
            from traceml_tpu_torch.sdk.state import get_state
            from traceml_tpu_torch.utils.chip_specs import peak_flops_for

            st = get_state()
            flops, tokens = st.flops_per_step, st.tokens_per_step
            key = (flops, st.flops_source, st.flops_device_kind, st.flops_device_count, tokens)
            if (flops is None and tokens is None) or key == self._stats_sent:
                return
            self._stats_sent = key
            self.db.add_record(MODEL_STATS_TABLE, {
                "timestamp": time.time(),
                "flops_per_step": float(flops) if flops is not None else None,
                "flops_source": st.flops_source,
                "device_kind": st.flops_device_kind,
                "peak_flops": peak_flops_for(st.flops_device_kind),
                "device_count": st.flops_device_count,
                "tokens_per_step": tokens,
            })
        except Exception as exc:  # fail-open: MFU never breaks sampling
            get_error_log().warning("model_stats publish failed", exc)

    def _emit(self, batches: List[StepTimeBatch]) -> None:
        for batch in batches:
            row, self._last_ready = _aggregate_step(batch.events, self._last_ready)
            row["step"] = batch.step
            row["timestamp"] = time.time()
            self.db.add_record(TABLE, row)
            self.steps_emitted += 1

    def _sample(self) -> None:
        self._publish_model_stats()
        self._pending.extend(GLOBAL_STEP_QUEUE.drain())
        now = time.perf_counter()
        emit_upto = 0
        for batch in self._pending:
            if batch.resolved():
                emit_upto += 1
            elif now - batch.flushed_at > self._resolve_timeout:
                self.steps_timed_out += 1
                batch.force_resolve()  # stamps flagged late → host-only row
                emit_upto += 1
            else:
                break  # FIFO: wait for the earliest unresolved step
        self._emit(self._pending[:emit_upto])
        del self._pending[:emit_upto]

    def drain(self) -> None:
        """End of run: give the resolver one last bounded window, then
        stamp leftovers as late and emit."""
        from traceml_tpu_torch.utils.marker_resolver import get_marker_resolver

        self._publish_model_stats()
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            self._pending.extend(GLOBAL_STEP_QUEUE.drain())
            get_marker_resolver().sweep_inline(max_n=1024)
            if all(b.resolved() for b in self._pending):
                break
            time.sleep(0.02)
        for batch in self._pending:
            batch.force_resolve()
        self._emit(self._pending)
        self._pending.clear()
