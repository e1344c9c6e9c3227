"""Worker-side live metrics.

Counterpart of ``live_metrics`` in ``traceml_tpu/sdk/summary_client.py``
(the final-summary request comes with the aggregator's summary service).
"""

from __future__ import annotations

import statistics
from typing import Any, Dict

from traceml_tpu_torch.utils.error_log import get_error_log


def live_metrics(window: int = 30) -> Dict[str, Any]:
    """Flat ``{"traceml/live/...": scalar}`` snapshot of THIS rank's
    recent telemetry — safe to call every step (in-process reads only).

    Emits per-phase host/device medians over the last ``window`` step
    rows of the runtime's step-time sampler, the device occupancy, the
    newest step-memory rows, and the step counter.  Only the step counter
    when the runtime isn't running (fail-open).
    """
    out: Dict[str, Any] = {}
    try:
        from traceml_tpu_torch.runtime.lifecycle import get_active_runtime
        from traceml_tpu_torch.sdk.state import get_state
        from traceml_tpu_torch.utils.step_time_window import (
            row_occupancy_parts,
            select_clock,
        )

        out["traceml/live/step"] = get_state().current_step
        rt = get_active_runtime()
        if rt is None:
            return out
        for sampler in getattr(rt, "samplers", []):
            if sampler.name == "step_time":
                rows = sampler.db.tail("step_time", window)
                # ONE clock for the whole window, by the window builder's
                # own policy
                clock = select_clock({0: rows}) if rows else "host"
                per_phase: Dict[str, list] = {}
                for row in rows:
                    for name, ev in (row.get("events") or {}).items():
                        key = name.rsplit(":", 1)[-1]
                        v = ev.get("device_ms") if clock == "device" else None
                        if v is None:
                            v = ev.get("cpu_ms")
                        if v is not None:
                            per_phase.setdefault(key, []).append(float(v))
                for key, vals in per_phase.items():
                    out[f"traceml/live/{key}_ms"] = statistics.median(vals)
                dev_sum = host_sum = 0.0
                for row in rows:
                    parts = row_occupancy_parts(row.get("events") or {})
                    if parts is not None:
                        dev_sum += parts[0]
                        host_sum += parts[1]
                if host_sum > 0:
                    out["traceml/live/occupancy"] = min(1.0, dev_sum / host_sum)
            elif sampler.name == "step_memory":
                # rows are per (step, device): the newest step's rows, max
                rows = sampler.db.tail("step_memory", 16)
                if rows:
                    latest_step = rows[-1].get("step")
                    newest = [r for r in rows if r.get("step") == latest_step]
                    for k in ("current_bytes", "step_peak_bytes", "limit_bytes"):
                        vals = [r[k] for r in newest if r.get(k) is not None]
                        if vals:
                            out[f"traceml/live/memory_{k}"] = max(vals)
    except Exception as exc:  # never raises into training
        get_error_log().warning("live_metrics failed", exc)
    return out
