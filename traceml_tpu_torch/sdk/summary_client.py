"""Worker-side summary client.

Counterpart of ``traceml_tpu/sdk/summary_client.py``.

``final_summary()``: file IPC with the aggregator, on the global primary
rank only — return the existing artifact if present, else drop a request
file, poll for the response, read ``final_summary.json``.

``summary()``: the final summary flattened into ``traceml/...`` scalars.

``live_metrics()``: this rank's recent telemetry from its own samplers,
no IPC.
"""

from __future__ import annotations

import statistics
import time
from pathlib import Path
from typing import Any, Dict, Optional

from traceml_tpu_torch.runtime.identity import resolve_runtime_identity
from traceml_tpu_torch.runtime.settings import settings_from_env
from traceml_tpu_torch.sdk import protocol
from traceml_tpu_torch.utils.atomic_io import read_json
from traceml_tpu_torch.utils.error_log import get_error_log


def _session_dir() -> Path:
    return settings_from_env().session_dir


def final_summary(timeout: float = 120.0, session_dir: Optional[Path] = None) -> Optional[Dict[str, Any]]:
    """Request and fetch the final summary dict (None on failure, and on
    every rank but the global primary).  The aggregator settles the
    telemetry in flight and writes the summary of the run so far; the
    summary written at the end of the run replaces it."""
    try:
        sdir = Path(session_dir) if session_dir else _session_dir()
        identity = resolve_runtime_identity()
        if not identity.is_global_primary:
            return None
        existing = read_json(protocol.get_final_summary_json_path(sdir))
        if existing is not None:
            return existing
        protocol.write_summary_request(sdir, identity.global_rank)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            resp = protocol.read_summary_response(sdir)
            if resp is not None:
                if not resp.get("ok"):
                    get_error_log().warning(f"final summary failed: {resp.get('error')}")
                    return None
                return read_json(protocol.get_final_summary_json_path(sdir))
            time.sleep(0.25)
        return None
    except Exception as exc:
        get_error_log().warning("final_summary client failed", exc)
        return None


def _flatten(prefix: str, obj: Any, out: Dict[str, Any]) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}/{k}", v, out)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix] = obj


def summary(timeout: float = 120.0, session_dir: Optional[Path] = None) -> Dict[str, Any]:
    """Flat ``{"traceml/...": scalar}`` dict for W&B/MLflow-style loggers,
    backed by the final summary (may block up to ``timeout``): call it at
    the end of the run; per step, :func:`live_metrics`."""
    data = final_summary(timeout=timeout, session_dir=session_dir)
    if not data:
        return {}
    out: Dict[str, Any] = {}
    _flatten("traceml", data, out)
    return out


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
