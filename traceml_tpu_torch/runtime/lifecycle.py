"""In-process lifecycle entries.

Counterpart of ``traceml_tpu/runtime/lifecycle.py``, per-rank agent only:
``start_runtime`` returns the running agent (or a ``NoOpRuntime`` when it
fails to start), ``stop_runtime`` stops it with its final
drain, ``get_active_runtime`` returns it.
"""

from __future__ import annotations

from typing import Optional

from traceml_tpu_torch.runtime.runtime import NoOpRuntime, RuntimeSettings, TraceMLRuntime
from traceml_tpu_torch.utils.error_log import get_error_log

_active_runtime: Optional[TraceMLRuntime] = None


def start_runtime(settings: Optional[RuntimeSettings] = None):
    """Start the per-rank agent; returns it (or NoOpRuntime)."""
    global _active_runtime
    if _active_runtime is not None:
        return _active_runtime
    try:
        rt = TraceMLRuntime(settings)
        rt.start()
    except Exception as exc:
        get_error_log().error("start_runtime failed; tracing disabled", exc)
        return NoOpRuntime()
    _active_runtime = rt
    return rt


def stop_runtime() -> None:
    global _active_runtime
    rt = _active_runtime
    _active_runtime = None
    if rt is not None:
        try:
            rt.stop()
        except Exception as exc:
            get_error_log().warning("stop_runtime failed", exc)


def get_active_runtime():
    return _active_runtime
