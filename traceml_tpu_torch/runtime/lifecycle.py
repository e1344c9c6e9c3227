"""In-process lifecycle entries.

Counterpart of ``traceml_tpu/runtime/lifecycle.py``, per-rank agent only:
``start_runtime`` returns the running agent (or a ``NoOpRuntime`` when
tracing is disabled or the agent fails to start), ``stop_runtime`` stops
it with its final drain and publish, ``get_active_runtime`` returns it.
Without explicit settings the agent reads the ``TRACEML_*`` environment
the launcher wrote (``runtime/settings.py``).
"""

from __future__ import annotations

from typing import Optional

from traceml_tpu_torch.runtime.runtime import NoOpRuntime, TraceMLRuntime
from traceml_tpu_torch.runtime.settings import TraceMLSettings, settings_from_env
from traceml_tpu_torch.utils.error_log import get_error_log

_active_runtime: Optional[TraceMLRuntime] = None


def start_runtime(settings: Optional[TraceMLSettings] = None):
    """Start the per-rank agent; returns it (or NoOpRuntime)."""
    global _active_runtime
    if _active_runtime is not None:
        return _active_runtime
    try:
        settings = settings or settings_from_env()
        if settings.disabled:
            return NoOpRuntime()
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
