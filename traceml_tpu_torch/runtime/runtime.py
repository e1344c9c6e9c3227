"""Per-rank runtime agent.

Counterpart of the per-rank part of ``traceml_tpu/runtime/runtime.py``: it
owns the step-time and step-memory samplers and a daemon tick thread at
``sampler_interval_sec``.  Lifecycle: start → tick loop → stop (join the
thread, stop the marker resolver, final drain).  There is no sender yet:
the rows stay in each sampler's ``Database``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

from traceml_tpu_torch.samplers.base_sampler import BaseSampler
from traceml_tpu_torch.samplers.step_memory_sampler import StepMemorySampler
from traceml_tpu_torch.samplers.step_time_sampler import StepTimeSampler
from traceml_tpu_torch.sdk.state import get_state
from traceml_tpu_torch.utils.error_log import get_error_log


@dataclasses.dataclass(frozen=True)
class RuntimeSettings:
    sampler_interval_sec: float = 1.0


class TraceMLRuntime:
    def __init__(self, settings: Optional[RuntimeSettings] = None) -> None:
        self.settings = settings or RuntimeSettings()
        self.samplers: List[BaseSampler] = []
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._started = False
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
        self.samplers = [StepTimeSampler(), StepMemorySampler()]
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._sampler_loop, name="traceml-runtime", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        with self._lock:
            if not self._started:
                return
            self._started = False
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, self.settings.sampler_interval_sec * 3))
            self._thread = None
        try:
            self._final_drain()
        except Exception as exc:
            get_error_log().warning("final drain failed", exc)
        from traceml_tpu_torch.utils.marker_resolver import get_marker_resolver

        get_marker_resolver().stop()

    def sampler(self, name: str) -> Optional[BaseSampler]:
        return next((s for s in self.samplers if s.name == name), None)

    def _tick(self) -> None:
        for s in self.samplers:
            s.sample()

    def _sampler_loop(self) -> None:
        interval = max(0.05, self.settings.sampler_interval_sec)
        while not self._stop_evt.wait(interval):
            try:
                self._tick()
            except Exception as exc:  # samplers fail open anyway
                get_error_log().warning("runtime tick failed", exc)

    def _final_drain(self) -> None:
        """Shutdown: one last memory sample past the throttle, then drain
        every sampler."""
        try:
            st = get_state()
            if st.mem_tracker is not None:
                st.mem_tracker.record(st.current_step, force=True)
        except Exception as exc:
            get_error_log().warning("final memory sample failed", exc)
        for s in self.samplers:
            s.drain()


class NoOpRuntime:
    """Fail-open stand-in: every method is a no-op."""

    settings = None
    samplers: List[BaseSampler] = []

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def sampler(self, name: str) -> None:
        return None
