"""Per-rank runtime agent.

Counterpart of the per-rank part of ``traceml_tpu/runtime/runtime.py``: it
owns the step-time and step-memory samplers, a daemon tick thread at
``sampler_interval_sec`` and, when the settings name an aggregator port,
the TCP client and the publisher.  Every tick samples, and publishes
when there is a publisher.  Lifecycle: start → tick loop → stop (join
the thread, final drain, final publish with the ``rank_finished``
marker, close the client, stop the marker resolver).  Without a port
nothing is collected or encoded for sending: the rows stay in each
sampler's ``Database``.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from traceml_tpu_torch.runtime.sender import TelemetryPublisher
from traceml_tpu_torch.runtime.settings import TraceMLSettings
from traceml_tpu_torch.samplers.base_sampler import BaseSampler
from traceml_tpu_torch.samplers.step_memory_sampler import StepMemorySampler
from traceml_tpu_torch.samplers.step_time_sampler import StepTimeSampler
from traceml_tpu_torch.sdk.state import get_state
from traceml_tpu_torch.telemetry.control import build_rank_finished
from traceml_tpu_torch.telemetry.envelope import SenderIdentity
from traceml_tpu_torch.transport.tcp_transport import TCPClient
from traceml_tpu_torch.utils.error_log import get_error_log


class TraceMLRuntime:
    def __init__(self, settings: Optional[TraceMLSettings] = None) -> None:
        self.settings = settings or TraceMLSettings()
        self.identity = SenderIdentity.from_env(self.settings.session_id)
        self.samplers: List[BaseSampler] = []
        self.client: Optional[TCPClient] = None
        self.publisher: Optional[TelemetryPublisher] = None
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
        agg = self.settings.aggregator
        if agg.port:
            self.client = TCPClient(agg.connect_host, agg.port)
            self.publisher = TelemetryPublisher(self.samplers, self.client, self.identity)
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._sampler_loop, name="traceml-runtime", daemon=True)
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
        if self.client is not None:
            self.client.close()
        from traceml_tpu_torch.utils.marker_resolver import get_marker_resolver

        get_marker_resolver().stop()

    def sampler(self, name: str) -> Optional[BaseSampler]:
        return next((s for s in self.samplers if s.name == name), None)

    def _tick(self) -> None:
        for s in self.samplers:
            s.sample()
        if self.publisher is not None:
            self.publisher.publish()

    def _sampler_loop(self) -> None:
        interval = max(0.05, self.settings.sampler_interval_sec)
        while not self._stop_evt.wait(interval):
            try:
                self._tick()
            except Exception as exc:  # samplers and the publisher fail open anyway
                get_error_log().warning("runtime tick failed", exc)

    def _final_drain(self) -> None:
        """Shutdown: one last memory sample past the throttle, drain every
        sampler, then publish the leftovers with ``rank_finished``."""
        try:
            st = get_state()
            if st.mem_tracker is not None:
                st.mem_tracker.record(st.current_step, force=True)
        except Exception as exc:
            get_error_log().warning("final memory sample failed", exc)
        for s in self.samplers:
            s.drain()
        if self.publisher is not None:
            self.publisher.publish([build_rank_finished(self.identity.to_meta())], final=True)


class NoOpRuntime:
    """Fail-open stand-in: every method is a no-op."""

    settings = None
    samplers: List[BaseSampler] = []

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def sampler(self, name: str) -> None:
        return None
