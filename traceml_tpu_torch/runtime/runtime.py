"""Per-rank runtime agent.

Counterpart of the per-rank part of ``traceml_tpu/runtime/runtime.py``: it
resolves the rank's identity (``runtime/identity.py``), owns the samplers
that ``runtime/sampler_registry.build_samplers`` gives this rank (system on
the node's primary rank, process, step time, step memory), a daemon tick
thread at ``sampler_interval_sec`` and, when the settings name an
aggregator port, the telemetry client that ``transport/select.py`` picks
(the rank's shm ring when the aggregator is on loopback, else a Unix
socket or TCP; ``TRACEML_TRANSPORT`` forces one) and the publisher, which
announces that choice once and whose failed sends wait in
``rank_dir(rank)/"spool"`` for the aggregator to come back.  In
the ``cli`` and ``dashboard`` modes it also tees the script's stdout and
stderr (stdout only under ``--no-capture-stderr``) through a
:class:`StreamCapture`, which the stdout/stderr sampler drains, as the
JAX runtime does.  Each tick is the ``rank.tick`` chaos point
(``dev/chaos.py``).

The recording lifecycle (``runtime/state.py``), as in JAX: with
``trace_max_steps`` N the flush of step N moves RECORDING to DRAINING.
While RECORDING every tick samples every sampler and publishes.  The
first DRAINING tick drains only the drain-on-stop samplers (step_time,
step_memory: the steps flushed so far, past N too), moves to COMPLETE
and publishes with the send-once ``rank_finished`` marker; from then on
the rank samples and publishes nothing, while the script trains on.
Each tick until it succeeds also tries to capture the rank's mesh
placement (``utils/topology.py``: a mesh ``parallel/mesh.make_mesh``
built, or ``TRACEML_MESH``) and publishes it once as the
``mesh_topology`` control message, as the JAX runtime does.
At stop the final drain runs as in JAX: every sampler drains once more
and the final publish ships what it collected, the steps flushed after
the drain tick among it (the SDK keeps tracing after the cap).

Lifecycle: start (capture first, so the samplers see the script's first
line) → tick loop → stop (join the thread, final drain, final publish
with ``rank_finished`` unless it went already, restore the streams, the
samplers' last backup flush, close the spool and the client, stop the
marker resolver).  With an aggregator port or ``disk_backup`` the
publisher collects and encodes each tick's rows (a backup without a port
is written but not sent); with neither, the rows stay in each sampler's
``Database``.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from traceml_tpu_torch.dev import chaos
from traceml_tpu_torch.runtime.identity import resolve_runtime_identity
from traceml_tpu_torch.runtime.sampler_registry import build_samplers
from traceml_tpu_torch.runtime.sender import TelemetryPublisher
from traceml_tpu_torch.runtime.settings import TraceMLSettings
from traceml_tpu_torch.runtime.state import COMPLETE, DRAINING, RECORDING, RecordingState
from traceml_tpu_torch.runtime.stdout_capture import CAPTURE_MODES, StreamCapture
from traceml_tpu_torch.samplers.base_sampler import BaseSampler
from traceml_tpu_torch.sdk.state import get_state
from traceml_tpu_torch.telemetry.control import build_mesh_topology, build_rank_finished
from traceml_tpu_torch.transport.select import create_transport_client
from traceml_tpu_torch.transport.tcp_transport import TCPClient
from traceml_tpu_torch.utils.error_log import get_error_log


class TraceMLRuntime:
    def __init__(self, settings: Optional[TraceMLSettings] = None) -> None:
        self.settings = settings or TraceMLSettings()
        self.runtime_identity = resolve_runtime_identity()
        self.identity = self.runtime_identity.to_sender_identity(self.settings.session_id)
        self.recording = RecordingState(self.settings.trace_max_steps)
        self.capture: Optional[StreamCapture] = None
        if self.settings.mode in CAPTURE_MODES:
            self.capture = StreamCapture(capture_stderr=self.settings.capture_stderr)
        self.samplers: List[BaseSampler] = []
        self.client: Optional[TCPClient] = None
        self.publisher: Optional[TelemetryPublisher] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._started = False
        self._finished_sent = False
        self._mesh_sent = False
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
        if self.capture is not None:
            self.capture.start()
        self.samplers = build_samplers(self.settings, self.runtime_identity, self.capture)
        # a TCPClient, UDSClient or ShmRingClient (same send interface)
        self.client, transport_info = create_transport_client(self.settings, self.identity.global_rank)
        if self.client is not None or self.settings.disk_backup:
            # failed sends wait in the rank's replay spool for the
            # (restarted) aggregator, which drops what it holds by seq
            self.publisher = TelemetryPublisher(
                self.samplers, self.client, self.identity,
                spool_dir=self.settings.rank_dir(self.identity.global_rank) / "spool",
                transport_info=transport_info,
            )
        get_state().on_step_flushed.append(self.recording.on_step_flushed)
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
        if self.capture is not None:
            self.capture.stop()
        for s in self.samplers:
            s.stop()
        if self.publisher is not None:
            self.publisher.close()
        if self.client is not None:
            self.client.close()
        try:
            get_state().on_step_flushed.remove(self.recording.on_step_flushed)
        except ValueError:
            pass
        from traceml_tpu_torch.utils.marker_resolver import get_marker_resolver

        get_marker_resolver().stop()

    def sampler(self, name: str) -> Optional[BaseSampler]:
        return next((s for s in self.samplers if s.name == name), None)

    def _take_rank_finished(self) -> Optional[list]:
        """The send-once ``rank_finished`` marker, or None once taken (the
        tick thread and the final drain can race when the join times
        out)."""
        with self._lock:
            if self._finished_sent:
                return None
            self._finished_sent = True
        return [build_rank_finished(self.identity.to_meta())]

    def _take_mesh_topology(self) -> Optional[list]:
        """The send-once ``mesh_topology`` message, or None while no mesh
        is discoverable: the script may build its mesh any number of
        steps into the run, so every tick retries until the capture
        succeeds, then latches.  A capture that raises stops the retries."""
        with self._lock:
            if self._mesh_sent:
                return None
        try:
            from traceml_tpu_torch.utils.topology import capture_local_topology

            topo = capture_local_topology(self.identity.global_rank, self.identity.world_size)
        except Exception as exc:
            get_error_log().warning("mesh topology capture failed", exc)
            with self._lock:
                self._mesh_sent = True
            return None
        if topo is None:
            return None
        with self._lock:
            if self._mesh_sent:
                return None
            self._mesh_sent = True
        return [build_mesh_topology(self.identity.to_meta(), topo)]

    def _tick(self) -> None:
        if chaos.active():
            chaos.fire("rank.tick")  # a kill9 rule ends the process inside fire()
        phase = self.recording.phase
        if phase == RECORDING:
            for s in self.samplers:
                s.sample()
        elif phase == DRAINING:
            for s in self.samplers:
                if getattr(getattr(s, "_spec", None), "drain_on_recording_stop", False):
                    s.drain()
            self.recording.mark_drained()
        extra = self._take_mesh_topology()
        if self.recording.phase == COMPLETE:
            extra = (extra or []) + (self._take_rank_finished() or []) or None
        if self.publisher is not None and (self.recording.phase != COMPLETE or extra):
            self.publisher.publish(extra)

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
            # final=True forces every backup writer out, throttled or not
            extra = (self._take_mesh_topology() or []) + (self._take_rank_finished() or [])
            self.publisher.publish(extra or None, final=True)


class NoOpRuntime:
    """Fail-open stand-in: every method is a no-op."""

    settings = None
    samplers: List[BaseSampler] = []

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def sampler(self, name: str) -> None:
        return None
