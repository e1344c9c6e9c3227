"""``trace_step`` — the per-step bracket, and ``trace_time``.

Counterpart of ``traceml_tpu/sdk/instrumentation.py``.  One
``with trace_step():`` per step:

* advances the step counter (outermost-only; nesting is a no-op),
* records the step-start memory edge (on CUDA: resets the peak),
* opens the ``step_time`` envelope region,
* arms the TLS gates the timers consult,
* on exit: closes the envelope, records the step-end memory edge,
  flushes the step's events into the global queue, and submits device
  markers to the background resolver.

It never raises into user code, except that entering a step resolves the
trace's device first: with no CUDA and no ``init(device="cpu")`` it raises.
"""

from __future__ import annotations

from typing import Any, Optional

from traceml_tpu_torch.sdk.state import TraceState, get_state
from traceml_tpu_torch.sdk.wrappers import publish_region_marker
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.marker_resolver import get_marker_resolver
from traceml_tpu_torch.utils.overhead_governor import get_governor
from traceml_tpu_torch.utils.timing import STEP_TIME, timed_region


class trace_step:
    """Context manager bracketing one step."""

    def __init__(self, state: Optional[TraceState] = None) -> None:
        self._state = state or get_state()
        self._region: Optional[timed_region] = None
        self._step: Optional[int] = None
        self._outermost = False

    @property
    def step(self) -> Optional[int]:
        return self._step

    def mark(self, outputs: Any) -> Any:
        """Attach the step's device-completion probe (explicit form);
        ``wrap_step_fn`` does this itself."""
        try:
            self._state.mark_step_outputs(outputs)
        except Exception as exc:
            get_error_log().warning("trace_step.mark failed", exc)
        return outputs

    def __enter__(self) -> "trace_step":
        st = self._state
        if st.tls.in_step:
            return self  # nested: inert (outermost-only)
        # resolve the device before the fail-open block: without CUDA and
        # without init(device="cpu") this raises into the caller
        _ = st.device
        try:
            self._outermost = True
            gov = get_governor()
            # stamp the previous step's markers from this thread before
            # opening a new step (see MarkerResolver.sweep_inline)
            if gov.allow_inline_sweep():
                get_marker_resolver().sweep_inline()
            st.sample_markers = gov.begin_step()
            st.tls.in_step = True
            self._step = st.begin_step()
            st.ensure_mem_tracker().reset(self._step)
            self._region = timed_region(STEP_TIME, self._step, sink=st.buffer.add)
            self._region.__enter__()
            # back-date the envelope to the previous step's exit so steps
            # tile the wall clock: the inter-step gap (input fetch) lands
            # in THIS step's envelope
            if st.last_step_exit is not None:
                self._region.event.cpu_start = st.last_step_exit
            st.active_step_event = self._region.event
        except Exception as exc:
            get_error_log().warning("trace_step enter failed", exc)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if not self._outermost:
            return False
        st = self._state
        try:
            st.tls.in_step = False
            if self._region is not None:
                self._region.__exit__(exc_type, exc, tb)
                st.last_step_exit = self._region.event.cpu_end
                ev = self._region.event
                if ev.cpu_start is not None and ev.cpu_end is not None:
                    get_governor().observe_step(ev.cpu_end - ev.cpu_start)
            st.active_step_event = None
            step = self._step if self._step is not None else st.current_step
            if exc_type is None:
                st.ensure_mem_tracker().record(step)
            batch = st.flush_step(step)
            if batch is not None:
                resolver = get_marker_resolver()
                for ev in batch.events:
                    if ev.marker is not None and not ev.marker.resolved:
                        resolver.submit(ev.marker)
        except Exception as err:
            get_error_log().warning("trace_step exit failed", err)
        finally:
            # out-of-step instrumentation must never inherit an unsampled
            # step's gate
            st.sample_markers = True
        return False


class trace_time:
    """Named user region inside a step; its events are prefixed ``user:``.
    ``mark(outputs)`` records a CUDA marker after the region's work."""

    def __init__(self, name: str, state: Optional[TraceState] = None) -> None:
        self._state = state or get_state()
        self._name = f"user:{name}"
        self._region: Optional[timed_region] = None

    def mark(self, outputs: Any) -> Any:
        st = self._state
        if self._region is not None and st.markers_enabled():
            self._region.mark(outputs)
        return outputs

    def __enter__(self) -> "trace_time":
        try:
            st = self._state
            self._region = timed_region(
                self._name, st.current_step, sink=st.buffer.add
            )
            self._region.__enter__()
        except Exception as exc:
            get_error_log().warning("trace_time enter failed", exc)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            if self._region is not None:
                self._region.__exit__(exc_type, exc, tb)
                publish_region_marker(self._region.event, self._state)
        except Exception as err:
            get_error_log().warning("trace_time exit failed", err)
        return False
