"""Step-function wrapper for a torch callable.

Counterpart of ``traceml_tpu/sdk/step_fn.py``.  Each call of the wrapped
function is a ``compute_time`` region.  PyTorch runs eagerly, so there is
no jit, no compile tracker and no search of the outputs for a handle: the
device marker is a CUDA event recorded on the device's current stream
right after the call returns, when all of the call's work is enqueued.
The model FLOPs of a step come from :func:`estimate_step_flops` or
``set_step_flops``, not from this wrapper.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from traceml_tpu_torch.sdk.state import TraceState, get_state
from traceml_tpu_torch.sdk.wrappers import publish_region_marker
from traceml_tpu_torch.utils.device import resolve_device
from traceml_tpu_torch.utils.timing import COMPUTE_TIME, cuda_marker, timed_region


class WrappedStepFn:
    """Callable wrapper; one instance per traced step function."""

    def __init__(
        self,
        fn: Callable,
        *,
        device: Any = None,
        state: Optional[TraceState] = None,
        phase_name: str = COMPUTE_TIME,
    ) -> None:
        self._state = state or get_state()
        self._phase = phase_name
        self._fn = fn
        self.device = self._state.device if device is None else resolve_device(device)
        self.__wrapped__ = fn

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        st = self._state
        region = timed_region(self._phase, st.current_step, sink=st.buffer.add)
        # the auto-patched forward, backward and optimizer regions inside
        # stay unrecorded: their work is this region's
        st.tls.compute_depth += 1
        try:
            with region as tr:
                out = self._fn(*args, **kwargs)
                if self.device.type == "cuda" and st.markers_enabled():
                    marker = cuda_marker(self.device)
                    # the step function spans ~the whole step: the resolver
                    # may sleep toward its expected completion.  In-step
                    # only: out-of-step calls queue behind each other, so
                    # their lifetimes measure queue depth, not one step's
                    # compute
                    marker.step_end_hint = st.tls.in_step
                    tr.event.marker = marker
        finally:
            st.tls.compute_depth -= 1
        # envelope hand-off + dispatch-time resolver submission
        publish_region_marker(region.event, st)
        return out


def wrap_step_fn(
    fn: Callable, *, device: Any = None, state: Optional[TraceState] = None
) -> WrappedStepFn:
    """Wrap a torch step function for tracing.  ``device`` is where its
    work runs; it defaults to the trace's device, which is CUDA unless
    ``init(device="cpu")`` chose the CPU, and raises without CUDA."""
    return WrappedStepFn(fn, device=device, state=state)
