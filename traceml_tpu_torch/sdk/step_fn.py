"""Step-function wrapper for a torch callable.

Counterpart of ``traceml_tpu/sdk/step_fn.py``.  Each call of the wrapped
function is a ``compute_time`` region.  The function runs as the caller
wrote it (eager, or ``torch.compile``d by the caller: the wrapper jits
nothing), and there is no search of the outputs for a handle: the device
marker is a CUDA event recorded on the device's current stream right
after the call returns, when all of the call's work is enqueued.  As in
JAX, the wrapper makes sure the process-wide compile tracker is
installed (``instrumentation/compile_tracker.py``: dynamo's compiles as
``compile_time`` events) and ``compile_count`` reads the compiles seen
since it was built.

The model FLOPs of a step, the MFU numerator: where the JAX wrapper asks
XLA's cost analysis of the lowered program once, before the first
in-step call, PyTorch has no lowered program to ask.  So the first
in-step call itself runs under ``FlopCounterMode`` (the step is not run
twice) and the count is declared with ``set_step_flops(source=
"flop_counter")``.  A value declared before that call wins, and an
out-of-step call (an eval loop) neither counts nor spends the estimate.
``estimate_flops=False`` turns the count off.

The counted call runs under ``torch.compiler.set_stance("force_eager")``:
``FlopCounterMode`` is a dispatch mode, and dynamo, asked to compile a
frame under one, skips it and marks its code to be skipped for good, so
a ``torch.compile``d model would never compile.  Forced eager, dynamo
does not see the frame at all; the model's first compile moves to the
second call, and the count is the same operations'.

The counter's first op pays a one-off set-up (it imports DTensor, dynamo
and sympy: 1.5 s on an idle CPU host, far more on a loaded one).  Inside
the step that set-up would inflate step 1 until the step-time rules,
which read per-rank means, misjudge a short run, so the wrapper pays it
when it is built, outside any step (``_prime_flop_counter``).  The
counted step then carries only the counter's dispatch overhead.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from traceml_tpu_torch.sdk.flops import set_step_flops
from traceml_tpu_torch.sdk.state import TraceState, get_state
from traceml_tpu_torch.sdk.wrappers import publish_region_marker
from traceml_tpu_torch.utils.device import resolve_device
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.timing import COMPUTE_TIME, cuda_marker, timed_region

_flop_counter_primed = False


def _prime_flop_counter() -> None:
    """Run one CPU op under ``FlopCounterMode`` once per process, so the
    counter's lazy imports happen here and not in a traced step
    (fail-open: on an error the counted step pays them)."""
    global _flop_counter_primed
    if _flop_counter_primed:
        return
    _flop_counter_primed = True
    try:
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False):
            torch.zeros(1) + 1
    except Exception as exc:
        get_error_log().warning("wrap_step_fn FLOP counter set-up failed", exc)


class WrappedStepFn:
    """Callable wrapper; one instance per traced step function."""

    def __init__(
        self,
        fn: Callable,
        *,
        device: Any = None,
        state: Optional[TraceState] = None,
        phase_name: str = COMPUTE_TIME,
        estimate_flops: bool = True,
    ) -> None:
        self._state = state or get_state()
        self._phase = phase_name
        self._fn = fn
        self.device = self._state.device if device is None else resolve_device(device)
        self._flops_pending = estimate_flops
        if estimate_flops:
            _prime_flop_counter()
        self.__wrapped__ = fn
        from traceml_tpu_torch.instrumentation.compile_tracker import install_compile_tracker

        install_compile_tracker()
        # the tracker bumps the CURRENT global state: the snapshot and the
        # later read both come from get_state()
        self._compiles_at_start = get_state().compile_events_seen

    @property
    def compile_count(self) -> int:
        """Process-wide compile events seen since this wrapper was built
        (a superset of this function's own compiles)."""
        return get_state().compile_events_seen - self._compiles_at_start

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        st = self._state
        counter = None
        if self._flops_pending and st.tls.in_step:
            self._flops_pending = False
            if st.flops_per_step is None:  # a manual value wins
                from torch.utils.flop_counter import FlopCounterMode

                counter = FlopCounterMode(display=False)
        region = timed_region(self._phase, st.current_step, sink=st.buffer.add)
        # the auto-patched forward, backward and optimizer regions inside
        # stay unrecorded: their work is this region's
        st.tls.compute_depth += 1
        try:
            with region as tr:
                if counter is not None:
                    import torch

                    with torch.compiler.set_stance("force_eager"), counter:
                        out = self._fn(*args, **kwargs)
                else:
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
        if counter is not None:
            self._declare(counter)
        return out

    def _declare(self, counter: Any) -> None:
        """Declare the counted FLOPs (fail-open: nothing on an error or a
        count of 0)."""
        try:
            flops = float(counter.get_total_flops())
            if flops > 0:
                set_step_flops(flops, source="flop_counter")
        except Exception as exc:
            get_error_log().warning("wrap_step_fn FLOP count failed", exc)


def wrap_step_fn(
    fn: Callable,
    *,
    device: Any = None,
    state: Optional[TraceState] = None,
    estimate_flops: bool = True,
) -> WrappedStepFn:
    """Wrap a torch step function for tracing.  ``device`` is where its
    work runs; it defaults to the trace's device, which is CUDA unless
    ``init(device="cpu")`` chose the CPU, and raises without CUDA.
    ``estimate_flops`` (default on) counts the model FLOPs of the first
    in-step call (see the module docstring)."""
    return WrappedStepFn(fn, device=device, state=state, estimate_flops=estimate_flops)
