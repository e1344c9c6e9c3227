"""Manual-mode wrappers.

Counterpart of the parts of ``traceml_tpu/sdk/wrappers.py`` that the port
has: ``publish_region_marker`` (the shared marker chokepoint),
``wrap_forward``, ``wrap_backward`` and ``wrap_optimizer`` (each a timed
phase, duplicate-guarded against the auto-patches by the TLS depth
gates), ``wrap_h2d`` (a timed, marked host→device copy) and
``wrap_collective`` (an explicit collective timed as the ``collective``
phase).  Each region
closes with a CUDA marker after its work: on its output's device, or on
the trace's device when it returns no tensor (``backward()``,
``step()``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

from traceml_tpu_torch.sdk.state import TraceState, get_state
from traceml_tpu_torch.utils.device import resolve_device
from traceml_tpu_torch.utils.marker_resolver import get_marker_resolver
from traceml_tpu_torch.utils.timing import (
    BACKWARD_TIME,
    COLLECTIVE_TIME,
    FORWARD_TIME,
    H2D_TIME,
    OPTIMIZER_STEP,
    cuda_marker,
    timed_region,
)


def timed_call(phase: str, depth_attr: str, fn: Callable, st: TraceState,
               *args: Any, **kwargs: Any) -> Any:
    """``fn(*args, **kwargs)`` as one timed, marked ``phase`` region, with
    the TLS gate ``depth_attr`` raised while it runs; untimed when an
    outer wrapper or patch of the phase is timing already."""
    tls = st.tls
    depth = getattr(tls, depth_attr)
    if depth > 0:
        return fn(*args, **kwargs)
    setattr(tls, depth_attr, depth + 1)
    try:
        region = timed_region(phase, st.current_step, sink=st.buffer.add)
        with region as tr:
            out = fn(*args, **kwargs)
            if st.markers_enabled():
                tr.mark(out, st.marker_device)
        publish_region_marker(region.event, st)
        return out
    finally:
        setattr(tls, depth_attr, depth)


def publish_region_marker(ev, st: TraceState) -> None:
    """Post-close marker publication, shared by every phase owner: hand
    the marker to the open step envelope (last dispatch wins, so the
    envelope's device end is the last enqueued phase) and route it to the
    resolver at dispatch.

    This is also the overhead-governor chokepoint: on a step the governor
    chose not to device-sample, the marker is dropped here, so unsampled
    steps are uniformly host-only.  Out-of-step regions are never gated.
    """
    if ev.marker is None:
        return
    if st.tls.in_step:
        if not st.sample_markers:
            ev.marker = None  # governor: unsampled step, drop the probe
            return
        env = st.active_step_event
        if env is not None:
            env.marker = ev.marker
    if not ev.marker.resolved:
        get_marker_resolver().submit(ev.marker)


def to_device(value: Any, device: Any) -> Any:
    """``.to(device, non_blocking=True)`` over a tensor or a list, tuple or
    dict of them; other values pass through."""
    if hasattr(value, "to") and hasattr(value, "device"):
        return value.to(device, non_blocking=True)
    if isinstance(value, dict):
        return {k: to_device(v, device) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_device(v, device) for v in value)
    return value


def timed_to_device(value: Any, device: Any, st: TraceState) -> Any:
    """Copy ``value`` to ``device`` as a timed ``h2d`` phase, with a CUDA
    marker recorded right after the copy was enqueued; untimed when an
    outer wrapper is timing already.  The TLS gate ``h2d_depth`` stays
    raised while it copies, so the ``Tensor.to`` auto-patch does not time
    the copy a second time."""
    tls = st.tls
    if tls.h2d_depth > 0:
        return to_device(value, device)
    tls.h2d_depth += 1
    try:
        region = timed_region(H2D_TIME, st.current_step, sink=st.buffer.add)
        with region as tr:
            out = to_device(value, device)
            if device.type == "cuda" and st.markers_enabled():
                tr.event.marker = cuda_marker(device)
        publish_region_marker(region.event, st)
        return out
    finally:
        tls.h2d_depth -= 1


def wrap_h2d(value: Any, device: Any = None, state: Optional[TraceState] = None) -> Any:
    """Explicitly timed host→device transfer.  ``device`` defaults to the
    trace's device (CUDA); it raises when CUDA is absent and the CPU was
    not asked for."""
    st = state or get_state()
    dev = st.device if device is None else resolve_device(device)
    return timed_to_device(value, dev, st)


def wrap_forward(fn: Callable, state: Optional[TraceState] = None) -> Callable:
    """Time a forward callable (a module, or a function calling one)."""
    st = state or get_state()

    @functools.wraps(fn)
    def wrapped(*args: Any, **kwargs: Any):
        return timed_call(FORWARD_TIME, "forward_depth", fn, st, *args, **kwargs)

    wrapped._traceml_wrapped = True  # type: ignore[attr-defined]
    return wrapped


def wrap_backward(fn: Callable, state: Optional[TraceState] = None) -> Callable:
    """Time a backward callable (e.g. ``lambda: loss.backward()``)."""
    st = state or get_state()

    @functools.wraps(fn)
    def wrapped(*args: Any, **kwargs: Any):
        return timed_call(BACKWARD_TIME, "backward_depth", fn, st, *args, **kwargs)

    wrapped._traceml_wrapped = True  # type: ignore[attr-defined]
    return wrapped


def wrap_optimizer(optimizer: Any, state: Optional[TraceState] = None) -> Any:
    """Wrap an optimizer's ``.step`` in place: in a step, each call is an
    ``optimizer_step`` region.  The auto-patch's hooks leave a wrapped
    optimizer to this wrapper."""
    st = state or get_state()
    if getattr(optimizer, "_traceml_wrapped", False):
        return optimizer
    original_step = optimizer.step

    @functools.wraps(original_step)
    def step(*args: Any, **kwargs: Any):
        if not st.tls.in_step:
            return original_step(*args, **kwargs)
        region = timed_region(OPTIMIZER_STEP, st.current_step, sink=st.buffer.add)
        with region as tr:
            out = original_step(*args, **kwargs)
            if st.markers_enabled():
                tr.mark(out, st.marker_device)
        publish_region_marker(region.event, st)
        return out

    optimizer.step = step
    optimizer._traceml_wrapped = True
    return optimizer


def wrap_collective(fn: Callable, state: Optional[TraceState] = None) -> Callable:
    """Time an explicit collective (a gradient sync, an all-gather)
    dispatched from the host as the first-class ``collective`` phase,
    closed by a CUDA marker after its output, so the phase is
    device-timed like the others.  DDP's bucketed all-reduce runs in its
    C++ reducer, inside ``backward``; this wrapper is for the loops that
    dispatch their collectives themselves.  Feeds COLLECTIVE_STRAGGLER
    (``diagnostics/step_time/rules.py``)."""
    st = state or get_state()

    @functools.wraps(fn)
    def wrapped(*args: Any, **kwargs: Any):
        return timed_call(COLLECTIVE_TIME, "collective_depth", fn, st, *args, **kwargs)

    wrapped._traceml_wrapped = True  # type: ignore[attr-defined]
    return wrapped
