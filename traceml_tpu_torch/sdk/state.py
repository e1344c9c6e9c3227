"""Process-wide trace state.

Counterpart of ``traceml_tpu/sdk/state.py``: the step counter, the per-step
event buffer, the step-memory tracker and the TLS gates.  The port adds
the device the trace runs on: ``init(device=...)`` sets it; unset, it is
CUDA, and resolving it raises when CUDA is absent.  And one TLS gate
of its own, ``compute_depth``: open while ``wrap_step_fn``'s compute
region runs, so that an auto-patched forward, backward or optimizer
region inside it is not recorded a second time.  As in JAX,
``on_step_flushed`` holds callbacks called with the step number after
every flush (the runtime's ``--trace-max-steps`` lifecycle); a raising
callback is skipped.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from traceml_tpu_torch.utils.device import resolve_device
from traceml_tpu_torch.utils.step_memory import StepMemoryTracker, detect_backend
from traceml_tpu_torch.utils.timing import (
    GLOBAL_STEP_QUEUE,
    StepEventBuffer,
    StepTimeBatch,
    TimeEvent,
)


class _TLS(threading.local):
    def __init__(self) -> None:
        self.in_step = False
        self.forward_depth = 0
        self.backward_depth = 0
        self.compute_depth = 0
        self.h2d_depth = 0
        self.collective_depth = 0
        self.dataloader_depth = 0


class TraceState:
    """Singleton-ish process state (tests may construct their own)."""

    def __init__(self, device: Any = None) -> None:
        self._lock = threading.RLock()
        self.tls = _TLS()
        self.step_counter = 0
        self.buffer = StepEventBuffer()
        self.mem_tracker: Optional[StepMemoryTracker] = None
        self.initialized = False
        self.patch_mode: Optional[str] = None
        self.patches: List[str] = []
        self.active_step_event: Optional[TimeEvent] = None
        self._device = None if device is None else resolve_device(device)
        # host time of the previous trace_step exit: successive steps tile
        # the wall clock, so inter-step host time (input fetch) is
        # attributed to the step that consumes the batch
        self.last_step_exit: Optional[float] = None
        # per-step device-marker gate, set by trace_step.__enter__ from
        # the overhead governor; a whole step is either marked or not
        self.sample_markers = True
        # model FLOPs of one training step (set_step_flops or
        # estimate_step_flops), the MFU numerator: its source ("manual" or
        # "flop_counter"), the device whose peak is the denominator and
        # how many of them the step runs on
        self.flops_per_step: Optional[float] = None
        self.flops_source: Optional[str] = None
        self.flops_device_kind: Optional[str] = None
        self.flops_device_count: Optional[int] = None
        # tokens consumed by one training step (set_step_tokens): the
        # tokens/s numerator, independent of the FLOPs
        self.tokens_per_step: Optional[float] = None
        # called with the step number after each flush (max-steps lifecycle)
        self.on_step_flushed: List[Callable[[int], None]] = []

    # -- device ----------------------------------------------------------
    @property
    def device(self):
        """The trace's device; CUDA unless set, raising without CUDA."""
        dev = self._device
        if dev is None:
            with self._lock:
                if self._device is None:
                    self._device = resolve_device(None)
                dev = self._device
        return dev

    @property
    def marker_device(self):
        """The trace's device if it is resolved already, else None: where
        a region with no tensor output records its marker.  Never
        raises (``trace_step`` resolves the device on entry)."""
        return self._device

    def set_device(self, device: Any) -> None:
        with self._lock:
            self._device = resolve_device(device)

    # -- step lifecycle ------------------------------------------------
    def begin_step(self) -> int:
        with self._lock:
            self.step_counter += 1
            return self.step_counter

    @property
    def current_step(self) -> int:
        with self._lock:
            return self.step_counter

    def ensure_mem_tracker(self) -> StepMemoryTracker:
        mt = self.mem_tracker
        if mt is not None:
            return mt
        with self._lock:
            if self.mem_tracker is None:
                self.mem_tracker = StepMemoryTracker(detect_backend(self.device))
            return self.mem_tracker

    def markers_enabled(self) -> bool:
        """THE device-marker gating policy: sample markers when the
        governor chose to for this step, and always out of a step."""
        return self.sample_markers or not self.tls.in_step

    def mark_step_outputs(self, outputs: Any) -> None:
        """Point the open step envelope's device marker at ``outputs``."""
        if not self.sample_markers:
            return
        ev = self.active_step_event
        if ev is not None:
            ev.attach_marker(outputs)

    def flush_step(self, step: int) -> Optional[StepTimeBatch]:
        batch = self.buffer.flush(step)
        if batch is not None:
            GLOBAL_STEP_QUEUE.put(batch)
        for cb in list(self.on_step_flushed):
            try:
                cb(step)
            except Exception:
                pass
        return batch


_state = TraceState()


def get_state() -> TraceState:
    return _state


def reset_state_for_tests(device: Any = None) -> TraceState:
    """Replace global state (test isolation only), with the overhead
    governor and the shared queues, and remove the auto-patches."""
    global _state
    from traceml_tpu_torch.sdk.initial import shutdown_patches
    from traceml_tpu_torch.utils.overhead_governor import reset_governor_for_tests
    from traceml_tpu_torch.utils.timing import GLOBAL_STEP_MEMORY_QUEUE

    shutdown_patches()
    reset_governor_for_tests()
    GLOBAL_STEP_QUEUE.drain()
    GLOBAL_STEP_MEMORY_QUEUE.drain()
    _state = TraceState(device)
    return _state
