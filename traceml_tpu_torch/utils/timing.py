"""Step-phase timing core on CUDA.

Counterpart of ``traceml_tpu/utils/timing.py``.  Each :class:`TimeEvent`
records host enter/exit times and, optionally, a :class:`DeviceMarker`.
On CUDA a marker is a ``torch.cuda.Event(enable_timing=True)`` recorded on
the current stream right after the phase's work was enqueued: its
``is_ready()`` is ``event.query()``, and the phase's device edge is the
event's own GPU timestamp, mapped onto ``time.perf_counter`` through one
anchor event (:class:`DeviceClock`) — not the moment a poller saw
``query()`` flip.  The sampler's readiness-edge arithmetic is unchanged:

    device_ms(phase_k) = ready(phase_k) − max(ready(phase_{k−1}),
                                              dispatch(phase_k))

Nothing on the hot path synchronizes.  On the CPU there are no markers and
the rows carry ``clock: "host"``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

from traceml_tpu_torch.utils.error_log import get_error_log

# --- internal phase vocabulary (same names and strings as the JAX package)
INTERNAL_PREFIX = "_traceml_internal:"
STEP_TIME = INTERNAL_PREFIX + "step_time"
DATALOADER_NEXT = INTERNAL_PREFIX + "dataloader_next"
H2D_TIME = INTERNAL_PREFIX + "h2d_time"
FORWARD_TIME = INTERNAL_PREFIX + "forward_time"
BACKWARD_TIME = INTERNAL_PREFIX + "backward_time"
OPTIMIZER_STEP = INTERNAL_PREFIX + "optimizer_step"
COMPUTE_TIME = INTERNAL_PREFIX + "compute_time"  # the wrapped step function
COMPILE_TIME = INTERNAL_PREFIX + "compile_time"
COLLECTIVE_TIME = INTERNAL_PREFIX + "collective_time"
CHECKPOINT_TIME = INTERNAL_PREFIX + "checkpoint_time"

ALL_PHASES = (
    STEP_TIME,
    DATALOADER_NEXT,
    H2D_TIME,
    FORWARD_TIME,
    BACKWARD_TIME,
    OPTIMIZER_STEP,
    COMPUTE_TIME,
    COMPILE_TIME,
    COLLECTIVE_TIME,
    CHECKPOINT_TIME,
)

_QUEUE_MAX = 2048


def _now() -> float:
    return time.perf_counter()


class DeviceClock:
    """Maps CUDA event timestamps onto ``time.perf_counter``.

    One anchor event is recorded on a private stream that has no other
    work, so the GPU stamps it within microseconds of the host call; the
    host time taken right after is its image on the host clock.  A later
    event's host time is then ``host + anchor.elapsed_time(event)``.
    """

    def __init__(self, device: Any) -> None:
        import torch

        self._stream = torch.cuda.Stream(device=device)
        self._anchor = torch.cuda.Event(enable_timing=True)
        self._anchor.record(self._stream)
        self.host_at_anchor = _now()

    def host_time(self, event: Any) -> float:
        return self.host_at_anchor + self._anchor.elapsed_time(event) / 1000.0


_clocks: Dict[Any, DeviceClock] = {}
_clocks_lock = threading.Lock()


def device_clock(device: Any) -> DeviceClock:
    clock = _clocks.get(device)
    if clock is None:
        with _clocks_lock:
            clock = _clocks.get(device)
            if clock is None:
                clock = _clocks[device] = DeviceClock(device)
    return clock


class CudaEventHandle:
    """A recorded CUDA event as a marker handle: ``is_ready`` polls it,
    ``ready_time`` is its GPU timestamp on the host clock."""

    __slots__ = ("event", "clock")

    def __init__(self, event: Any, clock: DeviceClock) -> None:
        self.event = event
        self.clock = clock

    def is_ready(self) -> bool:
        return self.event.query()

    def ready_time(self) -> float:
        return self.clock.host_time(self.event)


class DeviceMarker:
    """A readiness probe over enqueued device work.

    Wraps objects exposing ``is_ready() -> bool`` (CUDA event handles;
    tests use fakes).  ``poll(now)`` is non-blocking and idempotent: once
    every handle reports ready, the handles are dropped and ``ready_at`` is
    stamped — with the handles' own device timestamps when they carry one
    (``ready_time``), else with the observation time.
    """

    __slots__ = (
        "_handles", "dispatched_at", "ready_at", "late_stamp", "submitted",
        "step_end_hint",
    )

    def __init__(self, handles: Sequence[Any], dispatched_at: Optional[float] = None):
        self._handles: Optional[List[Any]] = [
            h for h in handles if hasattr(h, "is_ready")
        ]
        # True for markers expected to resolve ~at step end (the wrapped
        # step function's marker): the resolver may sleep through most of
        # the expected step instead of fine-polling
        self.step_end_hint = False
        self.dispatched_at = _now() if dispatched_at is None else dispatched_at
        self.ready_at: Optional[float] = None
        self.late_stamp = False
        self.submitted = False  # resolver dedupe flag
        if not self._handles:
            # nothing to wait on → ready at dispatch
            self.ready_at = self.dispatched_at
            self._handles = None

    @property
    def resolved(self) -> bool:
        return self.ready_at is not None

    def poll(self, now: Optional[float] = None, late: bool = False) -> bool:
        """Stamping readiness check.  A stamp from device timestamps is
        exact whoever polls; only an observation-time stamp taken by a
        coarse caller (``late=True``) is flagged late."""
        if self.ready_at is not None:
            return True
        handles = self._handles
        if handles is None:
            return True
        stamps: List[float] = []
        try:
            for h in handles:
                if not h.is_ready():
                    return False
            for h in handles:
                ready_time = getattr(h, "ready_time", None)
                if ready_time is not None:
                    stamps.append(ready_time())
        except Exception:
            # a failed query says nothing of the device time: stamp at
            # observation time, fail open, never raise
            stamps = []
        self.ready_at = max(stamps) if stamps else (_now() if now is None else now)
        self.late_stamp = late and not stamps
        self._handles = None
        if self.step_end_hint and not self.late_stamp:
            from traceml_tpu_torch.utils.overhead_governor import get_governor

            get_governor().observe_marker_lifetime(
                self.ready_at - self.dispatched_at
            )
        return True


def cuda_marker(device: Any) -> DeviceMarker:
    """Record an event on ``device``'s current stream and wrap it."""
    import torch

    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return DeviceMarker([CudaEventHandle(event, device_clock(device))])


def _find_cuda_device(outputs: Any, depth: int = 0) -> Any:
    device = getattr(outputs, "device", None)
    if device is not None and getattr(device, "type", None) == "cuda":
        return device
    if depth < 3:
        if isinstance(outputs, dict):
            outputs = list(outputs.values())
        if isinstance(outputs, (list, tuple)):
            for item in outputs:
                found = _find_cuda_device(item, depth + 1)
                if found is not None:
                    return found
    return None


class TimeEvent:
    """One timed phase occurrence inside one step."""

    __slots__ = (
        "name",
        "step",
        "cpu_start",
        "cpu_end",
        "marker",
        "meta",
    )

    def __init__(self, name: str, step: int) -> None:
        self.name = name
        self.step = step
        self.cpu_start: float = _now()
        self.cpu_end: Optional[float] = None
        self.marker: Optional[DeviceMarker] = None
        self.meta: Optional[Dict[str, Any]] = None

    def close(self) -> None:
        if self.cpu_end is None:
            self.cpu_end = _now()

    def attach_marker(self, outputs: Any, device: Any = None) -> None:
        """Attach a device marker after a phase's outputs were enqueued:
        an event on the current stream of the first CUDA tensor found in
        ``outputs`` (a tensor, or a list, tuple or dict of them), else on
        ``device`` when it is a CUDA device — for regions such as
        ``loss.backward()`` and ``optimizer.step()`` that return no tensor."""
        try:
            found = _find_cuda_device(outputs)
            if found is None and getattr(device, "type", None) == "cuda":
                found = device
            if found is not None:
                self.marker = cuda_marker(found)
        except Exception as exc:
            get_error_log().warning("attach_marker failed", exc)

    @property
    def cpu_ms(self) -> Optional[float]:
        if self.cpu_end is None:
            return None
        return (self.cpu_end - self.cpu_start) * 1000.0

    def is_resolved(self) -> bool:
        """Non-stamping check: host side closed and the marker (if any)
        already stamped."""
        if self.cpu_end is None:
            return False
        if self.marker is None:
            return True
        return self.marker.resolved

    def try_resolve(self, late: bool = True) -> bool:
        """Stamping resolution for last-resort paths (shutdown drain,
        resolve timeout)."""
        if self.cpu_end is None:
            return False
        if self.marker is None:
            return True
        return self.marker.poll(late=late)

    @property
    def device_ready_at(self) -> Optional[float]:
        if self.marker is None:
            return None
        return self.marker.ready_at


class StepTimeBatch:
    """All events of one completed step."""

    __slots__ = ("step", "events", "flushed_at")

    def __init__(self, step: int, events: List[TimeEvent]) -> None:
        self.step = step
        self.events = events
        self.flushed_at = _now()

    def resolved(self) -> bool:
        """Non-stamping: safe to call at any cadence."""
        return all(e.is_resolved() for e in self.events)

    def force_resolve(self) -> None:
        """Stamp any still-pending markers (late-quality stamps)."""
        for e in self.events:
            e.try_resolve(late=True)


class StepEventBuffer:
    """Per-step accumulation buffer, flushed into the global queue at
    step exit."""

    def __init__(self) -> None:
        self._events: List[TimeEvent] = []
        self._lock = threading.Lock()

    def add(self, event: TimeEvent) -> None:
        with self._lock:
            self._events.append(event)

    def flush(self, step: int) -> Optional[StepTimeBatch]:
        with self._lock:
            events, self._events = self._events, []
        if not events:
            return None
        return StepTimeBatch(step, events)


class BoundedDropQueue:
    """Thread-safe bounded queue; drops (and counts) on overflow rather
    than blocking user code."""

    def __init__(self, label: str, maxsize: int = _QUEUE_MAX) -> None:
        self._label = label
        # deque append/popleft are GIL-atomic; the len() check races
        # benignly (a concurrent writer can overshoot by #threads items)
        self._q: Deque[Any] = collections.deque()
        self._maxsize = maxsize
        self.dropped = 0
        self._warned = False

    def put(self, item: Any) -> bool:
        if len(self._q) >= self._maxsize:
            self.dropped += 1
            if not self._warned:
                self._warned = True
                get_error_log().warning(
                    f"{self._label} queue full; dropping (sampler stalled?)"
                )
            return False
        self._q.append(item)
        return True

    def drain(self, max_items: Optional[int] = None) -> List[Any]:
        out: List[Any] = []
        q = self._q
        while max_items is None or len(out) < max_items:
            try:
                out.append(q.popleft())
            except IndexError:
                break
        return out

# Global step queue shared by sdk flush and the StepTimeSampler.
GLOBAL_STEP_QUEUE = BoundedDropQueue("step_time")

# Global step-memory queue (rows produced by StepMemoryTracker).
GLOBAL_STEP_MEMORY_QUEUE = BoundedDropQueue("step_memory")


def push_step_memory_row(row: Dict[str, Any]) -> bool:
    return GLOBAL_STEP_MEMORY_QUEUE.put(row)


def drain_step_memory_rows(max_items: int = 10000) -> List[Dict[str, Any]]:
    return GLOBAL_STEP_MEMORY_QUEUE.drain(max_items)


class timed_region:
    """Context manager timing one phase; optional device marker at exit.

    Usage::

        with timed_region(FORWARD_TIME, step=3, sink=buffer.add) as tr:
            out = forward(...)
            tr.mark(out)        # optional: device-side completion probe
            tr.mark(None, st.device)  # the same, for a region with no tensor out
    """

    __slots__ = ("event", "_sink")

    def __init__(
        self,
        name: str,
        step: int,
        sink: Optional[Callable[[TimeEvent], None]] = None,
    ) -> None:
        self.event = TimeEvent(name, step)
        self._sink = sink

    def mark(self, outputs: Any, device: Any = None) -> Any:
        """Mark after ``outputs``; ``device`` is where to mark when they
        hold no CUDA tensor."""
        self.event.attach_marker(outputs, device)
        return outputs

    def __enter__(self) -> "timed_region":
        self.event.cpu_start = _now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            self.event.close()
            if self._sink is not None:
                self._sink(self.event)
        except Exception as err:  # never raise into user code
            get_error_log().warning("timed_region exit failed", err)
        return False
