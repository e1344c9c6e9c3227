"""Per-step device memory tracking.

Counterpart of ``traceml_tpu/utils/step_memory.py``.  The tracker records,
per step and device:

* ``current_bytes``   — bytes allocated at step end
* ``peak_bytes``      — the largest step peak this tracker has recorded
* ``step_peak_bytes`` — the allocator's peak since the step started
  (``CudaMemoryBackend`` resets PyTorch's peak counters at step start,
  so this is the true step peak); backends without a reset give the max
  of the start and end edges, a lower bound
* ``limit_bytes``     — device capacity

Backends are pluggable: ``CudaMemoryBackend`` reads the caching
allocator's counters (``torch.cuda.memory_stats_as_nested_dict()``); on
the CPU ``HostMemoryBackend`` reads the process's resident bytes, the
stand-in for JAX's count of live arrays there; tests inject the scripted
fake.

``device_memory_rows`` forms the system and process samplers' per-device
rows from the same backend.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Protocol

from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.timing import push_step_memory_row


class MemoryBackend(Protocol):
    name: str

    def sample(self) -> List[Dict[str, Any]]: ...


class CudaMemoryBackend:
    """PyTorch's caching-allocator counters for one CUDA device."""

    name = "cuda_memory_stats"

    def __init__(self, device: Any) -> None:
        import torch

        self._torch = torch
        self._device = torch.device(device)
        self._index = self._device.index
        if self._index is None:
            self._index = torch.cuda.current_device()
        self._kind = torch.cuda.get_device_name(self._index)
        # capacity does not change: one query, not one per sample
        self._limit = int(torch.cuda.mem_get_info(self._index)[1])

    def reset_peak(self) -> None:
        self._torch.cuda.reset_peak_memory_stats(self._index)

    def sample(self) -> List[Dict[str, Any]]:
        # the allocator's nested stats as the C++ side returns them:
        # ``memory_stats`` flattens and sorts all of them in Python first
        stats = self._torch.cuda.memory_stats_as_nested_dict(self._index)
        allocated = stats.get("allocated_bytes", {}).get("all", {})
        current = int(allocated.get("current", 0))
        return [
            {
                "device_id": self._index,
                "device_kind": self._kind,
                "current_bytes": current,
                "peak_bytes": int(allocated.get("peak", current)),
                "limit_bytes": self._limit,
            }
        ]


class FakeMemoryBackend:
    """Deterministic scripted backend for tests."""

    name = "fake"

    def __init__(self, script: Optional[List[List[Dict[str, Any]]]] = None):
        self._script = list(script or [])
        self._i = 0
        self.calls = 0

    def sample(self) -> List[Dict[str, Any]]:
        self.calls += 1
        if not self._script:
            return []
        sample = self._script[min(self._i, len(self._script) - 1)]
        self._i += 1
        return [dict(row) for row in sample]


class HostMemoryBackend:
    """The process's resident set (``/proc/self/statm``) as device 0 of
    kind ``cpu``: on the CPU, tensors live in the host's memory.  No peak
    reset: its peak is the largest sample it has taken."""

    name = "host_rss"

    def __init__(self) -> None:
        import os

        self._page = os.sysconf("SC_PAGE_SIZE")
        self._limit = self._page * os.sysconf("SC_PHYS_PAGES")
        self._peak = 0

    def sample(self) -> List[Dict[str, Any]]:
        with open("/proc/self/statm") as f:
            current = int(f.read().split()[1]) * self._page
        self._peak = max(self._peak, current)
        return [{"device_id": 0, "device_kind": "cpu", "current_bytes": current,
                 "peak_bytes": self._peak, "limit_bytes": self._limit}]


def detect_backend(device: Any) -> MemoryBackend:
    """The backend for a resolved ``torch.device``: CUDA counters on a
    CUDA device, the process's resident set on the CPU."""
    if getattr(device, "type", None) == "cuda":
        return CudaMemoryBackend(device)
    return HostMemoryBackend()


class StepMemoryTracker:
    """Records device memory at step edges and emits one row per
    (step, device) into the global step-memory queue."""

    def __init__(
        self,
        backend: MemoryBackend,
        min_sample_interval_s: float = 0.2,
    ) -> None:
        self._backend = backend
        self._resets_peak = hasattr(backend, "reset_peak")
        self._step_start: Dict[int, Dict[str, Any]] = {}
        self._have_edge = False
        self._peak: Dict[int, int] = {}
        # time-based throttle: sub-interval steps share one sample, so
        # memory sampling stays O(1/interval) per second
        self._min_interval = float(min_sample_interval_s)
        self._last_sample_mono = 0.0

    @property
    def backend_name(self) -> str:
        return getattr(self._backend, "name", "unknown")

    @property
    def backend(self) -> MemoryBackend:
        return self._backend

    def peak_bytes(self, device_id: int) -> int:
        """The largest step peak recorded on ``device_id`` (0 for a
        backend without a peak reset, whose own peak is the run's)."""
        return self._peak.get(device_id, 0)

    def reset(self, step: int) -> None:
        """Step-start edge.  A backend with a peak reset resets it here,
        every step; otherwise only the first step samples (in a contiguous
        loop the previous exit sample is this step's entry edge)."""
        try:
            if self._resets_peak:
                self._backend.reset_peak()
            if self._have_edge:
                return
            self._step_start = {row["device_id"]: row for row in self._backend.sample()}
            self._have_edge = True
        except Exception as exc:
            get_error_log().warning("step memory reset failed", exc)
            self._step_start = {}

    def record(self, step: int, *, force: bool = False) -> List[Dict[str, Any]]:
        """Step-end edge; emits rows and returns them.  Skipped (returns
        []) inside the sampling throttle window, unless ``force``."""
        now = time.monotonic()
        if (
            not force
            and self._min_interval > 0
            and now - self._last_sample_mono < self._min_interval
        ):
            return []
        self._last_sample_mono = now
        rows: List[Dict[str, Any]] = []
        try:
            ts = time.time()
            end_rows = self._backend.sample()
            for row in end_rows:
                dev = row["device_id"]
                start = self._step_start.get(dev, {})
                current = int(row.get("current_bytes", 0))
                step_peak = max(current, int(start.get("current_bytes", 0)))
                if self._resets_peak:
                    step_peak = max(step_peak, int(row.get("peak_bytes", 0)))
                    peak = self._peak[dev] = max(self._peak.get(dev, 0), step_peak)
                else:
                    peak = int(row.get("peak_bytes", 0))
                out = {
                    "step": step,
                    "timestamp": ts,
                    "device_id": dev,
                    "device_kind": row.get("device_kind", "unknown"),
                    "current_bytes": current,
                    "peak_bytes": peak,
                    "step_peak_bytes": step_peak,
                    "limit_bytes": row.get("limit_bytes"),
                    "backend": self.backend_name,
                }
                rows.append(out)
                push_step_memory_row(out)
            # this exit sample becomes the next step's entry edge
            self._step_start = {r["device_id"]: r for r in end_rows}
            self._have_edge = True
        except Exception as exc:
            get_error_log().warning("step memory record failed", exc)
        return rows


def _sampler_backend() -> Optional[MemoryBackend]:
    """The samplers' backend once CUDA is initialized: the SDK tracker's
    (the trace's device) or else the CUDA backend of the first device on
    which this process's allocator holds memory.  ``None`` until then:
    the allocator counters read here need no CUDA context, so the sampler
    thread never creates one."""
    from traceml_tpu_torch.runtime.identity import cuda_is_initialized

    if not cuda_is_initialized():
        return None
    from traceml_tpu_torch.sdk.state import get_state

    tracker = get_state().mem_tracker
    if tracker is not None and isinstance(tracker.backend, CudaMemoryBackend):
        return tracker.backend
    import torch

    used = [i for i in range(torch.cuda.device_count()) if torch.cuda.memory_reserved(i) > 0]
    return CudaMemoryBackend(torch.device("cuda", used[0])) if used else None


def device_memory_rows(backend_holder: Dict[str, Any], ts: float) -> List[Dict[str, Any]]:
    """Per-device rows of the system and process samplers.

    ``backend_holder`` is a dict owned by the sampler: ``{"backend":
    MemoryBackend | None}``, filled by ``_sampler_backend`` when empty;
    the rows are empty until there is a backend.  A ``"tracker"`` entry
    (a ``StepMemoryTracker``) stands in for the SDK's.

    ``memory_peak_bytes`` is the run's peak so far.  A backend that
    resets its peak at every step start (``CudaMemoryBackend``) reports
    the current step's peak only, so the row takes the largest of that,
    the peaks this holder has seen and the tracker's recorded step peaks:
    never below a step-memory row's peak.  Other backends' peaks pass
    through, as in the JAX package.
    """
    backend = backend_holder.get("backend")
    if backend is None:
        backend = backend_holder["backend"] = _sampler_backend()
        if backend is None:
            return []
    resets = hasattr(backend, "reset_peak")
    tracker = backend_holder.get("tracker")
    if tracker is None and resets:
        from traceml_tpu_torch.sdk.state import get_state

        tracker = get_state().mem_tracker
    peaks = backend_holder.setdefault("peaks", {})
    rows = []
    for r in backend.sample():
        dev = r["device_id"]
        peak = r.get("peak_bytes")
        if resets:
            peak = peaks[dev] = max(
                peaks.get(dev, 0), int(peak or 0), tracker.peak_bytes(dev) if tracker else 0
            )
        rows.append({
            "timestamp": ts,
            "device_id": dev,
            "device_kind": r.get("device_kind", "unknown"),
            "memory_used_bytes": r.get("current_bytes"),
            "memory_peak_bytes": peak,
            "memory_total_bytes": r.get("limit_bytes"),
        })
    return rows
