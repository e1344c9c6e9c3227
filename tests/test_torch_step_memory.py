"""Step-memory rows: the port's tracker against the JAX package's.

With a scripted backend both trackers must emit the same rows (the row
keys of ``StepMemoryTracker.record``).  With a backend that resets its
peak at step start — what ``CudaMemoryBackend`` does — ``step_peak_bytes``
is the allocator's step peak and ``peak_bytes`` the largest one seen.
"""

import pytest

from traceml_tpu.utils.step_memory import FakeMemoryBackend as JaxFake
from traceml_tpu.utils.step_memory import StepMemoryTracker as JaxTracker
from traceml_tpu_torch.utils.step_memory import FakeMemoryBackend, StepMemoryTracker, detect_backend
from traceml_tpu_torch.utils.timing import drain_step_memory_rows


def _sample(current, peak, device=0):
    return [{"device_id": device, "device_kind": "fake", "current_bytes": current,
             "peak_bytes": peak, "limit_bytes": 1000}]


SCRIPT = [_sample(100, 150), _sample(120, 300), _sample(90, 300), _sample(200, 400)]


def _run(tracker, steps=3):
    rows = []
    for step in range(1, steps + 1):
        tracker.reset(step)
        rows += tracker.record(step)
    return [{k: v for k, v in r.items() if k != "timestamp"} for r in rows]


def test_rows_equal_jax_with_a_scripted_backend():
    ours = _run(StepMemoryTracker(FakeMemoryBackend(SCRIPT), min_sample_interval_s=0))
    theirs = _run(JaxTracker(JaxFake(SCRIPT), min_sample_interval_s=0))
    drain_step_memory_rows()
    assert ours == theirs
    assert [r["step_peak_bytes"] for r in ours] == [120, 120, 200]


class _ResettingBackend(FakeMemoryBackend):
    """Peaks are per step, as after torch.cuda.reset_peak_memory_stats."""

    name = "resetting_fake"

    def __init__(self, script):
        super().__init__(script)
        self.resets = 0

    def reset_peak(self):
        self.resets += 1


def test_peak_reset_backend_gives_true_step_peaks():
    script = [_sample(100, 100), _sample(120, 500), _sample(90, 260), _sample(95, 700)]
    backend = _ResettingBackend(script)
    rows = _run(StepMemoryTracker(backend, min_sample_interval_s=0))
    drain_step_memory_rows()
    assert backend.resets == 3  # every step start, not only the first
    assert [r["step_peak_bytes"] for r in rows] == [500, 260, 700]
    assert [r["peak_bytes"] for r in rows] == [500, 500, 700]
    assert {r["backend"] for r in rows} == {"resetting_fake"}


def test_null_backend_records_nothing():
    """A backend that sees no device emits no rows."""
    assert _run(StepMemoryTracker(FakeMemoryBackend(), min_sample_interval_s=0)) == []


def test_cpu_backend_is_the_resident_set():
    """On the CPU the tracker records the process's resident bytes, one
    ``cpu`` row a step: an allocation kept across steps shows as growth."""
    torch = pytest.importorskip("torch")
    tracker = StepMemoryTracker(detect_backend(torch.device("cpu")), min_sample_interval_s=0)
    assert tracker.backend_name == "host_rss"
    tracker.reset(1)
    first = tracker.record(1)
    kept = torch.ones(32 << 20, dtype=torch.uint8)  # 32 MiB, touched
    tracker.reset(2)
    second = tracker.record(2)
    drain_step_memory_rows()
    assert [r["device_kind"] for r in first + second] == ["cpu", "cpu"]
    assert second[0]["current_bytes"] - first[0]["current_bytes"] >= 30 << 20
    assert second[0]["peak_bytes"] >= second[0]["current_bytes"] > 0
    assert second[0]["limit_bytes"] >= second[0]["peak_bytes"]
    del kept
