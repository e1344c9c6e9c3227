"""Step-memory rows: the port's tracker against the JAX package's.

With a scripted backend both trackers must emit the same rows (the row
keys of ``StepMemoryTracker.record``).  With a backend that resets its
peak at step start — what ``CudaMemoryBackend`` does — ``step_peak_bytes``
is the allocator's step peak and ``peak_bytes`` the largest one seen.
"""

from traceml_tpu.utils.step_memory import FakeMemoryBackend as JaxFake
from traceml_tpu.utils.step_memory import StepMemoryTracker as JaxTracker
from traceml_tpu_torch.utils.step_memory import FakeMemoryBackend, NullMemoryBackend, StepMemoryTracker
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
    assert _run(StepMemoryTracker(NullMemoryBackend(), min_sample_interval_s=0)) == []
