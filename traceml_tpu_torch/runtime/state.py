"""Recording lifecycle.

Counterpart of ``traceml_tpu/runtime/state.py`` (copied).
``--trace-max-steps N`` stops *recording* after N steps while the
script keeps training: RECORDING → DRAINING (the drain-on-stop samplers
flush what is buffered) → COMPLETE (the runtime sends ``rank_finished``
and goes quiet).
"""

from __future__ import annotations

import threading
from typing import Optional

RECORDING = "RECORDING"
DRAINING = "DRAINING"
COMPLETE = "COMPLETE"


class RecordingState:
    def __init__(self, max_steps: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._max_steps = max_steps
        self._phase = RECORDING
        self._flushed_steps = 0

    @property
    def phase(self) -> str:
        with self._lock:
            return self._phase

    @property
    def recording(self) -> bool:
        return self.phase == RECORDING

    def on_step_flushed(self, step: int) -> None:
        with self._lock:
            self._flushed_steps = max(self._flushed_steps, step)
            if (
                self._phase == RECORDING
                and self._max_steps is not None
                and self._flushed_steps >= self._max_steps
            ):
                self._phase = DRAINING

    def mark_drained(self) -> None:
        with self._lock:
            if self._phase == DRAINING:
                self._phase = COMPLETE
