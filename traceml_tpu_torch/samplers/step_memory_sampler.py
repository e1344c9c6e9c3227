"""Step-memory sampler.

Counterpart of ``traceml_tpu/samplers/step_memory_sampler.py``: drains the
step-memory queue verbatim — StepMemoryTracker formed the rows at the step
edges.
"""

from __future__ import annotations

from traceml_tpu_torch.samplers.base_sampler import BaseSampler
from traceml_tpu_torch.utils.timing import drain_step_memory_rows

TABLE = "step_memory"


class StepMemorySampler(BaseSampler):
    name = "step_memory"

    def _sample(self) -> None:
        rows = drain_step_memory_rows()
        if rows:
            self.db.add_records(TABLE, rows)
