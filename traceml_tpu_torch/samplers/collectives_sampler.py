"""Collectives sampler: per-step collective-communication telemetry.

Counterpart of ``traceml_tpu/samplers/collectives_sampler.py`` (copied).
Drains the global collectives queue (fed by the recorders of
``instrumentation/collectives.py``) plus any registered profiler trace
source, and folds the per-call records into one row per
``(step, op, dtype)``::

    {step, timestamp, op, dtype, count, bytes, group_size,
     duration_ms, exposed_ms}

``exposed_ms`` is the part of the comm time NOT hidden behind compute;
downstream (``utils/columnar.py``) derives per-step overlap efficiency
``1 − exposed/total`` from these sums.  Folding here bounds the rows at
(ops × dtypes) per step, whatever the number of calls.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

from traceml_tpu_torch.instrumentation.collectives import (
    GLOBAL_COLLECTIVES_QUEUE,
    drain_trace_sources,
    extract_collectives_from_trace_events,
)
from traceml_tpu_torch.samplers.base_sampler import BaseSampler

TABLE = "collectives"


def aggregate_collective_records(
    records: List[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Fold raw per-call records into per-(step, op, dtype) rows.

    Deterministic output order (step, op, dtype) so the producer-side
    columnar accumulator sees stable shapes and goldens are exact.
    """
    slots: Dict[Tuple[int, str, str], Dict[str, Any]] = {}
    for rec in records:
        try:
            key = (int(rec["step"]), str(rec["op"]), str(rec.get("dtype", "")))
        except (KeyError, TypeError, ValueError):
            continue
        slot = slots.get(key)
        if slot is None:
            slot = slots[key] = {
                "step": key[0],
                "op": key[1],
                "dtype": key[2],
                "count": 0,
                "bytes": 0,
                "group_size": 1,
                "duration_ms": 0.0,
                "exposed_ms": 0.0,
            }
        slot["count"] += 1
        slot["bytes"] += int(rec.get("bytes", 0) or 0)
        slot["group_size"] = max(
            slot["group_size"], int(rec.get("group_size", 1) or 1)
        )
        slot["duration_ms"] += float(rec.get("duration_ms", 0.0) or 0.0)
        slot["exposed_ms"] += float(rec.get("exposed_ms", 0.0) or 0.0)
    return [slots[k] for k in sorted(slots)]


class CollectivesSampler(BaseSampler):
    name = "collectives"

    def __init__(self, *args: Any, **kw: Any):
        super().__init__(*args, **kw)
        self.rows_emitted = 0

    def _collect(self) -> List[Dict[str, Any]]:
        records = GLOBAL_COLLECTIVES_QUEUE.drain()
        trace_events = drain_trace_sources()
        if trace_events:
            records.extend(extract_collectives_from_trace_events(trace_events))
        return records

    def _sample(self) -> None:
        records = self._collect()
        if not records:
            return
        now = time.time()
        for row in aggregate_collective_records(records):
            row["timestamp"] = now
            self.db.add_record(TABLE, row)
            self.rows_emitted += 1

    def drain(self) -> None:
        """End-of-run: flush whatever is still queued."""
        self._sample()
