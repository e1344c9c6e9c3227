"""Per-sampler SQLite projection writers.

Counterpart of ``traceml_tpu/aggregator/sqlite_writers/`` for the four
domains the port ships.  Uniform contract per module:
``accepts_sampler(name)``, ``init_schema(conn)``, ``build_rows(envelope)``
→ {table: [tuple, ...]}, ``insert_sql(table)``.
"""

from traceml_tpu_torch.aggregator.sqlite_writers import (
    process_writer,
    step_memory_writer,
    step_time_writer,
    system_writer,
)

ALL_WRITERS = [system_writer, process_writer, step_time_writer, step_memory_writer]


def writer_for(sampler: str):
    for w in ALL_WRITERS:
        if w.accepts_sampler(sampler):
            return w
    return None
