"""Per-sampler SQLite projection writers.

Counterpart of ``traceml_tpu/aggregator/sqlite_writers/`` for the seven
tables the port ships (the serving writer comes with its domain).  Uniform contract per module:
``accepts_sampler(name)``, ``init_schema(conn)``, ``build_rows(envelope)``
→ {table: [tuple, ...]}, ``insert_sql(table)``.
"""

from traceml_tpu_torch.aggregator.sqlite_writers import (
    collectives_writer,
    mesh_topology_writer,
    process_writer,
    step_memory_writer,
    step_time_writer,
    stdout_writer,
    system_writer,
)

ALL_WRITERS = [
    system_writer,
    process_writer,
    step_time_writer,
    step_memory_writer,
    collectives_writer,
    stdout_writer,
    mesh_topology_writer,
]


def writer_for(sampler: str):
    for w in ALL_WRITERS:
        if w.accepts_sampler(sampler):
            return w
    return None
