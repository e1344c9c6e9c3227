"""The port's SQLite writer against the JAX package's.

The same step-time and step-memory rows (made from a numpy seed, two
ranks, several envelopes, in both table encodings: the rank sender's
columnar schema 2 and row-list schema 1) go through the JAX and the port
``SQLiteWriter``; the two databases come out with the same columns and
the same rows, row for row, ids included.  The row generators are shared
with ``test_torch_final_report.py``.
"""

import sqlite3

import numpy as np
import pytest

from traceml_tpu.aggregator.sqlite_writer import SQLiteWriter as JaxWriter
from traceml_tpu.telemetry.envelope import normalize_telemetry_envelope as jax_normalize
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.telemetry.envelope import (
    SenderIdentity,
    normalize_telemetry_envelope,
    rows_to_columns,
)
from traceml_tpu_torch.utils import timing as T

GiB = 1 << 30


def step_rows(seed, n_steps, input_ms, compute_ms, clock="device"):
    """Step-time rows as the sampler forms them: per step, the envelope
    (``step_time``) and the input, h2d and compute phases, with host and
    device durations around the given means."""
    rng = np.random.default_rng(seed)
    rows = []
    for step in range(1, n_steps + 1):
        inp = float(input_ms * rng.uniform(0.9, 1.1))
        h2d = float(rng.uniform(0.05, 0.2))
        comp = float(compute_ms * rng.uniform(0.95, 1.05))
        dev = clock == "device"
        events = {
            T.DATALOADER_NEXT: {"cpu_ms": inp, "device_ms": None, "count": 1},
            T.H2D_TIME: {"cpu_ms": h2d * 0.5, "device_ms": h2d if dev else None, "count": 1},
            T.COMPUTE_TIME: {"cpu_ms": comp * 0.3, "device_ms": comp if dev else None, "count": 1},
            T.STEP_TIME: {
                "cpu_ms": inp + h2d + comp + float(rng.uniform(0.1, 0.3)),
                "device_ms": (h2d + comp) if dev else None,
                "count": 1,
            },
        }
        row = {"step": step, "timestamp": 1.7e9 + step * 0.05, "clock": clock, "events": events}
        if step % 17 == 0:
            row["late_markers"] = 1
        rows.append(row)
    return rows


def memory_rows(seed, n_steps, used_frac, limit=80 * GiB, every=5):
    """Step-memory rows every ``every`` steps, at about ``used_frac`` of
    the limit."""
    rng = np.random.default_rng(seed)
    rows = []
    for step in range(every, n_steps + 1, every):
        cur = int(limit * used_frac * rng.uniform(0.97, 0.99))
        rows.append({
            "step": step, "timestamp": 1.7e9 + step * 0.05, "device_id": 0,
            "device_kind": "NVIDIA H100 80GB HBM3", "current_bytes": cur,
            "peak_bytes": int(cur * 1.01), "step_peak_bytes": int(limit * used_frac),
            "limit_bytes": limit, "backend": "cuda_memory_stats",
        })
    return rows


def wire_payloads(rank_step_rows, rank_memory_rows, columnar=True, chunk=16):
    """Decoded wire payloads carrying the rows, ``chunk`` rows per
    envelope, in the rank sender's shape (``seq`` monotonic per rank)."""
    out = []
    seq = {}
    for sampler, table, per_rank in (
        ("step_time", "step_time", rank_step_rows),
        ("step_memory", "step_memory", rank_memory_rows),
    ):
        for rank, rows in per_rank.items():
            ident = SenderIdentity(session_id="s", global_rank=rank, local_rank=rank,
                                   world_size=len(per_rank), local_world_size=len(per_rank),
                                   hostname=f"host-{rank}", pid=100 + rank)
            for i in range(0, len(rows), chunk):
                meta = ident.to_meta()
                seq[rank] = seq.get(rank, 0) + 1
                meta.update({"schema": 2 if columnar else 1, "sampler": sampler,
                             "timestamp": 1.7e9, "seq": seq[rank]})
                part = rows[i:i + chunk]
                out.append({"meta": meta, "body": {"tables": {
                    table: rows_to_columns(part) if columnar else part}}})
    return out


def write(writer, normalize, payloads):
    writer.start()
    for p in payloads:
        assert writer.ingest(normalize(p))
    assert writer.finalize(timeout=30)


def dump(db, table):
    conn = sqlite3.connect(db)
    try:
        cols = [r[1] for r in conn.execute(f"PRAGMA table_info({table})")]
        rows = conn.execute(f"SELECT * FROM {table} ORDER BY id").fetchall()
    finally:
        conn.close()
    return cols, rows


@pytest.mark.parametrize("columnar", [True, False], ids=["schema2", "schema1"])
def test_same_rows_give_the_same_tables(tmp_path, columnar):
    payloads = wire_payloads(
        {0: step_rows(0, 70, 2.0, 18.0), 1: step_rows(1, 70, 2.5, 18.5)},
        {0: memory_rows(2, 70, 0.5), 1: memory_rows(3, 70, 0.6)},
        columnar=columnar,
    )
    write(JaxWriter(tmp_path / "jax.sqlite"), jax_normalize, payloads)
    port = SQLiteWriter(tmp_path / "port.sqlite")
    write(port, normalize_telemetry_envelope, payloads)
    assert (port.written, port.dropped) == (140 + 28, 0)
    for table, n in (("step_time_samples", 140), ("step_memory_samples", 28)):
        cols_j, rows_j = dump(tmp_path / "jax.sqlite", table)
        cols_p, rows_p = dump(tmp_path / "port.sqlite", table)
        assert cols_p == cols_j
        assert len(rows_p) == n
        assert rows_p == rows_j


def test_unknown_domain_is_counted_not_written(tmp_path):
    payload = wire_payloads({0: step_rows(0, 3, 1.0, 1.0)}, {})[0]
    payload["meta"]["sampler"] = "system"
    writer = SQLiteWriter(tmp_path / "port.sqlite")
    write(writer, normalize_telemetry_envelope, [payload])
    stats = writer.stats()
    assert stats["unknown_domain_drops"] == {"system": 1}
    assert stats["written"] == 0 and stats["enqueued"] == 1
