"""The port's SQLite writer against the JAX package's.

The same step-time (one rank's with a forward/backward/optimizer split),
model_stats, step-memory, system (host and GPU, NVML columns filled) and
process rows (made from a numpy seed, two ranks, several envelopes, in
both table encodings: the rank sender's columnar schema 2 and row-list
schema 1) go through the JAX and the port ``SQLiteWriter``; the two
databases come out with the same columns and the same rows, row for row,
ids included.  The row generators are shared with
``test_torch_final_report.py``.
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


# a train step's compute split as the auto-patches time it
TRAIN_SPLIT = ((T.FORWARD_TIME, 0.2), (T.BACKWARD_TIME, 0.76), (T.OPTIMIZER_STEP, 0.04))


def step_rows(seed, n_steps, input_ms, compute_ms, clock="device", train=False):
    """Step-time rows as the sampler forms them: per step, the envelope
    (``step_time``) and the input, h2d and compute phases, with host and
    device durations around the given means; with ``train`` the compute
    is split into forward, backward and optimizer phases."""
    rng = np.random.default_rng(seed)
    rows = []
    for step in range(1, n_steps + 1):
        inp = float(input_ms * rng.uniform(0.9, 1.1))
        h2d = float(rng.uniform(0.05, 0.2))
        comp = float(compute_ms * rng.uniform(0.95, 1.05))
        dev = clock == "device"
        phases = TRAIN_SPLIT if train else ((T.COMPUTE_TIME, 1.0),)
        events = {
            T.DATALOADER_NEXT: {"cpu_ms": inp, "device_ms": None, "count": 1},
            T.H2D_TIME: {"cpu_ms": h2d * 0.5, "device_ms": h2d if dev else None, "count": 1},
            **{name: {"cpu_ms": comp * share * 0.3, "device_ms": comp * share if dev else None,
                      "count": 1} for name, share in phases},
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


def model_stats_rows(flops, device_kind="NVIDIA H100 80GB HBM3", peak=989e12, tokens=None, n=1):
    """``n`` model_stats rows as the step-time sampler publishes them."""
    return [{"timestamp": 1.7e9 + i, "flops_per_step": flops, "flops_source": "flop_counter",
             "device_kind": device_kind, "peak_flops": peak, "device_count": 1,
             "tokens_per_step": tokens} for i in range(n)]


def system_rows(seed, n, cpu_pct=35.0, util_pct=92.0, device_used_frac=0.3, limit=80 * GiB):
    """The system sampler's ``system`` and ``system_device`` rows, one of
    each per tick, NVML columns filled."""
    rng = np.random.default_rng(seed)
    host, dev = [], []
    for i in range(n):
        ts = 1.7e9 + i * 0.1
        used = int(limit * device_used_frac * rng.uniform(0.98, 1.0))
        host.append({"timestamp": ts, "cpu_pct": float(cpu_pct * rng.uniform(0.9, 1.1)),
                     "memory_used_bytes": int(200 * GiB * rng.uniform(0.95, 1.05)),
                     "memory_total_bytes": 1024 * GiB, "memory_pct": 19.5,
                     "load_1m": 3.5, "load_5m": 2.5, "load_15m": 1.5})
        dev.append({"timestamp": ts, "device_id": 0, "device_kind": "NVIDIA H100 80GB HBM3",
                    "memory_used_bytes": used, "memory_peak_bytes": int(limit * device_used_frac),
                    "memory_total_bytes": limit,
                    "utilization_pct": float(min(100.0, util_pct * rng.uniform(0.95, 1.05))),
                    "temperature_c": float(rng.uniform(55.0, 60.0)),
                    "power_w": float(rng.uniform(400.0, 450.0))})
    return {"system": host, "system_device": dev}


def process_rows(seed, n, rss=6 * GiB, cpu_pct=105.0, device_used_frac=0.3, limit=80 * GiB):
    """The process sampler's ``process`` and ``process_device`` rows."""
    rng = np.random.default_rng(seed)
    proc, dev = [], []
    for i in range(n):
        ts = 1.7e9 + i * 0.1
        used = int(limit * device_used_frac * rng.uniform(0.98, 1.0))
        proc.append({"timestamp": ts, "pid": 4242, "cpu_pct": float(cpu_pct * rng.uniform(0.9, 1.1)),
                     "rss_bytes": int(rss * rng.uniform(0.99, 1.01)), "vms_bytes": 3 * rss,
                     "num_threads": 20 + i % 3})
        dev.append({"timestamp": ts, "device_id": 0, "device_kind": "NVIDIA H100 80GB HBM3",
                    "memory_used_bytes": used, "memory_peak_bytes": int(limit * device_used_frac),
                    "memory_total_bytes": limit})
    return {"process": proc, "process_device": dev}


def wire_payloads(rank_step_rows, rank_memory_rows, columnar=True, chunk=16, rank_model_stats=None,
                  rank_system=None, rank_process=None):
    """Decoded wire payloads carrying the rows, ``chunk`` rows per
    envelope, in the rank sender's shape (``seq`` monotonic per rank);
    ``model_stats`` rows travel in step_time envelopes, ``system_device``
    rows in system envelopes and ``process_device`` rows in process ones
    (``rank_system`` and ``rank_process`` map a rank to its sampler's
    tables, as ``system_rows`` and ``process_rows`` give them)."""
    out = []
    seq = {}
    for sampler, table, per_rank in (
        ("step_time", "step_time", rank_step_rows),
        ("step_memory", "step_memory", rank_memory_rows),
        ("step_time", "model_stats", rank_model_stats or {}),
        *((sampler, table, {r: t[table] for r, t in (per_rank or {}).items()})
          for sampler, per_rank, tables in (("system", rank_system, ("system", "system_device")),
                                            ("process", rank_process, ("process", "process_device")))
          for table in tables),
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


def indexes(db, tables):
    """The index names and definitions of ``tables``, but for the JAX
    writer's ``*_retention`` indexes: its retention pruning, which the
    port has not ported yet, makes them."""
    conn = sqlite3.connect(db)
    try:
        return sorted(r for r in conn.execute(
            "SELECT tbl_name, name, sql FROM sqlite_master WHERE type = 'index' AND sql IS NOT NULL"
        ) if r[0] in tables and not r[1].endswith("_retention"))
    finally:
        conn.close()


@pytest.mark.parametrize("columnar", [True, False], ids=["schema2", "schema1"])
def test_same_rows_give_the_same_tables(tmp_path, columnar):
    payloads = wire_payloads(
        {0: step_rows(0, 70, 2.0, 18.0), 1: step_rows(1, 70, 2.5, 18.5, train=True)},
        {0: memory_rows(2, 70, 0.5), 1: memory_rows(3, 70, 0.6)},
        columnar=columnar,
        rank_model_stats={0: model_stats_rows(9.0e12, n=2), 1: model_stats_rows(8.0e12, tokens=8192.0)},
        rank_system={0: system_rows(4, 37)},
        rank_process={0: process_rows(5, 37), 1: process_rows(6, 35, rss=9 * GiB)},
    )
    write(JaxWriter(tmp_path / "jax.sqlite"), jax_normalize, payloads)
    port = SQLiteWriter(tmp_path / "port.sqlite")
    write(port, normalize_telemetry_envelope, payloads)
    tables = (("step_time_samples", 140), ("step_memory_samples", 28), ("model_stats_samples", 3),
              ("system_samples", 37), ("system_device_samples", 37), ("process_samples", 72),
              ("process_device_samples", 72))
    assert (port.written, port.dropped) == (sum(n for _, n in tables), 0)
    for table, n in tables:
        cols_j, rows_j = dump(tmp_path / "jax.sqlite", table)
        cols_p, rows_p = dump(tmp_path / "port.sqlite", table)
        assert cols_p == cols_j
        assert len(rows_p) == n
        assert rows_p == rows_j
    names = {t for t, _ in tables}
    assert indexes(tmp_path / "port.sqlite", names) == indexes(tmp_path / "jax.sqlite", names)


def test_unknown_domain_is_counted_not_written(tmp_path):
    payload = wire_payloads({0: step_rows(0, 3, 1.0, 1.0)}, {})[0]
    payload["meta"]["sampler"] = "collectives"
    writer = SQLiteWriter(tmp_path / "port.sqlite")
    write(writer, normalize_telemetry_envelope, [payload])
    stats = writer.stats()
    assert stats["unknown_domain_drops"] == {"collectives": 1}
    assert stats["written"] == 0 and stats["enqueued"] == 1
