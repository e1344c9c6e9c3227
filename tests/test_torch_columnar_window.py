"""The port's columnar window engine against its scalar arm, bit for bit.

Ported from ``tests/utils/test_columnar_window.py``.  The contract: for
any input the scalar builder (``utils/step_time_window.py``) accepts, the
columnar engine either gives a window equal to it at tolerance 0
(``window_to_plain`` on both sides: steps, series, averages, medians,
metrics, occupancy) or raises ``ColumnarFallback`` so the caller reruns
the scalar reference.  The edge cases are those that bend the alignment
math: ragged suffixes, a single rank, a phase missing on one rank only,
a host/device clock flip mid-window, ring eviction against
``deque(maxlen)``, and the store's trims through the writer's watermark
journal (a prefix eviction) and through a watermark filter (rows dropped
out of the middle).  Memory: rows against columns through the
diagnosis and the view.

The averages are ``sum(vs) / len(vs)`` in the scalar arm, and CPython
3.12's ``sum()`` is compensated (Neumaier).  ``sum_fold`` must equal
``sum()`` bit for bit (a hypothesis property over large cancellations,
``inf``, ``nan`` and ``-0.0``), ``plain_fold`` the scalar ``+=`` loop.
The JAX engine folds with ``np.cumsum``: on 3.12 its window differs from
the JAX scalar arm on a seeded ragged input where the port's does not
(``test_jax_engine_fold_differs_from_its_scalar_arm``).  The port's
scalar arm equals the JAX scalar arm at tolerance 0.
"""

import math
import sys
from collections import deque

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from traceml_tpu.utils.columnar import StepTimeColumns as JaxColumns
from traceml_tpu.utils.columnar import build_columnar_step_time_window as jax_columnar_build
from traceml_tpu.utils.columnar import window_to_plain as jax_window_to_plain
from traceml_tpu.utils.step_time_window import build_step_time_window as jax_scalar_build
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.diagnostics.step_memory.api import diagnose_columns, diagnose_rank_rows
from traceml_tpu_torch.renderers import views as V
from traceml_tpu_torch.reporting.snapshot_store import LiveSnapshotStore, _StepTimeBuffer
from traceml_tpu_torch.telemetry.envelope import SenderIdentity, normalize_telemetry_envelope, rows_to_columns
from traceml_tpu_torch.utils import timing as T
from traceml_tpu_torch.utils.columnar import (
    ColumnarFallback,
    MemoryColumns,
    StepTimeColumns,
    build_columnar_step_time_window,
    columnar_window_enabled,
    plain_fold,
    sum_fold,
    window_to_plain,
)
from traceml_tpu_torch.utils.step_time_window import PHASES, build_step_time_metrics, build_step_time_window

G = 1_000_000_000


# -- row factories (shared with the incremental and tick-profile tests) --


def step_row(step, rng, clock="device", missing=(), drop_p=0.0):
    """One step-time row as the sampler forms it: the envelope and every
    phase (input host-only), durations from ``rng``; phases in
    ``missing``, and each other with probability ``drop_p``, left out."""
    step_ms = float(rng.uniform(40.0, 150.0))
    events = {T.STEP_TIME: {"cpu_ms": step_ms, "device_ms": step_ms * 0.97 if clock == "device" else None,
                            "count": 1}}
    for key, name in PHASES.items():
        if key in missing or (drop_p and rng.random() < drop_p):
            continue
        v = float(rng.uniform(0.0, 25.0))
        events[name] = {"cpu_ms": v, "device_ms": v * 0.95 if key != "input" else None, "count": 1}
    return {"step": step, "timestamp": 100.0 + step, "clock": clock, "late_markers": 0, "events": events}


def mem_row(step, sp, cur, lim=16 * G, dev=0):
    return {"step": step, "timestamp": 10.0 + step, "device_id": dev, "device_kind": "NVIDIA H100 80GB HBM3",
            "current_bytes": cur, "peak_bytes": sp + 128, "step_peak_bytes": sp, "limit_bytes": lim}


def cols_for(rank_rows, cap=256, ring=StepTimeColumns):
    out = {}
    for rank, rows in rank_rows.items():
        c = out[rank] = ring(cap)
        for row in rows:
            c.append(row)
    return out


def mem_cols_for(rank_rows, cap=256):
    return cols_for(rank_rows, cap, ring=MemoryColumns)


class Feeder:
    """Writes rows through the port's ``SQLiteWriter`` as a rank's sender
    ships them (columnar envelopes, ``seq`` monotonic per rank)."""

    def __init__(self, writer, world=2):
        self.writer, self.world, self.seq = writer, world, {}

    def send(self, rank, table, rows, sampler=None):
        ident = SenderIdentity(session_id="s", global_rank=rank, local_rank=rank, world_size=self.world,
                               local_world_size=self.world, hostname="host-0", pid=100 + rank)
        meta = ident.to_meta()
        self.seq[rank] = self.seq.get(rank, 0) + 1
        meta.update({"schema": 2, "sampler": sampler or table, "timestamp": 1.7e9, "seq": self.seq[rank]})
        env = normalize_telemetry_envelope({"meta": meta, "body": {"tables": {table: rows_to_columns(rows)}}})
        assert self.writer.ingest(env)


def assert_golden(rank_rows, max_steps, cap=256):
    scalar = build_step_time_window(rank_rows, max_steps=max_steps)
    columnar = build_columnar_step_time_window(cols_for(rank_rows, cap), max_steps)
    assert window_to_plain(columnar) == window_to_plain(scalar)
    return columnar


# -- the folds -------------------------------------------------------------


def same_bits(a, b):
    return (math.isnan(a) and math.isnan(b)) or (a == b and math.copysign(1.0, a) == math.copysign(1.0, b))


SPECIAL = st.sampled_from([0.0, -0.0, 1.0, -1.0, 0.1, 3.0, 1e16, -1e16, 1e-16, 2.0 ** 53, 1e300, -1e300,
                           1.7976931348623157e308, math.inf, -math.inf, math.nan, 5e-324])
FLOATS = st.one_of(st.floats(allow_nan=True, allow_infinity=True), SPECIAL)


@settings(max_examples=400, deadline=None)
@given(st.lists(FLOATS, min_size=1, max_size=40))
def test_sum_fold_is_the_interpreters_sum(xs):
    got = float(sum_fold(np.asarray(xs, dtype=np.float64)[:, None])[0])
    assert same_bits(got, sum(xs)), (xs, got, sum(xs))
    acc = 0.0
    for x in xs:
        acc += x
    assert same_bits(float(plain_fold(np.asarray(xs, dtype=np.float64)[:, None])[0]), acc)


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 30).flatmap(lambda n: st.lists(st.lists(FLOATS, min_size=n, max_size=n),
                                                      min_size=1, max_size=6)),
       st.integers(0, 5))
def test_sum_fold_lanes_and_ranges(lanes, lo):
    """Each lane of a step-major block, over any ``[lo, hi)``, is the
    ``sum()`` of that lane's slice."""
    arr = np.asarray(lanes, dtype=np.float64).T  # (steps, lanes)
    lo = min(lo, arr.shape[0] - 1)
    got = sum_fold(arr, lo, arr.shape[0])
    for i, lane in enumerate(lanes):
        assert same_bits(float(got[i]), sum(lane[lo:]))


def test_the_compensated_sum_is_pinned_on_this_interpreter():
    xs = [1e16, 1.0, -1e16, 1.0]
    folded = float(sum_fold(np.asarray(xs)[:, None])[0])
    assert folded == sum(xs)
    assert folded == (2.0 if sys.version_info >= (3, 12) else 1.0)


# -- golden edge cases -----------------------------------------------------


def test_ragged_suffixes_identical():
    rng = np.random.default_rng(11)
    rank_rows = {r: [step_row(s, rng) for s in range(int(rng.integers(0, 8)), 48)] for r in range(8)}
    w = assert_golden(rank_rows, max_steps=30)
    assert w is not None and w.n_steps == 30 and w.clock == "device"


def test_single_rank_world():
    rng = np.random.default_rng(12)
    w = assert_golden({0: [step_row(s, rng) for s in range(25)]}, max_steps=10)
    assert w.ranks == [0] and w.n_steps == 10


def test_phase_missing_on_one_rank_only():
    rng = np.random.default_rng(13)
    rank_rows = {0: [step_row(s, rng, missing=("collective",)) for s in range(20)],
                 1: [step_row(s, rng) for s in range(20)]}
    w = assert_golden(rank_rows, max_steps=30)
    assert "collective" in w.phases_present  # rank 1 reports it


def test_clock_flip_mid_window_selects_host():
    rng = np.random.default_rng(14)
    rank_rows = {0: [step_row(s, rng, clock="device" if s < 20 else "host") for s in range(40)],
                 1: [step_row(s, rng) for s in range(40)]}
    assert assert_golden(rank_rows, max_steps=30).clock == "host"


def test_zero_and_negative_zero_durations_read_as_the_scalar_arm_reads_them():
    """``v or 0.0`` makes a reported ``-0.0`` a ``0.0`` in the scalar
    arm's series; the columnar gather canonicalizes it the same way."""
    rng = np.random.default_rng(15)
    rows = [step_row(s, rng) for s in range(12)]
    for i, row in enumerate(rows):
        ev = row["events"][T.FORWARD_TIME]
        ev["device_ms"] = -0.0 if i % 2 else 0.0
        ev["cpu_ms"] = -0.0
    w = assert_golden({0: rows, 1: [step_row(s, rng) for s in range(12)]}, max_steps=12)
    assert all(math.copysign(1.0, v) == 1.0 for v in w.rank_windows[0].series["forward"])


def test_no_overlap_and_empty_inputs():
    rng = np.random.default_rng(16)
    rank_rows = {0: [step_row(s, rng) for s in range(0, 10)], 1: [step_row(s, rng) for s in range(20, 30)]}
    assert build_step_time_window(rank_rows, max_steps=30) is None
    assert build_columnar_step_time_window(cols_for(rank_rows), 30) is None
    assert build_columnar_step_time_window({}, 30) is None
    assert build_step_time_metrics({}) == {}


def test_ring_eviction_matches_deque_maxlen():
    rng = np.random.default_rng(17)
    cap = 16
    cols = StepTimeColumns(cap)
    rows = deque(maxlen=cap)
    for s in range(3 * cap + 5):  # several compactions
        row = step_row(s, rng, drop_p=0.15)
        cols.append(row)
        rows.append(row)
        assert window_to_plain(build_columnar_step_time_window({0: cols}, 12)) == window_to_plain(
            build_step_time_window({0: list(rows)}, max_steps=12))
    assert len(cols) == cap and cols.appended_total == 3 * cap + 5 and cols.evicted_total == 2 * cap + 5


def test_the_port_scalar_arm_equals_the_jax_scalar_arm():
    """Tolerance 0: the port's scalar builder is the JAX one copied."""
    rng = np.random.default_rng(18)
    rank_rows = {r: [step_row(s, rng, drop_p=0.15) for s in range(int(rng.integers(0, 6)), 50)] for r in range(5)}
    assert window_to_plain(build_step_time_window(rank_rows, max_steps=40)) == jax_window_to_plain(
        jax_scalar_build(rank_rows, max_steps=40))


@pytest.mark.skipif(sys.version_info < (3, 12), reason="sum() is a plain left fold below Python 3.12")
def test_jax_engine_fold_differs_from_its_scalar_arm():
    """The reference fault the port does not copy: the JAX engine's
    averages fold with ``np.cumsum`` while its scalar arm's ``sum()`` is
    compensated, so on this seeded input the JAX windows differ; the
    port's engine equals the port's (and the JAX) scalar arm."""
    rng = np.random.default_rng(19)
    rank_rows = {r: [step_row(s, rng, drop_p=0.15) for s in range(int(rng.integers(0, 8)), 64)] for r in range(8)}
    scalar = jax_window_to_plain(jax_scalar_build(rank_rows, max_steps=60))
    jax_engine = jax_window_to_plain(jax_columnar_build(cols_for(rank_rows, ring=JaxColumns), 60))
    assert jax_engine != scalar
    port_engine = window_to_plain(build_columnar_step_time_window(cols_for(rank_rows), 60))
    assert port_engine == scalar


# -- fallback flagging -----------------------------------------------------


def test_duplicate_step_flags_fallback():
    rng = np.random.default_rng(20)
    cols = StepTimeColumns(32)
    cols.append(step_row(5, rng))
    cols.append(step_row(5, rng))
    assert not cols.columnar_ok
    with pytest.raises(ColumnarFallback):
        build_columnar_step_time_window({0: cols}, 10)


@pytest.mark.parametrize("bad", ["out_of_order", "no_step", "not_a_number", "nan", "inf", "phase_not_a_dict"])
def test_unrepresentable_rows_flag_fallback(bad):
    """Rows the vectorized build cannot hold exactly flag the rank's ring
    (sticky); the store then builds that window with the scalar arm."""
    rng = np.random.default_rng(21)
    rows = {
        "out_of_order": [step_row(5, rng), step_row(3, rng)],
        "no_step": [{"step": None, "events": {}}],
        "not_a_number": [{"step": 1, "events": {T.STEP_TIME: {"cpu_ms": "NaN-ish"}}}],
        "nan": [{"step": 1, "events": {T.STEP_TIME: {"cpu_ms": float("nan")}}}],
        "inf": [{"step": 1, "events": {T.FORWARD_TIME: {"cpu_ms": 1.0, "device_ms": float("inf")}}}],
        "phase_not_a_dict": [{"step": 1, "events": {T.FORWARD_TIME: 3.0}}],
    }[bad]
    cols = StepTimeColumns(32)
    for row in rows:
        cols.append(row)
    assert not cols.columnar_ok
    with pytest.raises(ColumnarFallback):
        build_columnar_step_time_window({0: cols}, 10)
    cols.append(step_row(50, rng))
    assert not cols.columnar_ok  # sticky until the ring is cleared
    cols.clear()
    cols.append(step_row(50, rng))
    assert cols.columnar_ok


def test_memory_negative_or_huge_values_flag_fallback():
    good = MemoryColumns(8)
    good.append(mem_row(1, 100, 90))
    assert good.columnar_ok
    for row in (mem_row(1, -5, 90), mem_row(1, 2 ** 60, 90), dict(mem_row(1, 100, 90), device_id=None),
                dict(mem_row(1, 100, 90), current_bytes=True)):
        cols = MemoryColumns(8)
        cols.append(row)
        assert not cols.columnar_ok


# -- memory: rows against columns ------------------------------------------


def _diag_plain(result):
    return result.to_dict()


MEMORY_SCENARIOS = {
    "healthy": lambda: {r: [mem_row(s, 8 * G, 7 * G) for s in range(30)] for r in range(3)},
    "pressure": lambda: {0: [mem_row(s, int(15.6 * G), 15 * G) for s in range(30)],
                         1: [mem_row(s, 9 * G, 8 * G) for s in range(30)]},
    "imbalance": lambda: {0: [mem_row(s, 14 * G, 13 * G) for s in range(30)],
                          1: [mem_row(s, 4 * G, 3 * G) for s in range(30)]},
    "multi_device": lambda: {0: sorted([mem_row(s, 8 * G, 7 * G, dev=0) for s in range(30)]
                                       + [mem_row(s, 6 * G, 5 * G, dev=1) for s in range(30)],
                                       key=lambda r: r["step"]),
                             1: [mem_row(s, 8 * G, 7 * G) for s in range(30)]},
    "null_fields": lambda: {0: [dict(mem_row(s, 9 * G, 7 * G), limit_bytes=None,
                                     step_peak_bytes=None if s % 3 else 9 * G,
                                     current_bytes=None if s < 2 else 7 * G + s) for s in range(20)]},
    "creep": lambda: {r: [mem_row(s, 8 * G + s * 40_000_000, 7 * G + s * 40_000_000) for s in range(900)]
                      for r in range(2)},
}


@pytest.mark.parametrize("scenario", sorted(MEMORY_SCENARIOS))
def test_memory_diagnosis_and_view_rows_vs_columns(scenario):
    rank_rows = MEMORY_SCENARIOS[scenario]()
    cap = max(len(rows) for rows in rank_rows.values())
    cols = mem_cols_for(rank_rows, cap)
    assert _diag_plain(diagnose_columns(cols)) == _diag_plain(diagnose_rank_rows(rank_rows))
    assert V.build_memory_view(rank_rows, columns=cols).as_dict() == V.build_memory_view(rank_rows).as_dict()


# -- the store -------------------------------------------------------------


def test_store_columnar_window_matches_scalar_rows(tmp_path):
    rng = np.random.default_rng(22)
    db = tmp_path / "t.sqlite"
    w = SQLiteWriter(db)
    w.start()
    feed = Feeder(w)
    store = LiveSnapshotStore(db, window_steps=40)
    try:
        for rank in (0, 1):
            feed.send(rank, "step_time", [step_row(s, rng, drop_p=0.15) for s in range(1, 31)])
        assert w.force_flush()
        store.refresh()
        win = store.build_step_time_window(max_steps=20)
        assert getattr(win, "col", None) is not None  # the columnar path
        assert window_to_plain(win) == window_to_plain(build_step_time_window(store.step_time_rows(), max_steps=20))
        for rank in (0, 1):
            feed.send(rank, "step_time", [step_row(s, rng, drop_p=0.15) for s in range(31, 41)])
        assert w.force_flush()
        store.refresh()
        win2 = store.build_step_time_window(max_steps=20)
        assert window_to_plain(win2) == window_to_plain(build_step_time_window(store.step_time_rows(), max_steps=20))
        assert win2.steps[-1] == 40 and store.latest_step_time_ts() == pytest.approx(140.0)
        assert store.window_build_stats()["step_time"]["incr_ticks"] == 1
    finally:
        assert w.finalize()
        store.close()


def test_store_trim_keeps_ring_in_lockstep(tmp_path):
    """The writer's retention prune journals its watermarks; the store's
    refresh evicts each rank's deque prefix and the ring's head together,
    so the engine's window equals the scalar arm's on the trimmed rows."""
    rng = np.random.default_rng(23)
    db = tmp_path / "t.sqlite"
    w = SQLiteWriter(db, summary_window_rows=10, retention_factor=1.5)
    w.start()
    feed = Feeder(w)
    store = LiveSnapshotStore(db, window_steps=50)
    try:
        for start in (1, 26, 51, 76):
            for rank in (0, 1):
                feed.send(rank, "step_time", [step_row(s, rng) for s in range(start, start + 25)])
                feed.send(rank, "step_memory", [mem_row(s, 8 * G, 7 * G + s) for s in range(start, start + 25)])
            assert w.force_flush()
            store.refresh()
            win = store.build_step_time_window(max_steps=50)
            assert window_to_plain(win) == window_to_plain(build_step_time_window(store.step_time_rows(), 50))
        assert w.finalize()  # trims every partition to retention (15 rows)
        assert store.refresh() is True
        win = store.build_step_time_window(max_steps=50)
        assert window_to_plain(win) == window_to_plain(build_step_time_window(store.step_time_rows(), 50))
        assert win.steps[0] == 86 and win.steps[-1] == 100
        for buf in list(store._step_time.values()) + list(store._step_memory.values()):
            assert len(buf.cols) == len(buf.ids) == 15
        cols = store.step_memory_columns()
        assert [int(s) for s in cols[0].column(0)] == [r["step"] for r in store.step_memory_rows()[0]]
    finally:
        store.close()


def test_watermark_filter_rebuilds_the_ring():
    """A watermark filter that drops rows out of the middle of a buffer
    (ids not ascending within it) rebuilds the ring from the kept rows."""
    rng = np.random.default_rng(24)
    buf = _StepTimeBuffer(8)
    rows = [step_row(s, rng) for s in range(1, 7)]
    for row_id, row in zip((10, 3, 11, 4, 12, 13), rows):
        buf.append(row_id, 0, row)
    assert buf.filter_watermarks({0: 4})  # drops ids 3 and 4, the 2nd and 4th rows
    assert [r["step"] for r in buf.rows] == [1, 3, 5, 6] and len(buf.cols) == 4
    assert buf.cols.steps_view().tolist() == [1, 3, 5, 6]
    assert window_to_plain(build_columnar_step_time_window({0: buf.cols}, 10)) == window_to_plain(
        build_step_time_window({0: list(buf.rows)}, max_steps=10))
    assert not buf.filter_watermarks({1: 100})  # another rank's watermark: nothing dropped


def test_env_kill_switch_forces_scalar(tmp_path, monkeypatch):
    rng = np.random.default_rng(25)
    db = tmp_path / "t.sqlite"
    w = SQLiteWriter(db)
    w.start()
    feed = Feeder(w)
    store = LiveSnapshotStore(db, window_steps=40)
    try:
        feed.send(0, "step_time", [step_row(s, rng) for s in range(1, 11)])
        feed.send(0, "step_memory", [mem_row(s, 8 * G, 7 * G) for s in range(1, 11)])
        assert w.force_flush()
        store.refresh()
        monkeypatch.setenv("TRACEML_COLUMNAR_WINDOW", "0")
        assert not columnar_window_enabled()
        win = store.build_step_time_window(max_steps=20)
        assert getattr(win, "col", None) is None  # a plain scalar window
        assert store.step_memory_columns() is None
        monkeypatch.setenv("TRACEML_COLUMNAR_WINDOW", "1")
        win2 = store.build_step_time_window(max_steps=20)
        assert getattr(win2, "col", None) is not None and store.step_memory_columns() is not None
        assert window_to_plain(win) == window_to_plain(win2)
    finally:
        assert w.finalize()
        store.close()
