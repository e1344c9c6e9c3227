"""The port's incremental window engine: the delta tick is bit-identical,
always.

Ported from ``tests/utils/test_incremental_window.py`` (its step-time
domain; the collectives and serving caches come with their domains).
``StepTimeWindowCache`` either gives a window equal to the from-scratch
columnar build, itself equal to the port's scalar arm, or falls back to
that build.  Seeded interleavings of append, ragged arrival, ring
eviction, retention trim, clock flip, window resize, a flagged ring and
a cleared rank run through ONE persistent cache each, and after every
operation

    incremental == full build == scalar reference

(plain-dict forms, tolerance 0).  Fixtures then pin each invalidation
reason and the build counters.

End to end, twin live computers read one session database, one with the
three switches unset (the engines: incremental cache, vector arms,
diagnosis cache and memos) and one with ``TRACEML_COLUMNAR_WINDOW=0
TRACEML_INCR_WINDOW=0 TRACEML_VECTOR_DIAGNOSIS=0`` (the scalar arm), as
seeded ticks append rows to a ragged set of ranks, flip the clock, add a
rank, make the writer prune (the watermark journal trims the store) and
finally trim every partition: on every tick the served fragments' bytes,
the windows and the diagnoses are equal, and so are the two final
reports of the database, ``generated_at`` and ``window_build`` aside.
"""

import json

import numpy as np
import pytest

from tests.test_torch_columnar_window import Feeder, mem_row, step_row
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.renderers.compute import LiveComputer
from traceml_tpu_torch.renderers.web_payload import FRAGMENT_ORDER, build_fragment
from traceml_tpu_torch.reporting.final import generate_summary
from traceml_tpu_torch.runtime.settings import TraceMLSettings
from traceml_tpu_torch.utils.columnar import (
    INVALIDATE_CLOCK,
    INVALIDATE_COLD,
    INVALIDATE_FALLBACK,
    INVALIDATE_RANKS,
    INVALIDATE_REALIGNED,
    INVALIDATE_SIZE,
    ColumnarFallback,
    StepTimeColumns,
    StepTimeWindowCache,
    build_columnar_step_time_window,
    incr_window_enabled,
    window_to_plain,
)
from traceml_tpu_torch.utils.step_time_window import build_step_time_window

SWITCHES = ("TRACEML_COLUMNAR_WINDOW", "TRACEML_INCR_WINDOW", "TRACEML_VECTOR_DIAGNOSIS")
GiB = 1 << 30


# -- the harness -----------------------------------------------------------


class StepTimeDomain:
    """The snapshot store's lockstep pair per rank (a row list with
    ``deque(maxlen)`` semantics and a ring) plus ONE persistent cache."""

    def __init__(self, ranks, cap, rng):
        self.rng, self.cap, self.clock, self.gstep = rng, cap, "device", 0
        self.rows = {r: [] for r in ranks}
        self.cols = {r: StepTimeColumns(cap) for r in ranks}
        self.cache = StepTimeWindowCache()

    def _append(self, rank, row):
        self.rows[rank] = (self.rows[rank] + [row])[-self.cap:]
        self.cols[rank].append(row)

    def append_step(self, ranks):
        self.gstep += 1
        for r in ranks:
            self._append(r, step_row(self.gstep, self.rng, self.clock, drop_p=0.15))

    def evict(self, rank, n):
        self.rows[rank] = self.rows[rank][n:]
        self.cols[rank].evict_head(n)

    def clear(self, rank):
        self.rows[rank] = []
        self.cols[rank].clear()

    def poison(self, rank):
        """A duplicate step: the ring flags, sticky."""
        last = self.rows[rank][-1]["step"] if self.rows[rank] else 1
        row = step_row(last, self.rng, self.clock)
        self.rows[rank].append(row)
        self.cols[rank].append(row)

    def tick_assert(self, max_steps, compare_scalar=True):
        live = {r: c for r, c in self.cols.items() if len(c)}
        try:
            full = window_to_plain(build_columnar_step_time_window(live, max_steps))
            full_raised = False
        except ColumnarFallback:
            full_raised = True
        try:
            inc = window_to_plain(self.cache.build(live, max_steps))
            inc_raised = False
        except ColumnarFallback:
            inc_raised = True
        assert inc_raised == full_raised
        if full_raised:
            return
        assert inc == full
        if compare_scalar:
            rows = {r: list(v) for r, v in self.rows.items() if v}
            assert inc == window_to_plain(build_step_time_window(rows, max_steps=max_steps))


def run_interleaving(seed):
    rng = np.random.default_rng(seed)
    R = int(rng.integers(1, 5))
    cap = int(rng.integers(8, 25))
    max_steps = int(rng.integers(4, 13))
    dom = StepTimeDomain(list(range(R)), cap, rng)
    for _ in range(int(rng.integers(1, 7))):  # warm up with a few aligned steps
        dom.append_step(range(R))
    dom.tick_assert(max_steps)
    for _ in range(22):
        op = rng.random()
        if op < 0.45:
            # append; sometimes ragged (a strict subset of the ranks)
            if R > 1 and rng.random() < 0.35:
                ranks = rng.choice(R, size=int(rng.integers(1, R)), replace=False).tolist()
            else:
                ranks = range(R)
            dom.append_step(ranks)
        elif op < 0.60:
            for _ in range(int(rng.integers(2, cap + 1))):  # a burst past the ring's cap
                dom.append_step(range(R))
        elif op < 0.75:
            r = int(rng.integers(R))  # retention trim: head eviction in lockstep
            dom.evict(r, int(rng.integers(1, max(1, len(dom.rows[r])) + 1)))
        elif op < 0.80:
            dom.clock = "host" if dom.clock == "device" else "device"
            dom.append_step(range(R))
        elif op < 0.85:
            dom.tick_assert(max_steps)  # an idle double tick
        elif op < 0.90:
            dom.tick_assert(max(2, max_steps // 2))  # a window resize mid-run
        elif op < 0.95:
            r = int(rng.integers(R))
            dom.poison(r)
            dom.tick_assert(max_steps, compare_scalar=False)
            dom.clear(r)  # the store's reset: ring and deque cleared
            dom.append_step(range(R))
        else:
            r = int(rng.integers(R))
            dom.clear(r)
            dom.append_step(range(R))
        dom.tick_assert(max_steps)
    stats = dom.cache.stats.snapshot()
    assert stats["incr_ticks"] + stats["full_rebuilds"] > 0
    return stats


@pytest.mark.parametrize("seed", range(67))
def test_step_time_interleavings(seed):
    run_interleaving(1000 + seed)


def test_interleavings_reach_every_reason_and_the_delta_path():
    """Across the seeds, the delta path serves ticks and every reason an
    interleaving can give shows up at least once (a rank here always
    resumes past the aligned tail, so ``realigned`` has its own fixture)."""
    seen, incr = set(), 0
    for seed in range(1000, 1067):
        stats = run_interleaving(seed)
        seen |= set(stats["invalidations"])
        incr += stats["incr_ticks"]
    assert incr > 500
    assert seen >= {INVALIDATE_COLD, INVALIDATE_SIZE, INVALIDATE_CLOCK, INVALIDATE_FALLBACK}


# -- invalidation reasons --------------------------------------------------


def aligned(n, ranks=2, cap=64, clock="device", start=1, seed=7):
    rng = np.random.default_rng(seed)
    cols = {r: StepTimeColumns(cap) for r in range(ranks)}
    for s in range(start, start + n):
        for c in cols.values():
            c.append(step_row(s, rng, clock))
    return cols


def test_cold_start_then_steady_incremental_ticks():
    cache = StepTimeWindowCache()
    cols = aligned(10)
    cache.build(cols, 8)
    assert cache.stats.invalidations == {INVALIDATE_COLD: 1}
    rng = np.random.default_rng(9)
    for s in range(11, 31):
        for c in cols.values():
            c.append(step_row(s, rng))
        w = cache.build(cols, 8)
        assert window_to_plain(w) == window_to_plain(build_columnar_step_time_window(cols, 8))
    st = cache.stats.snapshot()
    assert st["full_rebuilds"] == 1 and st["incr_ticks"] == 20
    assert st["last_path"] == "incremental" and st["last_build_ms"] >= 0.0


def test_window_size_change_invalidates():
    cache = StepTimeWindowCache()
    cols = aligned(10)
    cache.build(cols, 8)
    cache.build(cols, 4)
    assert cache.stats.invalidations.get(INVALIDATE_SIZE) == 1


def test_rank_set_change_invalidates():
    cache = StepTimeWindowCache()
    cols = aligned(10, ranks=2)
    cache.build(cols, 8)
    cols[2] = aligned(10, ranks=1, seed=3)[0]
    w = cache.build(cols, 8)
    assert cache.stats.invalidations.get(INVALIDATE_RANKS) == 1 and w.ranks == [0, 1, 2]


def test_clock_flip_invalidates():
    cache = StepTimeWindowCache()
    cols = aligned(10, clock="device")
    cache.build(cols, 8)
    rng = np.random.default_rng(5)
    for c in cols.values():
        c.append(step_row(11, rng, clock="host"))
    assert cache.build(cols, 8).clock == "host"
    assert cache.stats.invalidations.get(INVALIDATE_CLOCK) == 1


def test_host_to_device_flip_once_host_rows_are_evicted():
    cache = StepTimeWindowCache()
    cols = aligned(4, cap=6, clock="host")
    cache.build(cols, 4)
    rng = np.random.default_rng(6)
    for s in range(5, 11):  # six device rows push the four host rows out of the rings
        for c in cols.values():
            c.append(step_row(s, rng, clock="device"))
        w = cache.build(cols, 4)
    assert w.clock == "device" and cache.stats.invalidations.get(INVALIDATE_CLOCK) == 1
    assert window_to_plain(w) == window_to_plain(build_columnar_step_time_window(cols, 4))


def test_a_restarted_rank_reporting_old_steps_realigns():
    cache = StepTimeWindowCache()
    cols = aligned(10)
    cache.build(cols, 8)
    rng = np.random.default_rng(4)
    cols[1].clear()
    for s in range(3, 12):  # the restarted rank reports steps the cache holds
        cols[1].append(step_row(s, rng))
    w = cache.build(cols, 8)
    assert cache.stats.invalidations.get(INVALIDATE_REALIGNED) == 1
    assert window_to_plain(w) == window_to_plain(build_columnar_step_time_window(cols, 8))


def test_eviction_below_the_window_is_absorbed():
    """Head eviction slides the cached window instead of invalidating."""
    cache = StepTimeWindowCache()
    cols = aligned(10)
    cache.build(cols, 4)  # window = steps 7..10
    cols[0].evict_head(8)  # rank 0 keeps steps 9, 10: the window slides to them
    w = cache.build(cols, 4)
    assert w.steps == [9, 10] and cache.stats.incr_ticks == 1 and cache.stats.full_rebuilds == 1
    assert window_to_plain(w) == window_to_plain(build_columnar_step_time_window(cols, 4))


def test_fallback_counts_and_propagates():
    cache = StepTimeWindowCache()
    cols = aligned(10)
    cache.build(cols, 8)
    cols[0].append(step_row(5, np.random.default_rng(2)))  # a duplicate step: sticky flag
    with pytest.raises(ColumnarFallback):
        cache.build(cols, 8)
    assert cache.stats.invalidations.get(INVALIDATE_FALLBACK) == 1
    assert cache.stats.snapshot()["last_path"] == "full"


def test_kill_switch_reads_the_environment_per_call(monkeypatch):
    monkeypatch.setenv("TRACEML_INCR_WINDOW", "0")
    assert not incr_window_enabled()
    monkeypatch.setenv("TRACEML_INCR_WINDOW", "off")
    assert not incr_window_enabled()
    monkeypatch.setenv("TRACEML_INCR_WINDOW", "1")
    assert incr_window_enabled()
    monkeypatch.delenv("TRACEML_INCR_WINDOW")
    assert incr_window_enabled()


# -- end to end: the engines against the switches at 0 ----------------------


def _as_engine(monkeypatch):
    for flag in SWITCHES:
        monkeypatch.delenv(flag, raising=False)


def _as_scalar(monkeypatch):
    for flag in SWITCHES:
        monkeypatch.setenv(flag, "0")


def _tick(computer, db):
    """What a viewer is served (each fragment's bytes, ``meta`` less the
    engine's counters), the window and the diagnoses, taken within the
    tick (an engine window aliases the cache's buffers until the next)."""
    payload, _ = computer.payload_with_versions()
    frags = {}
    for name in FRAGMENT_ORDER:
        frag = build_fragment(name, payload, session="s", db_path=db)
        if name == "meta":
            frag = {k: v for k, v in frag.items() if k != "window_build"}
        frags[name] = json.dumps(frag)
    st = payload.get("step_time") or {}
    diags = [st.get("diagnosis"), payload.get("step_memory_diagnosis")]
    return {"frags": frags, "window": window_to_plain(st.get("window")),
            "diagnoses": [None if d is None else d.to_dict() for d in diags]}, payload


@pytest.mark.parametrize("seed", range(4))
def test_engine_payloads_equal_the_scalar_arm_on_every_tick(tmp_path, monkeypatch, seed):
    rng = np.random.default_rng(500 + seed)
    db = tmp_path / "s" / "telemetry.sqlite"
    db.parent.mkdir()
    writer = SQLiteWriter(db, summary_window_rows=8)  # retention 12 rows: the writer prunes
    writer.start()
    feed = Feeder(writer, world=3)
    engine, scalar = LiveComputer(db, window_steps=24), LiveComputer(db, window_steps=24)
    ranks, clock, gstep, step = [0, 1], "device", 0, {0: 0, 1: 0}
    windows = 0
    try:
        for tick in range(70):
            op = rng.random()
            if tick == 30:
                ranks, step[2] = [0, 1, 2], gstep - 5  # a rank joins, five steps back
            if op < 0.1:
                clock = "host" if clock == "device" else "device"
            if op < 0.8:
                gstep += int(rng.integers(1, 12))
                # a ragged arrival: each rank catches up to the newest step,
                # or to a step part of the way there
                for r in ranks:
                    upto = gstep if rng.random() < 0.7 else int(rng.integers(step[r], gstep + 1))
                    n = upto - step[r]
                    if n <= 0:
                        continue
                    feed.send(r, "step_time", [step_row(step[r] + i + 1, rng, clock, drop_p=0.15) for i in range(n)])
                    feed.send(r, "step_memory", [mem_row(step[r] + i + 1, 8 * GiB, (7 + r) * GiB + i)
                                                 for i in range(n)])
                    step[r] = upto
            elif op < 0.9:
                feed.send(0, "model_stats", [{"timestamp": 1.7e9 + tick, "flops_per_step": 9.0e12,
                                              "flops_source": "flop_counter", "device_kind": "NVIDIA H100",
                                              "peak_flops": 989e12, "device_count": 1,
                                              "tokens_per_step": 8192.0}], sampler="step_time")
            assert writer.force_flush()
            _as_engine(monkeypatch)
            ours, payload = _tick(engine, db)
            _as_scalar(monkeypatch)
            theirs, _ = _tick(scalar, db)
            assert ours == theirs, tick
            windows += ours["window"] is not None
        assert windows >= 60
        _as_engine(monkeypatch)
        wb = payload["window_build_stats"]
        assert wb["step_time"]["incr_ticks"] > 0 and wb["tick_profile"]["ticks"] == 70
        assert writer.stats()["prune"]["prunes"] > 0  # the journal trimmed the stores
        assert writer.finalize()
        _as_engine(monkeypatch)
        ours, _ = _tick(engine, db)
        _as_scalar(monkeypatch)
        assert ours == _tick(scalar, db)[0]
    finally:
        engine.close()
        scalar.close()
    reports = {}
    for name, arm in (("engine", _as_engine), ("scalar", _as_scalar)):
        arm(monkeypatch)
        session = tmp_path / name / "s"  # its own logs dir: its own baseline store
        assert generate_summary(db, session, TraceMLSettings(session_id="s", mode="summary"))
        report = json.loads((session / "final_summary.json").read_text())
        wb = report["meta"].pop("window_build", None)
        assert (wb is not None) == (name == "engine")
        del report["meta"]["generated_at"]
        reports[name] = report
    assert reports["engine"] == reports["scalar"]

