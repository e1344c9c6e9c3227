"""The port's vectorized diagnosis arms against its scalar arms: byte-
identical issue lists, always.

Ported from ``tests/diagnostics/test_vector_parity.py`` (its step-time
and step-memory packs, without a mesh: the port has no topology yet).
Every fixture is swept through both arms of ``TRACEML_VECTOR_DIAGNOSIS``
and compared as ``json.dumps(result.to_dict(), sort_keys=True)`` bytes:
deterministic rule-firing windows (compute bound, input bound, an input
straggler, a clean straggler behind sync waits, a compile storm on
two and on five ranks, where ``sum()``'s compensation meets the vector
arm's fold) and seeded ragged ones.  With the switch on the step-time window
is the columnar engine's and its rules take the cube arms
(``vector.gate``); with it off, the scalar window and the scalar arms.
So each comparison also holds the engine window against the scalar one
through every rule.  The views' ``as_dict`` is equal under both arms
(the fast walk against ``dataclasses.asdict``), and a vector helper that
cannot run warns once and counts.
"""

import json
import logging

import numpy as np
import pytest

from traceml_tpu_torch.diagnostics.step_memory.api import diagnose_columns, diagnose_rank_rows
from traceml_tpu_torch.diagnostics.step_time import vector as st_vector
from traceml_tpu_torch.diagnostics.step_time.api import diagnose_window
from traceml_tpu_torch.renderers import views as V
from traceml_tpu_torch.utils import columnar
from traceml_tpu_torch.utils import timing as T
from traceml_tpu_torch.utils.columnar import (
    StepTimeColumns,
    build_columnar_step_time_window,
    note_vector_fallback,
    vector_diagnosis_enabled,
    vector_fallback_counts,
)
from traceml_tpu_torch.utils.step_time_window import build_step_time_window

GiB = 1 << 30


@pytest.fixture(autouse=True)
def _no_fallback_left_behind(monkeypatch):
    """The fallback counters are process-wide (the tick profile reports
    them): each test here starts from none and leaves none behind."""
    monkeypatch.setattr(columnar, "_VECTOR_FALLBACKS", {})
    monkeypatch.setattr(columnar, "_VECTOR_FALLBACK_WARNED", set())


def _dump(result) -> bytes:
    return json.dumps(result.to_dict(), sort_keys=True).encode()


def _arms(monkeypatch, fn):
    """``fn`` under the vector arm and under the scalar arm; the
    serialized results must be byte-identical."""
    monkeypatch.setenv("TRACEML_VECTOR_DIAGNOSIS", "1")
    assert vector_diagnosis_enabled()
    on = _dump(fn())
    monkeypatch.setenv("TRACEML_VECTOR_DIAGNOSIS", "0")
    assert not vector_diagnosis_enabled()
    off = _dump(fn())
    assert on == off
    return json.loads(on)


# -- step time -------------------------------------------------------------


def st_row(step, step_ms, input_ms=0.0, h2d_ms=0.0, compute_ms=0.0, backward_ms=0.0, compile_ms=0.0):
    events = {T.STEP_TIME: {"cpu_ms": step_ms, "device_ms": step_ms, "count": 1}}
    if input_ms:
        events[T.DATALOADER_NEXT] = {"cpu_ms": input_ms, "device_ms": None, "count": 1}
    if h2d_ms:
        events[T.H2D_TIME] = {"cpu_ms": 0.2, "device_ms": h2d_ms, "count": 1}
    if compute_ms:
        events[T.COMPUTE_TIME] = {"cpu_ms": 0.5, "device_ms": compute_ms, "count": 1}
    if backward_ms:
        events[T.BACKWARD_TIME] = {"cpu_ms": backward_ms, "device_ms": backward_ms, "count": 1}
    if compile_ms:
        events[T.COMPILE_TIME] = {"cpu_ms": compile_ms, "device_ms": None, "count": 1}
    return {"step": step, "timestamp": 100.0 + step, "clock": "device", "late_markers": 0, "events": events}


def steady(n, step_ms, **kw):
    return [st_row(s, step_ms, **kw) for s in range(1, n + 1)]


def compile_storm(ranks, seed=3):
    """A recompile every third step on every rank, 300-500 ms each.  On
    seed 3 with five ranks the per-rank means' ``sum()`` differs from
    their plain fold in the last bit (``test_compile_storm_pins_the_fold``)."""
    rng = np.random.default_rng(seed)
    rows = {r: [] for r in range(ranks)}
    for s in range(1, 61):
        for r in range(ranks):
            c = float(rng.uniform(300.0, 500.0)) if s % 3 == 0 else 0.0
            rows[r].append(st_row(s, 100.0 + c, compute_ms=55.0, compile_ms=c))
    return rows


def ragged(seed):
    rng = np.random.default_rng(seed)
    return {
        r: [st_row(s, float(rng.uniform(80.0, 160.0)), input_ms=float(rng.uniform(0.0, 30.0)),
                   h2d_ms=float(rng.uniform(0.0, 8.0)), compute_ms=float(rng.uniform(20.0, 90.0)),
                   backward_ms=float(rng.uniform(0.0, 40.0)))
            for s in range(int(rng.integers(1, 6)), 64)]
        for r in range(int(rng.integers(2, 9)))
    }


def input_straggler():
    rows = {r: steady(60, 100.0, input_ms=4.0, compute_ms=90.0) for r in range(7)}
    rows[7] = steady(60, 280.0, input_ms=184.0, compute_ms=90.0)
    return rows


def clean_straggler():
    """Rank 0 slow in its residual, the others' backward inflated by the
    sync wait.  Ranks in order, as the store and the loaders give them
    (the scalar arm breaks ties in the input's order, the cube in rank
    order)."""
    return {r: steady(60, 200.0, input_ms=4.0, backward_ms=60.0 if r == 0 else 156.0) for r in range(8)}


ST_FIXTURES = {
    "compute_bound": (lambda: {r: steady(60, 100.0, input_ms=3.0, compute_ms=92.0) for r in range(4)},
                      "COMPUTE_BOUND"),
    "input_bound": (lambda: {r: steady(60, 100.0, input_ms=45.0, compute_ms=50.0) for r in range(4)},
                    "INPUT_BOUND"),
    "input_straggler": (input_straggler, "INPUT_STRAGGLER"),
    "clean_straggler": (clean_straggler, None),
    "compile_storm_2": (lambda: compile_storm(2), "COMPILE_BOUND"),
    "compile_storm_5": (lambda: compile_storm(5), "COMPILE_BOUND"),
    **{f"ragged_{seed}": (lambda seed=seed: ragged(seed), None) for seed in range(6)},
}


def st_window(rank_rows, max_steps=200):
    """The engine's window with the vector switch on, the scalar arm's
    with it off (what the store builds under each)."""
    if not vector_diagnosis_enabled():
        return build_step_time_window(rank_rows, max_steps=max_steps)
    cols = {}
    for rank, rows in rank_rows.items():
        c = cols[rank] = StepTimeColumns(512)
        for row in rows:
            c.append(row)
    w = build_columnar_step_time_window(cols, max_steps)
    assert st_vector.gate(w) is w.col
    return w


@pytest.mark.parametrize("name", sorted(ST_FIXTURES))
def test_step_time_parity(monkeypatch, name):
    make, kind = ST_FIXTURES[name]
    rank_rows = make()
    for mode in ("live", "summary"):
        got = _arms(monkeypatch, lambda: diagnose_window(st_window(rank_rows), mode=mode))
        if kind is not None:
            assert got["diagnosis"]["kind"] == kind or kind in {i["kind"] for i in got["issues"]}, got
    vals = []
    for flag in ("1", "0"):
        monkeypatch.setenv("TRACEML_VECTOR_DIAGNOSIS", flag)
        vals.append(V.build_step_time_view(st_window(rank_rows), world_size=len(rank_rows)).as_dict())
    assert vals[0] == vals[1]


def test_compile_storm_pins_the_fold(monkeypatch):
    """The compile rule's vector arm averages the per-rank recompile means
    with ``sum()``'s fold; on this fixture a plain fold (the JAX arm's
    ``np.cumsum``) gives another last bit, so the parity above holds the
    fold, not just the rule's thresholds."""
    from traceml_tpu_torch.diagnostics.step_time.policy import LIVE_POLICY
    from traceml_tpu_torch.utils.columnar import KEY_INDEX, plain_fold

    monkeypatch.setenv("TRACEML_VECTOR_DIAGNOSIS", "1")
    w = st_window(compile_storm(5))
    comp = w.col.series_cube[:, KEY_INDEX["compile"], :]
    per_rank = plain_fold(np.where((comp > 0) & (w.col.steps > LIVE_POLICY.compile_warmup_steps), comp, 0.0).T) / comp.shape[1]
    assert float(np.cumsum(per_rank)[-1]) != sum(per_rank.tolist())


def test_step_time_vector_gate_respects_the_switch(monkeypatch):
    rank_rows = {r: [st_row(s, 100.0, compute_ms=90.0) for s in range(1, 40)] for r in range(2)}
    monkeypatch.setenv("TRACEML_VECTOR_DIAGNOSIS", "1")
    w = st_window(rank_rows)
    monkeypatch.setenv("TRACEML_VECTOR_DIAGNOSIS", "0")
    assert st_vector.gate(w) is None
    monkeypatch.setenv("TRACEML_VECTOR_DIAGNOSIS", "1")
    assert st_vector.gate(w) is w.col
    assert st_vector.gate(build_step_time_window(rank_rows)) is None  # a scalar window has no cube


# -- step memory -----------------------------------------------------------


def mem_row(step, cur, limit=16 * GiB, dev=0):
    return {"step": step, "device_id": dev, "current_bytes": cur, "step_peak_bytes": cur, "limit_bytes": limit}


def mem_fixtures():
    yield {0: [mem_row(s, 4 * GiB) for s in range(100)]}
    yield {0: [mem_row(s, int(15.8 * GiB)) for s in range(100)]}
    yield {0: [mem_row(s, 9 * GiB) for s in range(50)], 1: [mem_row(s, 14 * GiB) for s in range(50)],
           2: [mem_row(s, 9 * GiB) for s in range(50)]}  # imbalance under pressure: fires
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        yield {r: [mem_row(s, int(rng.integers(1 * GiB, 15 * GiB))) for s in range(60)]
               for r in range(int(rng.integers(2, 7)))}


@pytest.mark.parametrize("i", range(7))
def test_memory_parity(monkeypatch, i):
    rank_rows = list(mem_fixtures())[i]
    from tests.test_torch_columnar_window import mem_cols_for

    _arms(monkeypatch, lambda: diagnose_rank_rows(rank_rows))
    _arms(monkeypatch, lambda: diagnose_columns(mem_cols_for(rank_rows)))
    monkeypatch.setenv("TRACEML_VECTOR_DIAGNOSIS", "1")
    assert _dump(diagnose_columns(mem_cols_for(rank_rows))) == _dump(diagnose_rank_rows(rank_rows))


# -- fallback accounting ---------------------------------------------------


def test_vector_fallback_warns_once_then_counts(caplog):
    domain = "parity_test_domain"
    assert domain not in vector_fallback_counts()
    with caplog.at_level(logging.WARNING, logger="traceml_tpu_torch.utils.columnar"):
        for _ in range(3):
            note_vector_fallback(domain)
    assert len([r for r in caplog.records if domain in r.getMessage()]) == 1
    assert vector_fallback_counts()[domain] == 3


def test_a_vector_helper_that_cannot_run_falls_back_to_the_scalar_arm(monkeypatch):
    """A cube missing the worst rank: ``component_deltas`` counts a
    fallback and the rule reruns the scalar arm (same issues)."""
    rank_rows = clean_straggler()
    monkeypatch.setenv("TRACEML_VECTOR_DIAGNOSIS", "1")
    w = st_window(rank_rows)
    before = vector_fallback_counts().get("step_time", 0)
    assert st_vector.component_deltas(w.col, "averages", ["input"], None, {}, 99) is None
    assert vector_fallback_counts()["step_time"] == before + 1
