"""The port's tick profiler and per-(domain, version) diagnosis cache.

Ported from ``tests/renderers/test_tick_profile.py`` (its step-time and
memory domains):

* ``TICK_STAGES`` and the invalidation reasons are a published
  vocabulary, the JAX strings;
* a tick whose diagnosis inputs did not change runs ZERO rules: a
  model_stats-only ingest re-dirties step_time for the MFU block, and the
  cache returns the previous DiagnosticResult object
  (``diag_cache_hits`` counts it, ``rule_eval_counts`` proves no rule
  ran); new step rows invalidate it; ``TRACEML_VECTOR_DIAGNOSIS=0`` turns
  the cache off;
* the profile reaches ``window_build_stats()`` and, through the serving
  tier, the dashboard's ``window_build`` meta key, with the per-fragment
  ``serialize`` stage; the block has the JAX keys, stage names and
  counters (held against the JAX engine's block on the same database,
  less the collectives and serving domains and the mesh grouping cache's
  counters, which the port does not have yet);
* with ``TRACEML_VECTOR_DIAGNOSIS=0`` the served payload equals the
  default one, byte for byte, on twin sessions (``ts`` and the profile
  aside).
"""

import json

import numpy as np

from tests.test_torch_columnar_window import Feeder, mem_row, step_row
from tests.test_torch_final_report import JAX_ONLY_COUNTERS, JAX_ONLY_DOMAINS
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.diagnostics.common import rule_eval_counts
from traceml_tpu_torch.renderers import serving
from traceml_tpu_torch.renderers.compute import LiveComputer
from traceml_tpu_torch.renderers.serving import SessionPublisher
from traceml_tpu_torch.renderers.web_payload import build_web_payload
from traceml_tpu_torch.utils import columnar as C
from traceml_tpu_torch.utils.columnar import TICK_STAGES, TickProfile

GiB = 1 << 30


def seed_session(db, steps=25):
    w = SQLiteWriter(db)
    w.start()
    feed = Feeder(w)
    for rank in (0, 1):
        rng = np.random.default_rng(100 + rank)
        feed.send(rank, "step_time", [step_row(s, rng, drop_p=0.15) for s in range(1, steps)])
        feed.send(rank, "step_memory", [mem_row(s, 8 * GiB, (7 + rank) * GiB + s) for s in range(1, steps)])
    assert w.force_flush()
    return w, feed


def model_stats_row(ts=200.0):
    return {"timestamp": ts, "flops_per_step": 1.0e12, "flops_source": "manual", "device_kind": "NVIDIA H100",
            "peak_flops": 989e12, "device_count": 2, "tokens_per_step": 1024.0}


def test_the_vocabulary_is_the_jax_one():
    from traceml_tpu.utils import columnar as J

    assert TICK_STAGES == ("refresh", "build", "diagnose", "attribute", "view", "serialize") == J.TICK_STAGES
    for name in ("INVALIDATE_COLD", "INVALIDATE_RANKS", "INVALIDATE_CLOCK", "INVALIDATE_SIZE",
                 "INVALIDATE_REALIGNED", "INVALIDATE_FALLBACK"):
        assert getattr(C, name) == getattr(J, name)
    assert C.WindowBuildStats().snapshot() == J.WindowBuildStats().snapshot()


def test_tick_profile_accumulates_and_snapshots():
    p = TickProfile()
    p.note_tick()
    p.note_stage("step_time", "build", 100)
    p.note_stage("step_time", "build", 50)
    p.note_stage("step_time", "diagnose", 7)
    p.bump("diag_cache_hits")
    p.bump("rule_evals", 3)
    snap = p.snapshot()
    assert snap["ticks"] == 1
    assert snap["stage_ns"]["step_time"] == {"build": 150, "diagnose": 7}
    assert snap["counters"] == {"diag_cache_hits": 1, "rule_evals": 3}


def test_a_version_idle_tick_runs_zero_rules(tmp_path, monkeypatch):
    monkeypatch.setenv("TRACEML_VECTOR_DIAGNOSIS", "1")
    db = tmp_path / "t.sqlite"
    w, feed = seed_session(db)
    computer = LiveComputer(db, window_steps=50)
    try:
        p1 = computer.payload()
        assert p1["step_time"]["diagnosis"] is not None
        prof = computer.store.tick_profile
        misses = prof.counters.get("diag_cache_misses", 0)
        assert misses > 0  # the first tick diagnosed every domain
        feed.send(0, "model_stats", [model_stats_row()], sampler="step_time")
        assert w.force_flush()
        evals, hits = sum(rule_eval_counts().values()), prof.counters.get("diag_cache_hits", 0)
        p2 = computer.payload()
        assert p2 is not p1  # step_time went dirty: the payload was rebuilt
        assert p2["step_time"]["diagnosis"] is p1["step_time"]["diagnosis"]  # ... with no rule run
        assert p2["views"]["step_time"].efficiency is not None
        assert sum(rule_eval_counts().values()) == evals
        assert prof.counters["diag_cache_hits"] > hits and prof.counters["diag_cache_misses"] == misses
        assert prof.counters["window_memo_hits"] >= 1 and prof.counters["view_table_hits"] >= 1
    finally:
        computer.close()
        w.finalize()


def test_new_rows_invalidate_the_diagnosis_cache(tmp_path):
    db = tmp_path / "t.sqlite"
    w, feed = seed_session(db)
    computer = LiveComputer(db, window_steps=50)
    try:
        d1 = computer.payload()["step_time"]["diagnosis"]
        rng = np.random.default_rng(999)
        for rank in (0, 1):
            feed.send(rank, "step_time", [step_row(s, rng) for s in range(25, 30)])
        assert w.force_flush()
        evals = sum(rule_eval_counts().values())
        assert computer.payload()["step_time"]["diagnosis"] is not d1
        assert sum(rule_eval_counts().values()) > evals
    finally:
        computer.close()
        w.finalize()


def test_the_switch_turns_the_diagnosis_cache_off(tmp_path, monkeypatch):
    monkeypatch.setenv("TRACEML_VECTOR_DIAGNOSIS", "0")
    db = tmp_path / "t.sqlite"
    w, feed = seed_session(db)
    computer = LiveComputer(db, window_steps=50)
    try:
        p1 = computer.payload()
        feed.send(0, "model_stats", [model_stats_row()], sampler="step_time")
        assert w.force_flush()
        p2 = computer.payload()
        assert p2["step_time"]["diagnosis"] is not p1["step_time"]["diagnosis"]  # re-diagnosed
        counters = computer.store.tick_profile.counters
        assert not {"diag_cache_hits", "diag_cache_misses", "window_memo_hits"} & set(counters)
    finally:
        computer.close()
        w.finalize()


def test_the_profile_reaches_window_build_stats(tmp_path):
    db = tmp_path / "t.sqlite"
    w, _ = seed_session(db)
    computer = LiveComputer(db, window_steps=50)
    try:
        computer.payload()
        stats = computer.store.window_build_stats()
        prof = stats["tick_profile"]
        assert prof["ticks"] >= 1 and set(prof["stage_ns"]["store"]) == {"refresh"}
        for domain, stages in (("step_time", {"build", "diagnose", "attribute", "view"}),
                               ("memory", {"build", "diagnose", "attribute", "view"})):
            assert set(prof["stage_ns"][domain]) == stages <= set(TICK_STAGES)
        assert prof["counters"]["rule_evals"] > 0 and prof["counters"]["diag_cache_misses"] > 0
        assert stats["step_time"]["full_rebuilds"] == 1 and stats["step_time"]["invalidations"] == {"cold_start": 1}
        json.dumps(stats)  # the meta fragment serializes it
    finally:
        computer.close()
        w.finalize()


def test_the_publisher_records_the_serialize_stage(tmp_path):
    db = tmp_path / "t.sqlite"
    w, _ = seed_session(db)
    pub = SessionPublisher(db, "s", window_steps=50)
    try:
        pub.poll(force=True)
        prof = pub._computer.store.tick_profile.snapshot()
        ser = {d for d, stages in prof["stage_ns"].items() if "serialize" in stages}
        assert {"step_time", "memory", "meta", "diagnosis"} <= ser
    finally:
        pub.close()
        w.finalize()


def test_the_dashboard_window_build_has_the_jax_shape(tmp_path):
    """The port's and the JAX engine's dashboard payloads on one database:
    ``window_build`` with the same cache domains and stats keys, and a tick
    profile with the same keys, the same stages per shared domain and the
    same counters (less what the port does not have yet)."""
    from traceml_tpu.renderers import serving as jax_serving
    from traceml_tpu.renderers.web_payload import build_web_payload as jax_build

    db = tmp_path / "t.sqlite"
    w, _ = seed_session(db)
    try:
        ours = build_web_payload(db, "s")["window_build"]
        theirs = jax_build(db, "s")["window_build"]
    finally:
        serving.close_all_publishers()
        jax_serving.close_all_publishers()
        w.finalize()
    assert set(ours) == set(theirs) - JAX_ONLY_DOMAINS
    assert ours["step_time"].keys() == theirs["step_time"].keys()
    assert ours["step_time"]["invalidations"] == theirs["step_time"]["invalidations"] == {"cold_start": 1}
    prof, jprof = ours["tick_profile"], theirs["tick_profile"]
    assert prof.keys() == jprof.keys() and prof["ticks"] == jprof["ticks"] == 1
    assert set(prof["stage_ns"]) == set(jprof["stage_ns"]) - JAX_ONLY_DOMAINS
    for domain, stages in prof["stage_ns"].items():
        assert set(stages) == set(jprof["stage_ns"][domain]), domain
    # the JAX collectives domain also reads the step-time window memo (a
    # hit on the first tick) and memoizes its own result
    assert set(prof["counters"]) <= set(jprof["counters"])
    assert set(jprof["counters"]) - set(prof["counters"]) <= JAX_ONLY_COUNTERS | {"window_memo_hits",
                                                                                "domain_memo_hits"}


def _payload_bytes(db):
    payload = build_web_payload(db, "s")
    payload.pop("ts")
    payload.pop("window_build", None)  # timings differ run to run
    serving.close_all_publishers()
    return json.dumps(payload, sort_keys=True).encode()


def test_the_vector_switch_changes_no_served_byte(tmp_path, monkeypatch):
    """Twin sessions, one served with the switch off, one with it on."""
    payloads = {}
    for name, flag in (("off", "0"), ("on", "1")):
        db = tmp_path / name / "t.sqlite"
        db.parent.mkdir()
        seed_session(db)[0].finalize()
        monkeypatch.setenv("TRACEML_VECTOR_DIAGNOSIS", flag)
        payloads[name] = _payload_bytes(db)
    assert payloads["off"] == payloads["on"]


def test_the_incremental_switch_changes_no_served_byte_but_the_counters(tmp_path, monkeypatch):
    """With ``TRACEML_INCR_WINDOW=0`` the payload has no ``window_build``
    key at all, and is otherwise the default one, byte for byte."""
    payloads = {}
    for name, flag in (("off", "0"), ("on", "1")):
        db = tmp_path / name / "t.sqlite"
        db.parent.mkdir()
        seed_session(db)[0].finalize()
        monkeypatch.setenv("TRACEML_INCR_WINDOW", flag)
        payload = build_web_payload(db, "s")
        serving.close_all_publishers()
        assert ("window_build" in payload) == (flag == "1")
        payloads[name] = _payload_bytes(db)
    assert payloads["off"] == payloads["on"]
