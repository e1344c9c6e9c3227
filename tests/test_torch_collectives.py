"""The collectives domain: the port against the JAX package on the same
inputs.

* Capture: ``normalize_op`` over every JAX spelling (equal) and over
  NCCL's (``nccl:all_reduce``, ``ncclDevKernel_AllReduce_*``, which JAX
  reads as ``other``); ``extract_collectives_from_trace_events``;
  ``bytes_of`` (a torch tensor's dtype named as JAX names it,
  ``"float32"``); ``instrument_collective`` (the records and the
  ``collective`` phase in the step rows); ``patch_dist_collectives``
  (idempotent, passes calls made while compiling through unrecorded);
  ``aggregate_collective_records``; the kill switch.
* The SQLite writer's ``collectives_samples`` and ``mesh_topology`` rows,
  row for row against the JAX writer.
* The windows: the scalar fold, the full columnar build and the
  incremental cache, tick by tick, equal to each other and to the JAX
  scalar fold and columnar build, exactly (every float sum of the scalar
  arm is a ``+=`` left fold, which ``np.add.at`` and ``np.cumsum``
  reproduce).
* The three rules and their vector arms on seeded windows, against the
  JAX scalar arm; the one place the JAX vector arm folds otherwise (its
  fp32 payload mean, ``np.cumsum`` against the scalar ``sum()``, which is
  compensated since CPython 3.12) pinned beside the port's ``sum_fold``.
* The report's collectives section and card, the live views and the
  dashboard's collectives, diagnosis and meta fragments on one database,
  against the JAX report and computer.
* ``inspect``'s derived ``overlap_efficiency`` column.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_advice import port_advice
from tests.test_torch_final_report import assert_same
from tests.test_torch_sqlite import dump, step_rows, wire_payloads
from traceml_tpu.aggregator.sqlite_writer import SQLiteWriter as JaxWriter
from traceml_tpu.diagnostics.collectives import vector as jax_vector
from traceml_tpu.diagnostics.collectives.api import diagnose_collectives_window as jax_diagnose
from traceml_tpu.instrumentation import collectives as jax_coll
from traceml_tpu.samplers import collectives_sampler as jax_sampler
from traceml_tpu.telemetry.envelope import normalize_telemetry_envelope as jax_normalize
from traceml_tpu.utils import columnar as jax_columnar
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.diagnostics.collectives import vector
from traceml_tpu_torch.diagnostics.collectives.api import diagnose_collectives_window
from traceml_tpu_torch.instrumentation import collectives as coll
from traceml_tpu_torch.samplers import collectives_sampler as sampler
from traceml_tpu_torch.telemetry.envelope import SenderIdentity, normalize_telemetry_envelope, rows_to_columns
from traceml_tpu_torch.utils import columnar

ENGINE_SWITCHES = ("TRACEML_COLUMNAR_WINDOW", "TRACEML_INCR_WINDOW", "TRACEML_VECTOR_DIAGNOSIS")

# -- capture ---------------------------------------------------------------------

JAX_SPELLINGS = sorted(jax_coll._OP_ALIASES) + list(jax_coll.OP_KINDS) + [
    "all-reduce.17", "all-gather-start.3", "reduce-scatter.1", "collective-permute-done",
    "all-to-all.4", "fusion.3", "", None, "AllReduce", "  PSUM  ", "sendrecv", "recv-done.2", "copy.1",
]

NCCL_SPELLINGS = {
    "nccl:all_reduce": "all_reduce",
    "nccl:_all_gather_base": "all_gather",
    "nccl:all_gather_into_tensor_coalesced": "all_gather",
    "nccl:reduce_scatter": "reduce_scatter",
    "nccl:_reduce_scatter_base": "reduce_scatter",
    "nccl:all_to_all": "all_to_all",
    "nccl:send": "p2p",
    "nccl:recv": "p2p",
    "nccl:barrier": "other",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL": "all_reduce",
    "ncclKernel_AllReduce_RING_LL_Sum_float": "all_reduce",
    "ncclDevKernel_AllGather_RING_LL": "all_gather",
    "ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL": "reduce_scatter",
    "ncclDevKernel_SendRecv": "p2p",
    "ncclDevKernel_Generic": "other",
}


def test_op_vocabularies_agree():
    assert coll.OP_KINDS == jax_coll.OP_KINDS == columnar.COLLECTIVE_OPS == jax_columnar.COLLECTIVE_OPS
    assert coll._OP_ALIASES == jax_coll._OP_ALIASES
    assert set(coll._DIST_COLLECTIVES.values()) <= set(coll.OP_KINDS)
    assert set(coll._DIST_COLLECTIVES.values()) == set(jax_coll._LAX_COLLECTIVES.values())


@pytest.mark.parametrize("name", JAX_SPELLINGS, ids=repr)
def test_normalize_op_equals_jax_on_its_spellings(name):
    assert coll.normalize_op(name) == jax_coll.normalize_op(name)


@pytest.mark.parametrize("name", sorted(NCCL_SPELLINGS))
def test_normalize_op_reads_nccl_spellings(name):
    assert coll.normalize_op(name) == NCCL_SPELLINGS[name]
    assert jax_coll.normalize_op(name) == "other"  # the spellings the port adds


def _events():
    return [
        {"name": "all-reduce.17", "dur": 1500.0, "ts": 2.0e6, "args": {"bytes_accessed": 4096, "dtype": "float32",
                                                                         "group_size": 8, "exposed_us": 400.0}},
        {"name": "all-gather-start.3", "dur": 800.0, "ts": 2.1e6, "args": {"bytes_accessed": 1024, "step": 7}},
        {"name": "fusion.3", "dur": 50.0, "ts": 2.2e6},
        {"name": "collective-permute.1", "dur": 200.0, "ts": 2.3e6, "args": {"exposed_us": 900.0}},
        {"name": "reduce-scatter.2", "dur": "bad", "ts": 2.4e6},
        {"name": "psum", "dur": 0.0, "ts": 2.5e6, "args": {"group_size": 0, "bytes_accessed": -5}},
    ]


def test_extract_collectives_from_trace_events_equals_jax():
    ours = coll.extract_collectives_from_trace_events(_events(), default_step=5)
    theirs = jax_coll.extract_collectives_from_trace_events(_events(), default_step=5)
    assert ours == theirs and len(ours) == 4
    nccl = [{"name": "ncclDevKernel_AllReduce_Sum_f32_RING_LL", "dur": 2000.0, "ts": 3.0e6,
             "args": {"bytes_accessed": 700551168, "dtype": "torch.float32"}}]
    (rec,) = coll.extract_collectives_from_trace_events(nccl, default_step=2)
    assert (rec["op"], rec["dtype"], rec["bytes"], rec["duration_ms"]) == ("all_reduce", "float32", 700551168, 2.0)


def test_bytes_of_names_dtypes_as_jax_does():
    import torch

    shapes = [((3, 4), "float32"), ((10,), "bfloat16"), ((2, 2, 2), "int32"), ((5,), "float16")]
    for shape, dtype in shapes:
        t = torch.zeros(shape, dtype=getattr(torch, dtype))
        a = jnp.zeros(shape, dtype=getattr(jnp, dtype))
        assert coll.bytes_of(t) == jax_coll.bytes_of(a) == (int(np.prod(shape)) * t.element_size(), dtype)
    tree = {"w": [torch.zeros(100, dtype=torch.float32), torch.zeros(30, dtype=torch.bfloat16)], "n": 3}
    jtree = {"w": [jnp.zeros(100, dtype=jnp.float32), jnp.zeros(30, dtype=jnp.bfloat16)], "n": 3}
    assert coll.bytes_of(tree) == jax_coll.bytes_of(jtree) == (460, "float32")
    assert coll.bytes_of(None) == (0, "")
    # the gradient buffer of the full-width train step: 175,137,792 f32 values
    assert coll.bytes_of(torch.empty(175_137_792, dtype=torch.float32, device="meta")) == (700_551_168, "float32")


def test_record_collective_and_its_kill_switch_equal_jax(monkeypatch):
    kwargs = dict(nbytes=4096, dtype="float32", group_size=4, duration_ms=3.0, exposed_ms=5.0, step=9, ts=1.0)
    for enabled in ("1", "0"):
        monkeypatch.setenv("TRACEML_COLLECTIVES", enabled)
        coll.GLOBAL_COLLECTIVES_QUEUE.drain()
        jax_coll.GLOBAL_COLLECTIVES_QUEUE.drain()
        for op, over in (("psum", {}), ("all-gather.2", {"exposed_ms": None, "overlapped": True}),
                         ("nccl:all_reduce", {"exposed_ms": None})):
            args = dict(kwargs, **over)
            assert coll.record_collective(op, **args) == jax_coll.record_collective(op, **args) == (enabled == "1")
        ours, theirs = coll.GLOBAL_COLLECTIVES_QUEUE.drain(), jax_coll.GLOBAL_COLLECTIVES_QUEUE.drain()
        if enabled == "1":
            assert ours[:2] == theirs[:2] and ours[0]["exposed_ms"] == 3.0 and ours[1]["exposed_ms"] == 0.0
            assert ours[2]["op"] == "all_reduce" and theirs[2]["op"] == "other"
        else:
            assert ours == theirs == []


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("ts", "duration_ms", "exposed_ms")}


def test_instrument_collective_records_and_times_the_collective_phase():
    import torch

    import traceml_tpu.sdk.state as jax_state
    from traceml_tpu.samplers import step_time_sampler as jax_step_sampler
    from traceml_tpu.sdk.instrumentation import trace_step as jax_trace_step
    from traceml_tpu.utils import timing as jax_timing
    from traceml_tpu_torch.samplers import step_time_sampler as step_sampler
    from traceml_tpu_torch.sdk import state as torch_state
    from traceml_tpu_torch.sdk.instrumentation import trace_step
    from traceml_tpu_torch.utils import timing as T

    coll.GLOBAL_COLLECTIVES_QUEUE.drain()
    jax_coll.GLOBAL_COLLECTIVES_QUEUE.drain()
    jax_timing.GLOBAL_STEP_QUEUE.drain()
    jst = jax_state.reset_state_for_tests()
    jsync = jax_coll.instrument_collective(lambda x: [x * 0.5, x], op="psum", state=jst, group_size=4)
    for _ in range(3):
        with jax_trace_step(jst):
            jsync(jnp.ones((64, 16), jnp.float32))
    jrecs = jax_coll.GLOBAL_COLLECTIVES_QUEUE.drain()
    jss = jax_step_sampler.StepTimeSampler()
    jss.drain()
    jrows = jss.db.tail(jax_step_sampler.TABLE)

    tst = torch_state.reset_state_for_tests(device="cpu")
    try:
        tsync = coll.instrument_collective(lambda x: [x * 0.5, x], op="psum", state=tst, group_size=4)
        assert tsync._traceml_collective_instrumented
        for _ in range(3):
            with trace_step(tst):
                tsync(torch.ones((64, 16), dtype=torch.float32))
        trecs = coll.GLOBAL_COLLECTIVES_QUEUE.drain()
        tss = step_sampler.StepTimeSampler()
        tss.drain()
        trows = tss.db.tail(step_sampler.TABLE)
    finally:
        torch_state.reset_state_for_tests()
    assert [_strip(r) for r in trecs] == [_strip(r) for r in jrecs]
    assert [(r["step"], r["op"], r["dtype"], r["bytes"], r["group_size"]) for r in trecs] == [
        (s, "all_reduce", "float32", 8192, 4) for s in (1, 2, 3)]
    assert all(r["exposed_ms"] == r["duration_ms"] >= 0.0 for r in trecs)
    assert [sorted(r["events"]) for r in trows] == [sorted(r["events"]) for r in jrows]
    assert all(T.COLLECTIVE_TIME in r["events"] for r in trows)


@pytest.fixture
def dist_world_1():
    """A one-rank gloo group, and the ``torch.distributed`` entry points
    restored afterwards."""
    import torch.distributed as dist

    saved = {name: getattr(dist, name) for name in coll._DIST_COLLECTIVES if hasattr(dist, name)}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    coll._dist_patched = False
    try:
        yield dist
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
        coll._dist_patched = False
        dist.destroy_process_group()
        coll.GLOBAL_COLLECTIVES_QUEUE.drain()


def test_patch_dist_collectives_is_idempotent_and_skips_compiling(dist_world_1, monkeypatch):
    import torch

    dist = dist_world_1
    coll.GLOBAL_COLLECTIVES_QUEUE.drain()
    assert coll.patch_dist_collectives() and coll.patch_dist_collectives()
    wrapped = dist.all_reduce
    assert wrapped._traceml_collective_instrumented
    assert coll.patch_dist_collectives() and dist.all_reduce is wrapped  # no second layer
    t = torch.ones(1000, dtype=torch.float32)
    dist.all_reduce(t)
    out = [torch.empty(10, dtype=torch.bfloat16)]
    dist.all_gather(out, torch.ones(10, dtype=torch.bfloat16))
    buf = torch.empty(8, dtype=torch.float32)
    dist.all_gather_into_tensor(buf, torch.ones(8, dtype=torch.float32))
    recs = coll.GLOBAL_COLLECTIVES_QUEUE.drain()
    assert [(r["op"], r["dtype"], r["bytes"], r["group_size"]) for r in recs] == [
        ("all_reduce", "float32", 4000, 1), ("all_gather", "bfloat16", 20, 1), ("all_gather", "float32", 32, 1)]
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    dist.all_reduce(t)
    assert coll.GLOBAL_COLLECTIVES_QUEUE.drain() == []
    monkeypatch.setenv("TRACEML_COLLECTIVES", "0")
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: False)
    dist.all_reduce(t)
    assert coll.GLOBAL_COLLECTIVES_QUEUE.drain() == []


def _raw_records(seed, n_steps=20):
    rng = np.random.default_rng(seed)
    recs = []
    for step in range(1, n_steps + 1):
        for _ in range(int(rng.integers(1, 4))):
            op = str(rng.choice(["all_reduce", "all_gather", "p2p", "weird"]))
            recs.append({"step": step, "ts": 1.7e9 + step, "op": op,
                         "dtype": str(rng.choice(["float32", "bfloat16"])),
                         "bytes": int(rng.integers(0, 1 << 22)), "group_size": int(rng.integers(1, 9)),
                         "duration_ms": float(rng.uniform(0.1, 9.0)), "exposed_ms": float(rng.uniform(0.0, 0.1))})
    recs.insert(3, {"op": "all_reduce"})  # malformed: no step
    return recs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_collective_records_equals_jax(seed):
    recs = _raw_records(seed)
    assert sampler.aggregate_collective_records(recs) == jax_sampler.aggregate_collective_records(recs)


def test_sampler_is_registered_behind_the_kill_switch(monkeypatch, tmp_path):
    from traceml_tpu_torch.runtime.identity import RuntimeIdentity
    from traceml_tpu_torch.runtime.sampler_registry import build_samplers
    from traceml_tpu_torch.runtime.settings import TraceMLSettings

    settings = TraceMLSettings(logs_dir=tmp_path)
    monkeypatch.delenv("TRACEML_COLLECTIVES", raising=False)
    names = [s.name for s in build_samplers(settings, RuntimeIdentity())]
    assert names == ["system", "process", "step_time", "step_memory", "collectives"]
    assert next(s for s in build_samplers(settings, RuntimeIdentity()) if s.name == "collectives") \
        ._spec.drain_on_recording_stop
    monkeypatch.setenv("TRACEML_COLLECTIVES", "0")
    assert "collectives" not in [s.name for s in build_samplers(settings, RuntimeIdentity())]
    coll.GLOBAL_COLLECTIVES_QUEUE.drain()
    for rec in _raw_records(3, 5):
        coll.GLOBAL_COLLECTIVES_QUEUE.put(rec)
    s = sampler.CollectivesSampler()
    s.drain()
    rows = s.db.tail(sampler.TABLE)
    assert [{k: v for k, v in r.items() if k != "timestamp"} for r in rows] == \
        jax_sampler.aggregate_collective_records(_raw_records(3, 5))


# -- windows ---------------------------------------------------------------------


def coll_rows(seed, n_steps, *, comm_ms=6.0, exposed_frac=0.05, fp32_bytes=8 << 20, skip_every=0, extra_ops=True,
              slow=1.0):
    """One rank's (step, op, dtype) aggregate rows as the sampler forms
    them: an fp32 gradient all-reduce every step, and on some steps an
    all-gather and a p2p hop; ``skip_every`` leaves steps out (ragged
    participation)."""
    rng = np.random.default_rng(seed)
    rows = []
    for step in range(1, n_steps + 1):
        if skip_every and step % skip_every == 0:
            continue
        dur = float(comm_ms * slow * rng.uniform(0.9, 1.1))
        rows.append({"step": step, "timestamp": 1.7e9 + step * 0.05, "op": "all_reduce", "dtype": "float32",
                     "count": 1, "bytes": fp32_bytes, "group_size": 4, "duration_ms": dur,
                     "exposed_ms": float(dur * exposed_frac * rng.uniform(0.8, 1.2))})
        if extra_ops and step % 3 == 0:
            d = float(rng.uniform(0.5, 2.0))
            rows.append({"step": step, "timestamp": 1.7e9 + step * 0.05, "op": "all_gather", "dtype": "bfloat16",
                         "count": 2, "bytes": int(rng.integers(1 << 10, 1 << 20)), "group_size": 4,
                         "duration_ms": d, "exposed_ms": float(d * rng.uniform(0.0, 1.0))})
        if extra_ops and step % 5 == 0:
            rows.append({"step": step, "timestamp": 1.7e9 + step * 0.05, "op": "p2p", "dtype": "float32",
                         "count": 1, "bytes": 4096, "group_size": 2, "duration_ms": 0.0, "exposed_ms": 0.0})
    return rows


def _plain(mod, w):
    return mod.collectives_window_to_plain(w)


def _rings(mod, rank_rows, cap=None):
    out = {}
    for r, rows in rank_rows.items():
        ring = out[r] = mod.CollectivesColumns(cap or len(rows))
        for row in rows:
            ring.append(row)
    return out


def _rank_rows(seed):
    return {
        0: coll_rows(seed, 90),
        1: coll_rows(seed + 1, 90, skip_every=7),
        3: coll_rows(seed + 2, 85, slow=1.4, exposed_frac=0.4),
    }


@pytest.mark.parametrize("max_steps", [200, 40])
@pytest.mark.parametrize("seed", [0, 5])
def test_scalar_columnar_and_jax_windows_are_equal(seed, max_steps):
    rank_rows = _rank_rows(seed)
    scalar = _plain(columnar, columnar.build_collectives_window_rows(rank_rows, max_steps))
    assert scalar == _plain(jax_columnar, jax_columnar.build_collectives_window_rows(rank_rows, max_steps))
    assert scalar == _plain(columnar, columnar.build_columnar_collectives_window(_rings(columnar, rank_rows),
                                                                                   max_steps))
    assert scalar == _plain(jax_columnar, jax_columnar.build_columnar_collectives_window(
        _rings(jax_columnar, rank_rows), max_steps))
    # step 90: ranks 0 and 1 (rank 3 stopped at 85), ragged participation
    assert scalar["steps"][-1] == 90 and scalar["per_step"]["allreduce_fp32_bytes"][-1] == (8 << 20) * 2


@pytest.mark.parametrize("cap", [None, 120], ids=["no_eviction", "ring_evicts"])
def test_incremental_cache_equals_the_scalar_fold_tick_by_tick(cap):
    rank_rows = _rank_rows(11)
    cache = columnar.CollectivesWindowCache()
    rings = {r: columnar.CollectivesColumns(cap or 400) for r in rank_rows}
    held = {r: [] for r in rank_rows}
    cursor = {r: 0 for r in rank_rows}
    rng = np.random.default_rng(3)
    ticks = 0
    while any(cursor[r] < len(rows) for r, rows in rank_rows.items()):
        for r, rows in rank_rows.items():
            k = int(rng.integers(0, 7))
            for row in rows[cursor[r]:cursor[r] + k]:
                rings[r].append(row)
                held[r].append(row)
            cursor[r] += k
            if cap:
                held[r] = held[r][-cap:]
        live = {r: c for r, c in rings.items() if len(c)}
        if not live:
            continue
        got = _plain(columnar, cache.build(live, 50))
        want = columnar.build_collectives_window_rows({r: rows for r, rows in held.items() if rows}, 50)
        assert got == _plain(columnar, want), ticks
        ticks += 1
    stats = cache.stats.snapshot()
    assert stats["incr_ticks"] > 0 and ticks > 20


def test_a_flagged_ring_falls_back_to_the_scalar_fold():
    rows = coll_rows(0, 30)
    ring = columnar.CollectivesColumns(64)
    for row in rows[:10] + [dict(rows[2], step=1)] + rows[10:]:  # an out-of-order step
        ring.append(row)
    assert not ring.columnar_ok
    with pytest.raises(columnar.ColumnarFallback):
        columnar.build_columnar_collectives_window({0: ring}, 50)
    with pytest.raises(columnar.ColumnarFallback):
        columnar.engine_collectives_window({0: ring}, {}, 50)


# -- rules ----------------------------------------------------------------------


def _window(rank_rows, max_steps=200):
    return columnar.build_collectives_window_rows(rank_rows, max_steps)


SCENARIOS = {
    # exposed comm ≈ 40% of a 20 ms step: COMM_BOUND
    "comm_bound": (lambda: {r: coll_rows(20 + r, 60, comm_ms=8.0, exposed_frac=1.0, extra_ops=False)
                            for r in range(2)}, 20.0),
    # comm hidden behind compute; a large stable fp32 payload: ALLREDUCE_QUANTIZABLE only
    "healthy_quantizable": (lambda: {0: coll_rows(30, 60, fp32_bytes=700_551_168)}, 117.0),
    # rank 3 overlaps far worse than its peers: POOR_OVERLAP
    "poor_overlap": (lambda: {0: coll_rows(40, 60, exposed_frac=0.45, extra_ops=False),
                              1: coll_rows(41, 60, exposed_frac=0.45, extra_ops=False),
                              2: coll_rows(42, 60, exposed_frac=0.45, extra_ops=False),
                              3: coll_rows(43, 60, exposed_frac=1.0, extra_ops=False)}, 200.0),
    # too few steps for a verdict
    "insufficient": (lambda: {0: coll_rows(50, 3)}, 20.0),
    # no step-time denominator: COMM_BOUND cannot fire
    "no_step_time": (lambda: {r: coll_rows(60 + r, 60, comm_ms=8.0, exposed_frac=1.0) for r in range(2)}, None),
}


@pytest.mark.parametrize("mode", ["summary", "live"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_rules_and_vector_arms_equal_the_jax_scalar_arm(monkeypatch, name, mode):
    build, step_ms = SCENARIOS[name]
    rank_rows = build()
    monkeypatch.setenv("TRACEML_VECTOR_DIAGNOSIS", "0")
    theirs = port_advice(jax_diagnose(jax_columnar.build_collectives_window_rows(rank_rows, 200), mode=mode,
                                      step_time_ms=step_ms).to_dict())
    scalar = diagnose_collectives_window(_window(rank_rows), mode=mode, step_time_ms=step_ms).to_dict()
    monkeypatch.delenv("TRACEML_VECTOR_DIAGNOSIS")
    vec = diagnose_collectives_window(_window(rank_rows), mode=mode, step_time_ms=step_ms).to_dict()
    assert scalar == vec == theirs
    kinds = {i["kind"] for i in vec["issues"]}
    expected = {
        "comm_bound": {"COMM_BOUND"},
        "healthy_quantizable": {"ALLREDUCE_QUANTIZABLE"},
        "poor_overlap": {"POOR_OVERLAP"},
        "insufficient": {"INSUFFICIENT_COLLECTIVES_DATA"},
        "no_step_time": set(),
    }[name]
    assert expected <= kinds and ("COMM_BOUND" in kinds) == (name == "comm_bound")
    if name == "healthy_quantizable":
        (q,) = [i for i in vec["issues"] if i["kind"] == "ALLREDUCE_QUANTIZABLE"]
        assert q["evidence"]["fp32_allreduce_mib_per_step"] == 668.1


def test_vector_arm_stats_equal_jax():
    w = _window(SCENARIOS["poor_overlap"][0]())
    assert vector.poor_overlap_stats(w.per_step, w.per_rank, 0.15) == \
        jax_vector.poor_overlap_stats(w.per_step, w.per_rank, 0.15)
    series = w.per_step["allreduce_fp32_bytes"]
    assert vector.fp32_allreduce_stats(series) == jax_vector.fp32_allreduce_stats(series)


def test_fp32_mean_folds_as_sum_where_the_jax_arm_does_not():
    series = [float(2 ** 53), 1.0, 1.0, 0.0]
    nz = [v for v in series if v > 0]
    n, mean, pop = vector.fp32_allreduce_stats(series)
    assert (n, pop) == (3, nz) and mean == sum(nz) / 3
    jn, jmean, _ = jax_vector.fp32_allreduce_stats(series)
    if sys.version_info >= (3, 12):  # sum() is compensated: the JAX np.cumsum arm drifts from it
        assert jmean != sum(nz) / 3 and jmean == float(np.cumsum(nz)[-1]) / 3


# -- writer rows, the report, the live views -------------------------------------


def _coll_payloads(rank_coll, seq0=1000, chunk=16, columnar_wire=True):
    out = []
    for rank, rows in rank_coll.items():
        ident = SenderIdentity(session_id="s", global_rank=rank, local_rank=rank, world_size=len(rank_coll),
                               local_world_size=len(rank_coll), hostname=f"host-{rank}", pid=100 + rank)
        for k, i in enumerate(range(0, len(rows), chunk)):
            meta = ident.to_meta()
            meta.update({"schema": 2 if columnar_wire else 1, "sampler": "collectives", "timestamp": 1.7e9,
                         "seq": seq0 + k})
            part = rows[i:i + chunk]
            out.append({"meta": meta, "body": {"tables": {
                "collectives": rows_to_columns(part) if columnar_wire else part}}})
    return out


def _mesh_payload(rank, world, spec_axes, coords):
    meta = SenderIdentity(session_id="s", global_rank=rank, local_rank=rank % 2, world_size=world,
                          local_world_size=2, node_rank=rank // 2, hostname=f"host-{rank // 2}",
                          pid=100 + rank).to_meta()
    meta.pop("seq", None)
    meta["sampler"] = "mesh_topology"
    return {"meta": meta, "body": {"tables": {"mesh_topology": [{
        "timestamp": 1.7e9, "source": "mesh", "axes_json": json.dumps(spec_axes),
        "coords_json": json.dumps(coords)}]}}}


AXES_4 = [{"name": "data", "size": 2, "kind": "dcn"}, {"name": "fsdp", "size": 2, "kind": "ici"}]


def _all_payloads(name, ranks=4, mesh=True):
    build, _ = SCENARIOS["poor_overlap" if name == "poor_overlap" else "comm_bound"]
    rank_coll = build() if ranks == 4 or name != "poor_overlap" else build()
    rank_coll = {r: rows for r, rows in rank_coll.items() if r < ranks}
    slow = {2, 3} if name == "poor_overlap" else set()  # one side of the node boundary
    payloads = wire_payloads({r: step_rows(10 + r, 60, 0.5, 18.0 * (1.5 if r in slow else 1.0))
                              for r in range(ranks)}, {})
    payloads += _coll_payloads(rank_coll)
    if mesh:
        payloads += [_mesh_payload(r, ranks, AXES_4, [r // 2, r % 2]) for r in range(ranks)]
    return payloads


@pytest.mark.parametrize("wire", ["schema2", "schema1"])
def test_writer_rows_equal_jax(tmp_path, wire):
    payloads = _coll_payloads(_rank_rows(3), columnar_wire=wire == "schema2")
    payloads += [_mesh_payload(r, 4, AXES_4, [r // 2, r % 2]) for r in range(4)]
    for name, writer, normalize in (("port", SQLiteWriter, normalize_telemetry_envelope),
                                    ("jax", JaxWriter, jax_normalize)):
        w = writer(tmp_path / f"{name}.sqlite")
        w.start()
        for p in payloads:
            assert w.ingest(normalize(json.loads(json.dumps(p))))
        assert w.finalize(timeout=30)
    for table in ("collectives_samples", "mesh_topology"):
        cols, rows = dump(tmp_path / "port.sqlite", table)
        assert (cols, rows) == dump(tmp_path / "jax.sqlite", table)
        assert rows
    assert len(dump(tmp_path / "port.sqlite", "collectives_samples")[1]) == sum(len(r) for r in _rank_rows(3).values())


def _write_db(db, payloads):
    w = SQLiteWriter(db)
    w.start()
    for p in payloads:
        assert w.ingest(normalize_telemetry_envelope(p))
    assert w.finalize(timeout=30)


@pytest.mark.parametrize("name", ["comm_bound", "poor_overlap"])
def test_report_collectives_section_card_and_mesh_equal_jax(tmp_path, name):
    from traceml_tpu.reporting.final import generate_summary as jax_generate_summary
    from traceml_tpu.runtime.settings import TraceMLSettings as JaxSettings
    from traceml_tpu_torch.reporting.final import generate_summary
    from traceml_tpu_torch.runtime.settings import TraceMLSettings

    db = tmp_path / "telemetry.sqlite"
    _write_db(db, _all_payloads(name))
    out = {}
    for who, gen, settings in (("jax", jax_generate_summary, JaxSettings(session_id="s", mode="summary")),
                               ("port", generate_summary, TraceMLSettings(session_id="s", mode="summary"))):
        session = tmp_path / who / "s"
        session.mkdir(parents=True)
        assert gen(db_path=db, session_dir=session, settings=settings)
        out[who] = (json.loads((session / "final_summary.json").read_text()),
                    (session / "final_summary.txt").read_text())
    (ours, text), (theirs, jtext) = out["port"], out["jax"]
    sec = ours["sections"]["collectives"]
    assert sec["status"] == "OK" and sec["card"]
    assert_same(sec, port_advice(theirs["sections"]["collectives"]), "collectives")
    # the step-time findings (the window's global rollup picks its median
    # rank among near-ties, which the JAX engine's cumsum fold and the
    # port's sum() fold may break differently: test_torch_final_report.py)
    for key in ("diagnosis", "issues"):
        assert_same(ours["sections"]["step_time"][key], port_advice(theirs["sections"]["step_time"][key]), key)
    assert_same(ours["primary_diagnosis"], port_advice(theirs["primary_diagnosis"]), "primary_diagnosis")
    assert ours["meta"]["topology"] == theirs["meta"]["topology"]
    assert ours["meta"]["topology"]["mesh"]["axes"] == AXES_4
    kinds = {i["kind"] for i in sec["issues"]}
    assert ("COMM_BOUND" if name == "comm_bound" else "POOR_OVERLAP") in kinds
    assert "Collectives (compute/comm overlap):" in text and sec["card"].splitlines()[0] in jtext
    if name == "poor_overlap":
        # the slow side's step-time finding is attributed through the mesh
        attributed = [i for i in ours["sections"]["step_time"]["issues"] if i.get("attribution")]
        assert attributed and attributed[0]["attribution"]["ranks"] == [2, 3]
    prof = ours["meta"]["window_build"]["tick_profile"]["stage_ns"]["collectives"]
    assert set(prof) == {"diagnose", "attribute"}
    assert "collectives" in ours["meta"]["window_build"]


def test_live_views_and_fragments_equal_jax(tmp_path, monkeypatch):
    from traceml_tpu.renderers import web_payload as jax_web
    from traceml_tpu.renderers.compute import LiveComputer as JaxComputer
    from traceml_tpu_torch.renderers import web_payload as web
    from traceml_tpu_torch.renderers.compute import LiveComputer

    session = tmp_path / "session"
    session.mkdir()
    db = session / "telemetry.sqlite"
    _write_db(db, _all_payloads("comm_bound"))
    for flag in ENGINE_SWITCHES:
        monkeypatch.setenv(flag, "0")
    jax_c = JaxComputer(db)
    port_c = LiveComputer(db)
    try:
        theirs = jax_c.payload()
        for flag in ENGINE_SWITCHES:
            monkeypatch.delenv(flag)
        ours = port_c.payload()
        assert ours["views"]["collectives"].as_dict() == theirs["views"]["collectives"].as_dict()
        assert ours["collectives"]["diagnosis"].to_dict() == \
            port_advice(theirs["collectives"]["diagnosis"].to_dict())
        assert ours["collectives"]["diagnosis"].diagnosis.kind == "COMM_BOUND"
        assert ours["topology"] == theirs["topology"]
        for frag in ("collectives", "meta"):
            got = web.build_fragment(frag, ours, session="s", db_path=db)
            want = jax_web.build_fragment(frag, theirs, session="s", db_path=db)
            assert got == port_advice(want), frag
        got = web.build_fragment("diagnosis", ours, session="s", db_path=db)
        want = port_advice(jax_web.build_fragment("diagnosis", theirs, session="s", db_path=db))
        assert [f["kind"] for f in got["findings"]] == [f["kind"] for f in want["findings"]]
        assert "COMM_BOUND" in [f["kind"] for f in got["findings"]]
        assert web.FRAGMENT_DEPS["collectives"] == jax_web.FRAGMENT_DEPS["collectives"]
        # the CLI header's mesh strip
        from rich.console import Console

        from traceml_tpu_torch.renderers.cli.dashboard import dashboard

        console = Console(width=200, record=True)
        console.print(dashboard(ours, "s"))
        assert "mesh: data×2 (dcn) · fsdp×2 · 2 hosts" in console.export_text()
        # an idle tick returns the same payload object
        assert port_c.payload() is ours
    finally:
        jax_c.close()
        port_c.close()


def test_inspect_derives_overlap_efficiency(tmp_path, capsys):
    from traceml_tpu_torch.database.database_writer import DatabaseWriter
    from traceml_tpu_torch.launcher.inspect_cmd import run_inspect
    from traceml_tpu_torch.utils import msgpack_codec

    rows = coll_rows(0, 4, extra_ops=False) + [
        {"step": 5, "timestamp": 1.7e9, "op": "p2p", "dtype": "float32", "count": 1, "bytes": 8, "group_size": 2,
         "duration_ms": 0.0, "exposed_ms": 0.0}]
    writer = DatabaseWriter("collectives", tmp_path / "data")
    ident = SenderIdentity(session_id="s", global_rank=0, hostname="h", pid=1).to_meta()
    ident.update({"sampler": "collectives", "seq": 1, "schema": 2})
    writer.append_envelope(msgpack_codec.preencode({"meta": ident, "body": {"tables": {
        "collectives": rows_to_columns(rows)}}}))
    writer.flush(force=True)
    assert run_inspect(tmp_path / "data", limit=50, domain="collectives") == 0
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [p["overlap_efficiency"] for p in printed] == [
        round(1.0 - r["exposed_ms"] / r["duration_ms"], 4) if r["duration_ms"] > 0 else 1.0 for r in rows]


def test_trace_sources_drain_and_survive_a_raising_source():
    def bad():
        raise RuntimeError("capture backend down")

    coll.clear_trace_sources()
    try:
        coll.register_trace_source(lambda: _events()[:2])
        coll.register_trace_source(bad)
        coll.register_trace_source(lambda: None)
        assert coll.drain_trace_sources() == _events()[:2]
        coll.GLOBAL_COLLECTIVES_QUEUE.drain()
        s = sampler.CollectivesSampler()
        s.drain()
        rows = s.db.tail(sampler.TABLE)
        assert [(r["op"], r["count"]) for r in rows] == [("all_reduce", 1), ("all_gather", 1)]
    finally:
        coll.clear_trace_sources()


def _edge_rows():
    base = coll_rows(7, 12, extra_ops=False)
    zero = [dict(r, duration_ms=0.0, exposed_ms=0.0) for r in base[:4]]  # zero-comm steps: efficiency 1.0
    weird = [dict(base[5], op="ring_hop"), dict(base[6], op=None)]  # unknown ops fold into "other"
    return {0: zero + base[4:5] + weird + base[7:], 1: [r for r in coll_rows(8, 12) if r["step"] > 4]}


@pytest.mark.parametrize("flaw", [None, "out_of_order", "bool_step", "float_bytes", "exposed_over_duration",
                                  "dtype_vocabulary"])
def test_edge_rows_fold_as_jax_and_flag_what_the_rings_cannot_hold(flaw):
    rank_rows = _edge_rows()
    rows = rank_rows[1]
    if flaw == "out_of_order":
        rows.insert(5, dict(rows[0]))
    elif flaw == "bool_step":
        rows.append(dict(rows[-1], step=True))
    elif flaw == "float_bytes":
        rows[3] = dict(rows[3], bytes=1.5)
    elif flaw == "exposed_over_duration":
        rows[3] = dict(rows[3], exposed_ms=rows[3]["duration_ms"] + 1.0)
    elif flaw == "dtype_vocabulary":
        rows.extend(dict(rows[-1], dtype=f"t{i}") for i in range(70))
    if flaw in (None, "dtype_vocabulary", "float_bytes", "exposed_over_duration"):
        want = _plain(jax_columnar, jax_columnar.build_collectives_window_rows(rank_rows, 50))
        assert _plain(columnar, columnar.build_collectives_window_rows(rank_rows, 50)) == want
    ours, theirs = _rings(columnar, rank_rows), _rings(jax_columnar, rank_rows)
    assert [c.columnar_ok for c in ours.values()] == [c.columnar_ok for c in theirs.values()]
    assert all(c.columnar_ok for c in ours.values()) == (flaw is None)
    if flaw is None:
        w = columnar.build_columnar_collectives_window(ours, 50)
        assert _plain(columnar, w) == want
        assert w.per_step["overlap_efficiency"][:4] == [1.0] * 4 and "other" in w.per_op


def test_snapshot_store_window_equals_jax_under_every_switch(tmp_path, monkeypatch):
    from traceml_tpu.reporting.snapshot_store import LiveSnapshotStore as JaxStore
    from traceml_tpu_torch.reporting.snapshot_store import LiveSnapshotStore

    db = tmp_path / "t.sqlite"
    _write_db(db, _coll_payloads(_rank_rows(21)))
    want = None
    for switches in ({}, {"TRACEML_INCR_WINDOW": "0"}, {"TRACEML_COLUMNAR_WINDOW": "0"}):
        for flag in ENGINE_SWITCHES:
            monkeypatch.delenv(flag, raising=False)
        for k, v in switches.items():
            monkeypatch.setenv(k, v)
        store, jax_store = LiveSnapshotStore(db, window_steps=30), JaxStore(db, window_steps=30)
        try:
            store.refresh()
            jax_store.refresh()
            assert store.has_collectives_rows() and store.collectives_rows() == jax_store.collectives_rows()
            got = _plain(columnar, store.build_collectives_window())
            assert got == _plain(jax_columnar, jax_store.build_collectives_window())
            want = want or got
            assert got == want and got["n_steps"] == 30
        finally:
            store.close()
            jax_store.close()
    assert "collectives" in LiveSnapshotStore(db).versions
