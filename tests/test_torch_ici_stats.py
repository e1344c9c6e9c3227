"""The stat all-gather (``parallel/ici_stats.py``, ``parallel/ici_telemetry.py``,
``enable_ici_stats``) held against the JAX package.

The port gathers over one world of 4 spawned gloo ranks
(``tests/torch_spmd.py``); the JAX side runs its single-controller
``aggregate_many`` on 4 of the 8 virtual CPU devices.  Stat vectors and
step events come from a numpy seed.

* The gathered matrix (f32, exact), its row order (mesh-linear: row i is
  participant i) and ``rank_skew`` equal JAX's ``aggregate_many`` on the
  same vectors, over {data: 2, fsdp: 2} (all axes, and the ``fsdp`` axis
  alone), {fsdp: 4} and {context: 4}; ``aggregate`` of each rank's own
  vector gives the same matrix.
* ``batch_to_stat_vector`` and ``matrix_to_rank_rows`` equal JAX's on the
  same events (exactly: the same float operations).
* ``IciTelemetryHook`` on a fresh ``TraceState`` of every rank: 24
  steps, a gather every step, rank 2's compute 1.5× slower, rank 3
  flushing no batch at step 5 (its row all zeros but the step): the
  matrices, the rows, ``rank_skew`` and ``diagnose()`` equal those JAX's
  hook builds from ``aggregate_many`` of JAX's vectors of the same
  steps; ``uninstall`` removes both observers.
* The deliberate divergence: with the host ahead of the device, the
  port's hook carries the readiness edge across steps as the step-time
  sampler does, so its ``step_ms`` is the stored row's; JAX's vector
  (``prev_last_ready=None``) reads the step longer.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

import torch_spmd_tasks as tasks  # noqa: E402
from torch_spmd import World  # noqa: E402
from traceml_tpu.parallel import ici_stats as jax_stats  # noqa: E402
from traceml_tpu.parallel import ici_telemetry as jax_tele  # noqa: E402
from traceml_tpu.parallel import mesh as jax_mesh  # noqa: E402
from traceml_tpu.utils import timing as JT  # noqa: E402
from traceml_tpu_torch.parallel import ici_stats, ici_telemetry  # noqa: E402
from traceml_tpu_torch.samplers.step_time_sampler import _aggregate_step  # noqa: E402
from traceml_tpu_torch.sdk.state import TraceState  # noqa: E402
from traceml_tpu_torch.utils import timing as T  # noqa: E402

STEPS = 24  # the live diagnosis needs 20 aligned steps


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("spmd4"))
    yield w
    w.close()


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return jax_mesh.make_mesh(shape, devices=jax.devices()[:n])


def _vectors(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{f: float(np.float32(rng.uniform(0, 200))) for f in ici_stats.STAT_FIELDS} | {"step": 7.0}
            for _ in range(n)]


@pytest.mark.parametrize("shape,axis", [({"data": 2, "fsdp": 2}, None), ({"data": 2, "fsdp": 2}, "fsdp"),
                                        ({"fsdp": 4}, None), ({"context": 4}, None)],
                         ids=["data2-fsdp2", "data2-fsdp2-axis-fsdp", "fsdp4", "context4"])
def test_gathered_matrix_and_skew_match_jax_aggregate_many(world, shape, axis):
    jagg = jax_stats.IciStatAggregator(_jmesh(shape), axis=axis)
    vectors = _vectors(jagg.n_participants)
    want = jagg.aggregate_many([jax_stats.StatVector(v) for v in vectors])
    want_skew = jagg.rank_skew(want, "step_ms")
    for n, many, own, skew in world.run(tasks.stat_gather, shape, vectors, axis):
        assert n == jagg.n_participants
        assert many.dtype == np.float32 and np.array_equal(many, want)
        assert np.array_equal(own, want)
        assert skew == want_skew
    assert [v.values for v in ici_stats.gathered_to_stat_vectors(want)] == [
        v.values for v in jax_stats.gathered_to_stat_vectors(want)]


# -- step events ---------------------------------------------------------------------


def step_events(rank, step, slow=1.0, t0=100.0, gap=0.3):
    """``(name, step, cpu_start, cpu_end, device ready or None)`` of one
    train step: input, h2d, forward, backward, optimizer and the step
    envelope; the device finishes each phase before the next host step."""
    t = t0 + step * gap + rank * 1e-3
    fwd, bwd, opt = 0.02 * slow, 0.05 * slow, 0.01
    return [
        (JT.DATALOADER_NEXT, step, t, t + 0.004, None),
        (JT.H2D_TIME, step, t + 0.004, t + 0.005, t + 0.006),
        (JT.FORWARD_TIME, step, t + 0.006, t + 0.010, t + 0.006 + fwd),
        (JT.BACKWARD_TIME, step, t + 0.010, t + 0.015, t + 0.006 + fwd + bwd),
        (JT.OPTIMIZER_STEP, step, t + 0.015, t + 0.018, t + 0.006 + fwd + bwd + opt),
        (JT.STEP_TIME, step, t, t + 0.019, t + 0.006 + fwd + bwd + opt),
    ]


def _events(pkg, spec):
    out = []
    for name, step, start, end, ready in spec:
        ev = pkg.TimeEvent(name, step)
        ev.cpu_start, ev.cpu_end = start, end
        if ready is not None:
            ev.marker = pkg.DeviceMarker([], dispatched_at=ready)
        out.append(ev)
    return out


def test_batch_vector_and_rank_rows_match_jax():
    spec = step_events(1, 3, slow=1.3)
    got = ici_telemetry.batch_to_stat_vector(T.StepTimeBatch(3, _events(T, spec)))
    want = jax_tele.batch_to_stat_vector(JT.StepTimeBatch(3, _events(JT, spec)))
    assert got.values == want.values and np.array_equal(got.to_array(), want.to_array())
    matrix = np.stack([got.to_array(), np.zeros(ici_stats.N_FIELDS, np.float32)])
    assert ici_telemetry.matrix_to_rank_rows(matrix, 5.0) == jax_tele.matrix_to_rank_rows(matrix, 5.0)


def _plan():
    """Each rank's steps; rank 2 slow, rank 3 without a batch at step 5."""
    return {r: [(s, [] if (r, s) == (3, 5) else step_events(r, s, 1.5 if r == 2 else 1.0))
                for s in range(1, STEPS + 1)] for r in range(4)}


def test_hook_matches_the_jax_hook_on_the_same_steps(world):
    shape = {"data": 2, "fsdp": 2}
    plan = _plan()
    results = world.run(tasks.hook_run, shape, 1, plan)
    jagg = jax_stats.IciStatAggregator(_jmesh(shape))
    jhook = jax_tele.IciTelemetryHook(aggregator=jagg, every_n_steps=1, window_steps=200)
    for i in range(STEPS):
        vecs = []
        for r in range(4):
            step, spec = plan[r][i]
            vecs.append(jax_tele.batch_to_stat_vector(JT.StepTimeBatch(step, _events(JT, spec))) if spec
                        else jax_stats.StatVector({"step": float(step)}))
        jhook.ingest_matrix(jagg.aggregate_many(vecs))
    want_issues = [(i.kind, i.severity, i.summary, tuple(i.ranks)) for i in jhook.diagnose().issues]
    strip = {r: [{k: v for k, v in row.items() if k != "timestamp"} for row in rows]
             for r, rows in jhook.rank_rows().items()}
    for gathers, last, rows, issues, skew, removed, n_wait, n_gather in results:
        assert gathers == STEPS and n_wait == n_gather == STEPS and removed
        assert np.array_equal(last, jhook.last_matrix)
        empty = rows[3][4]  # rank 3 flushed no batch at step 5: zeros, and the step
        assert empty["step"] == 5 and empty["events"][T.STEP_TIME]["device_ms"] == 0.0
        assert {r: [{k: v for k, v in row.items() if k != "timestamp"} for row in rr]
                for r, rr in rows.items()} == strip
        assert skew == jhook.rank_skew("step_ms")
        assert issues == want_issues
    assert any(2 in ranks for *_, ranks in want_issues), want_issues  # the slow rank is named


class _OneRank:
    """A stand-in aggregator of one participant (no collective)."""

    n_participants = 1

    def aggregate(self, vec):
        return vec.to_array()[None, :]

    def rank_skew(self, gathered, field):
        return {}


def test_the_hook_carries_the_readiness_edge_as_the_sampler_does():
    state = TraceState(device="cpu")
    hook = ici_telemetry.IciTelemetryHook(aggregator=_OneRank(), every_n_steps=2).install(state)
    specs = []
    for step in (1, 2):
        spec = step_events(0, step, gap=0.05)  # the host starts step 2 before step 1's device work ends
        specs.append(spec)
        for ev in _events(T, spec):
            state.buffer.add(ev)
        state.flush_step(step)
    hook.uninstall()
    assert not state.on_batch_flushed and not state.on_step_flushed
    row1, edge = _aggregate_step(_events(T, specs[0]), None)
    row2, _ = _aggregate_step(_events(T, specs[1]), edge)
    stored = row2["events"][T.STEP_TIME]["device_ms"]
    assert hook.rank_rows()[0][0]["events"][T.STEP_TIME]["device_ms"] == float(np.float32(stored))
    jax_ms = jax_tele.batch_to_stat_vector(JT.StepTimeBatch(2, _events(JT, specs[1]))).values["step_ms"]
    assert jax_ms > stored
