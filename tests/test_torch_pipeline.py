"""The pipeline schedule (``parallel/pipeline.py``) held against the JAX
package's ``traceml_tpu/parallel/pipeline.py``.

The port's side runs in spawned gloo worlds of 2 and 4 ranks
(``tests/torch_spmd.py``), one stage a rank; the JAX side in this
process on 2 and 4 of the 8 virtual CPU devices.  The stages are JAX's
``init_linear_stages`` (``linear_stage_apply``: tanh(x @ w + b)), stacked
and passed through ``stage_params_from_jax``; the microbatches come from
a numpy seed.

* On {stage: 2} and {stage: 4}, 6 microbatches: every rank's output
  against the sequential stack of the stages (rtol 2e-4, atol 2e-5, the
  JAX test's bounds) and against JAX's ``make_pipeline_fn`` (the same);
  the gradients of ``mean((out − y)²)`` with respect to the stacked
  ``w`` and ``b`` against ``jax.grad`` through JAX's schedule and
  against the sequential stack's, within 1e-5 relative Frobenius (f32;
  a closing all-reduce that summed the gradients too would be S× off).
* Under ``patch_dist_collectives`` the schedule's hops are recorded:
  ``n_micro + S − 2`` sends-and-receives (``batch_isend_irecv``, p2p; the
  last tick's hop is skipped) and the closing all-reduce in the forward,
  as many p2p in the backward.
* ``make_pipeline_train_step`` (SGD, lr 0.1, 4 microbatches) for 20
  steps: the loss strictly decreasing, as in JAX's
  ``test_pipeline_train_step_learns``, and each step's loss within 1e-5
  relative of JAX's.
* The two ``ValueError`` texts (a stacked stage dim that is not the
  axis size, a microbatch count the schedule was not built for) are
  JAX's; ``stage_params_from_jax`` raises on a leaf left over or missing.
* ``run --nprocs 2`` of ``dev/moe_pipeline_script.py --tiny`` over gloo:
  the MoE on {expert: 2}, then the pipeline on {stage: 2}, 20 traced
  steps each: exit 0, the manifest completed/ok, one step row a step and
  rank (1 to 40), each workload's loss falling on each rank, 0 flash
  launches.
"""

import json
import os
import re
import socket
import sqlite3
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch_spmd_tasks as tasks  # noqa: E402
from test_torch_seq_parallel import _jmesh, rel_fro  # noqa: E402
from torch_spmd import Worlds  # noqa: E402
from traceml_tpu.parallel import pipeline as jax_pp  # noqa: E402
from traceml_tpu_torch.models.convert import stage_params_from_jax  # noqa: E402

WIDTH = 8
GRAD_BOUND = 1e-5


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = Worlds(tmp_path_factory.mktemp("spmd_pp"))
    yield w
    w.close()


def _case(n_stages, n_micro, seed=0):
    stages = jax_pp.init_linear_stages(n_stages, width=WIDTH, rng=jax.random.PRNGKey(seed))
    stacked = jax_pp.stack_stage_params(stages)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n_micro, 4, WIDTH)).astype(np.float32)
    y = (0.5 * x).astype(np.float32)
    return stages, stacked, x, y


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sequential(stacked, x):
    out = x
    for i in range(stacked["w"].shape[0]):
        out = jnp.tanh(out @ stacked["w"][i] + stacked["b"][i])
    return out


@pytest.mark.parametrize("n_stages", [2, 4], ids=["stage2", "stage4"])
def test_pipeline_matches_sequential_and_jax(worlds, n_stages):
    n_micro = 6
    _, stacked, x, y = _case(n_stages, n_micro)
    jmesh = _jmesh({"stage": n_stages})
    placed = jax.tree_util.tree_map(jax.device_put, stacked, jax_pp.stage_param_shardings(stacked, jmesh))
    fn = jax_pp.make_pipeline_fn(jax_pp.linear_stage_apply, jmesh, n_micro)
    with jmesh:
        want_out = np.asarray(jax.jit(fn)(placed, jnp.asarray(x)))
        want = jax.grad(lambda p: jnp.mean((fn(p, jnp.asarray(x)) - y) ** 2))(placed)
    seq_out = np.asarray(_sequential(stacked, jnp.asarray(x)))
    seq = jax.grad(lambda p: jnp.mean((_sequential(p, jnp.asarray(x)) - y) ** 2))(stacked)
    np.testing.assert_allclose(want_out, seq_out, rtol=2e-4, atol=2e-5)
    hops = n_micro + n_stages - 2
    mb_bytes = 4 * WIDTH * 4
    for out, grads, forward, backward in worlds(n_stages).run(tasks.pipeline_run, {"stage": n_stages},
                                                              _np_tree(stacked), x, y, n_micro):
        np.testing.assert_allclose(out, seq_out, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(out, want_out, rtol=2e-4, atol=2e-5)
        for name in ("w", "b"):
            assert rel_fro(grads[name], np.asarray(want[name])) <= GRAD_BOUND, name
            assert rel_fro(grads[name], np.asarray(seq[name])) <= GRAD_BOUND, name
        # each hop sends one microbatch activation and receives one
        assert forward == [("p2p", 2 * mb_bytes)] * hops + [("all_reduce", n_micro * mb_bytes)]
        assert backward == [("p2p", 2 * mb_bytes)] * hops


@pytest.mark.parametrize("n_stages", [2, 4], ids=["stage2", "stage4"])
def test_pipeline_train_step_learns_as_jax(worlds, n_stages):
    n_micro, steps, lr = 4, 20, 0.1
    _, stacked, x, y = _case(n_stages, n_micro, seed=2)
    jmesh = _jmesh({"stage": n_stages})
    placed = jax.tree_util.tree_map(jax.device_put, stacked, jax_pp.stage_param_shardings(stacked, jmesh))
    init, train_step = jax_pp.make_pipeline_train_step(jax_pp.linear_stage_apply, jmesh, n_micro, learning_rate=lr)
    opt_state = init(placed)
    step = jax.jit(train_step)
    want = []
    with jmesh:
        for _ in range(steps):
            placed, opt_state, metrics = step(placed, opt_state, jnp.asarray(x), jnp.asarray(y))
            want.append(float(metrics["loss"]))
    for losses in worlds(n_stages).run(tasks.pipeline_train, {"stage": n_stages}, _np_tree(stacked), x, y,
                                       n_micro, steps, lr):
        assert all(b < a for a, b in zip(losses, losses[1:])), losses
        assert max(abs(a - b) / b for a, b in zip(losses, want)) <= 1e-5, (losses, want)


def test_value_errors_are_the_jax_ones(worlds):
    n_micro = 4
    _, stacked, x, _ = _case(2, n_micro)
    jmesh = _jmesh({"stage": 2})
    fn = jax_pp.make_pipeline_fn(jax_pp.linear_stage_apply, jmesh, n_micro)
    want = []
    for params, micro in (({k: jnp.concatenate([v, v[:1]]) for k, v in stacked.items()}, x), (stacked, x[:-1])):
        with pytest.raises(ValueError) as info:
            fn(params, jnp.asarray(micro))
        want.append(str(info.value))
    assert worlds(2).run(tasks.pipeline_errors, {"stage": 2}, _np_tree(stacked), x, n_micro) == [want] * 2


def test_converter_raises_on_a_leaf_left_over_or_missing():
    _, stacked, _, _ = _case(2, 4)
    tree = _np_tree(stacked)
    with pytest.raises(ValueError, match="stray"):
        stage_params_from_jax({**tree, "stray": np.zeros(2, np.float32)})
    with pytest.raises(KeyError):
        stage_params_from_jax({"w": tree["w"]})


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_moe_pipeline_script_traced_on_two_ranks(tmp_path):
    steps = 20
    repo = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if not k.startswith(("TRACEML_", "RANK", "WORLD_", "MASTER_"))}
    env.update({"PYTHONPATH": str(repo), "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())})
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary", "--nprocs", "2",
         "--logs-dir", str(tmp_path / "logs"), "--sampler-interval", "0.25", "--finalize-timeout", "40",
         str(repo / "traceml_tpu_torch" / "dev" / "moe_pipeline_script.py"), "--", "--device", "cpu", "--tiny",
         "--steps", str(steps)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    session = next(p for p in (tmp_path / "logs").iterdir() if p.is_dir())
    manifest = json.loads((session / "manifest.json").read_text())
    assert (manifest["status"], manifest["telemetry_status"]) == ("completed", "ok")
    assert (session / "final_summary.json").exists()
    conn = sqlite3.connect(session / "telemetry.sqlite")
    try:
        rows = conn.execute("SELECT global_rank, step FROM step_time_samples ORDER BY global_rank, step").fetchall()
    finally:
        conn.close()
    assert rows == [(r, s) for r in (0, 1) for s in range(1, 2 * steps + 1)]
    for name in ("moe", "pipeline"):
        losses = re.findall(rf"{name} over 2 rank\(s\): {steps} steps .*loss first ([0-9.]+) last ([0-9.]+) "
                            r"finite=True", proc.stdout)
        assert len(losses) == 2 and all(float(last) < float(first) for first, last in losses), (name, losses)
    assert proc.stdout.count("flash_attention.launches 0") == 2
