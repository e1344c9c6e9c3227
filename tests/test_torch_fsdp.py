"""FSDP2 parameter sharding and the {context: 2} sequence-parallel train
step, held against the JAX package, on 2 spawned gloo ranks.

One world of 2 ranks (``tests/torch_spmd.py``, module-scoped) runs the
port's side; the JAX side runs ``init_train_state(mesh=)`` and the jit'd
``make_train_step`` on 2 of the 8 virtual CPU devices, with the weights
passed through ``params_from_jax`` and the batches from a numpy seed
(``test_torch_seq_parallel.jax_train_run``).

* The tiny DecoderLM's AdamW step against JAX's, f32: the losses of 3
  steps within 1e-5 relative, the first step's gradients and the
  parameters after the steps within 1e-5 relative Frobenius (the f32
  bounds of ``tests/test_torch_train_step.py``):
  - {context: 2} with ring and with Ulysses attention, FSDP2 sharding
    over the flattened fsdp × context mesh (JAX shards over ``fsdp``
    only; the parameters are replicated across ``context`` there);
  - {context: 2} ring without FSDP2 (the gradients averaged by
    ``average_gradients``, the train step's ``grad_sync``);
  - {fsdp: 2} dense (the batch split over ``fsdp``) and {data: 2} dense
    (HSDP: ``data`` replicates, the shard dim has size 1);
  - {tensor: 2} dense: the model tensor-parallel, each rank holding its
    slices (gathered to their whole shapes for the comparison), alone
    and under FSDP2 on its shard group of one rank
    (``tests/test_torch_tensor_parallel.py`` has the 4-rank meshes).
  And in bf16, {context: 2} Ulysses with FSDP2: the losses within 5e-4
  relative, every parameter's update within 0.2 relative Frobenius (the
  bf16 bounds of ``tests/test_torch_train_step.py``).
* FSDP2's layout: every parameter a DTensor sharded on the dim
  ``param_shardings`` gives ``fsdp`` (dim 0 where JAX replicates), over
  the flattened fsdp × context mesh; on {data: 2} (HSDP, a shard group of
  one rank) replicated over ``data`` and on dim 0, where the dim is moot;
  AdamW's moments DTensors too.
* Remat under FSDP2 (each block checkpointed, the blocks re-gathered in
  the recompute): the step equals the step without remat within 1e-6.
* ``estimate_step_flops`` on each rank's shard within 2% of the analytic
  count over that shard (the global count over the data-parallel ×
  context degree).
* ``run --nprocs 2`` of ``dev/train_script.py`` with ring attention on
  {context: 2}, ``--fsdp`` and ``--ici-stats 2`` over gloo: the run's
  gates the CPU can hold (exit 0, manifest completed/ok, one row a step
  and rank, both ranks finished, the loss falling, ``flops_per_step``
  within 2% of the analytic shard count in the report, both ranks' mesh
  rows), the gathered rows' ``step_ms`` the stored rows' within f32
  rounding, and the rollup tiers' ``axis:context`` grain rows beside the
  ``rank`` and ``host`` ones.
"""

import json
import math
import os
import re
import socket
import sqlite3
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import torch_spmd_tasks as tasks  # noqa: E402
from test_torch_seq_parallel import TRAIN_BOUND, jax_train_run, rel_fro, train_errors  # noqa: E402
from torch_spmd import World  # noqa: E402
from traceml_tpu_torch.models import transformer as tf  # noqa: E402
from traceml_tpu_torch.models.convert import params_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "traceml_tpu_torch" / "dev" / "train_script.py"
BF16_BOUND = {"loss": 5e-4, "update": 0.2}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("spmd2"))
    yield w
    w.close()


@pytest.mark.parametrize("shape,impl,fsdp", [
    ({"context": 2}, "ring", True), ({"context": 2}, "ulysses", True), ({"context": 2}, "ring", False),
    ({"fsdp": 2}, "dense", True), ({"data": 2}, "dense", True), ({"tensor": 2}, "dense", False),
    ({"tensor": 2}, "dense", True),
], ids=["context2-ring-fsdp", "context2-ulysses-fsdp", "context2-ring-grad_sync", "fsdp2-dense", "data2-dense-hsdp",
        "tensor2-dense", "tensor2-dense-fsdp1"])
def test_train_step_matches_jax(world, shape, impl, fsdp):
    run = jax_train_run(shape, impl)
    results = world.run(tasks.train_step, shape, impl, fsdp, run["start"], run["batches"])
    assert results[0][0] == results[1][0]  # both ranks hold the global loss
    errors = train_errors(run, results[0])
    assert all(errors[k] <= TRAIN_BOUND[k] for k in errors), errors


def test_bf16_train_step_matches_jax(world):
    shape = {"context": 2}
    run = jax_train_run(shape, "ulysses", "bfloat16")
    losses, _, end = world.run(tasks.train_step, shape, "ulysses", True, run["start"], run["batches"], "bfloat16")[0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, run["losses"]))
    start = {n: t.numpy() for n, t in params_from_jax(run["start"]).items()}
    update_rel = max(rel_fro(end[n] - start[n], run["end"][n].numpy() - start[n]) for n in start)
    assert loss_rel <= BF16_BOUND["loss"] and update_rel <= BF16_BOUND["update"], (loss_rel, update_rel)


@pytest.mark.parametrize("shape", [{"context": 2}, {"data": 2}], ids=["context2", "data2-hsdp"])
def test_fsdp2_shards_each_parameter_on_the_jax_fsdp_dim(world, shape):
    layout, specs, moment = world.run(tasks.fsdp_layout, shape)[0]
    axes = ["data", "fsdp", "tensor", "context"]
    group = shape.get("context", 1)  # the shard group: fsdp × context
    assert moment == "DTensor"
    for name, (placements, local, full, mesh) in layout.items():
        fsdp = specs[name][axes.index("fsdp")]
        # JAX's fsdp dim, or dim 0 where JAX replicates and on a one-rank group
        dim = int(fsdp[2:-1]) if fsdp.startswith("S(") and group > 1 else 0
        assert placements == (["R"] if "data" in shape else []) + [f"S({dim})"], (name, placements)
        assert "fsdp_context" in mesh, mesh
        want = list(full)
        want[dim] = math.ceil(full[dim] / group)
        assert list(local) == want, (name, local, full)


def test_remat_under_fsdp2_equals_no_remat(world):
    run = jax_train_run({"context": 2}, "ring")
    plain = world.run(tasks.train_step, {"context": 2}, "ring", True, run["start"], run["batches"])[0]
    remat = world.run(tasks.train_step, {"context": 2}, "ring", True, run["start"], run["batches"], "float32",
                      True)[0]
    assert max(abs(a - b) / abs(b) for a, b in zip(remat[0], plain[0])) <= 1e-6
    assert max(rel_fro(remat[2][n], plain[2][n]) for n in plain[2]) <= 1e-6


def analytic_flops(batch: int, seq: int) -> float:
    """6 × matmul parameters × tokens + 12·B·H·S²·D a layer (full S×S
    attention), for the tiny model."""
    cfg = tf.ModelConfig.tiny()
    hd = cfg.head_dim
    per_layer = 2 * cfg.hidden * cfg.n_heads * hd + 2 * cfg.hidden * cfg.n_kv_heads * hd + 3 * cfg.hidden * cfg.ffn_hidden
    params = cfg.n_layers * per_layer + cfg.hidden * cfg.vocab_size
    return 6.0 * params * batch * seq + 12 * batch * cfg.n_heads * seq * seq * hd * cfg.n_layers


@pytest.mark.parametrize("shape,impl,fsdp,degree", [
    ({"fsdp": 2}, "dense", True, 2), ({"context": 2}, "ring", True, 2), ({"context": 2}, "ulysses", True, 2),
    ({"context": 2}, "ring", False, 2),
], ids=["fsdp2-dense", "context2-ring", "context2-ulysses", "context2-ring-unsharded"])
def test_estimate_step_flops_counts_the_shard(world, shape, impl, fsdp, degree):
    tokens = np.random.default_rng(3).integers(0, 256, (4, 65)).astype(np.int64)
    want = analytic_flops(4, 64) / degree
    for got in world.run(tasks.step_flops, shape, impl, fsdp, tokens):
        assert abs(got - want) / want <= 0.02, (got, want)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_run_with_ring_fsdp_and_the_stat_gather(tmp_path):
    steps, every = 40, 2
    logs = tmp_path / "logs"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("TRACEML_", "RANK", "WORLD_", "MASTER_"))}
    env.update({"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())})
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary", "--nprocs", "2",
         "--logs-dir", str(logs), "--sampler-interval", "0.25", "--finalize-timeout", "40",
         "--summary-window-rows", "4", str(SCRIPT), "--", "--device", "cpu", "--tiny", "--steps", str(steps),
         "--mesh-shape", "context=2", "--attention-impl", "ring", "--fsdp", "--ici-stats", str(every)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    session = next(p for p in logs.iterdir() if p.is_dir())
    manifest = json.loads((session / "manifest.json").read_text())
    summary = json.loads((session / "final_summary.json").read_text())
    assert (manifest["status"], manifest["telemetry_status"]) == ("completed", "ok")
    liveness = summary["sections"]["liveness"]
    assert {r: v["state"] for r, v in liveness["ranks"].items()} == {"0": "finished", "1": "finished"}
    eff = summary["sections"]["step_time"]["global"]["efficiency"]
    want = analytic_flops(2, 64) / 2  # --tiny: (2, 65) tokens, each rank half the sequence
    assert abs(eff["flops_per_step"] - want) / want <= 0.02, (eff["flops_per_step"], want)
    # both ranks write to the launcher's stdout: their lines may interleave
    losses = re.findall(r"loss first ([0-9.]+) last ([0-9.]+)", proc.stdout)
    assert len(losses) == 2 and all(float(last) < float(first) for first, last in losses), losses
    conn = sqlite3.connect(session / "telemetry.sqlite")
    try:
        mesh = conn.execute("SELECT global_rank, coords_json FROM mesh_topology ORDER BY global_rank").fetchall()
        stored = {(r, s): json.loads(ev)["_traceml_internal:step_time"]["cpu_ms"]
                  for r, s, ev in conn.execute("SELECT global_rank, step, events_json FROM step_time_samples")}
        grains = {(g, k) for g, k in conn.execute("SELECT DISTINCT grain, grain_key FROM rollup_samples_10s")}
        raw = conn.execute("SELECT global_rank, COUNT(*) FROM step_time_samples GROUP BY global_rank").fetchall()
        folded = conn.execute("SELECT grain_key, SUM(count) FROM rollup_samples_10s WHERE grain='rank' AND "
                              "source_table='step_time_samples' AND metric='step_ms' GROUP BY grain_key").fetchall()
    finally:
        conn.close()
    assert [(r, json.loads(c)) for r, c in mesh] == [(0, [0, 0, 0, 0]), (1, [0, 0, 0, 1])]
    assert {r: n for r, n in raw} and all(dict(raw)[r] + dict(folded)[str(r)] == steps for r in (0, 1))
    assert {("axis:context", "0"), ("axis:context", "1"), ("rank", "0"), ("rank", "1")} <= grains
    assert any(g == "host" for g, _ in grains)
    decoder = json.JSONDecoder()
    gathers = [decoder.raw_decode(proc.stdout, m.end())[0] for m in re.finditer(r"stat_gather ", proc.stdout)]
    assert len(gathers) == 2 and gathers[0]["rows"] == gathers[1]["rows"]
    stat = gathers[0]
    assert stat["gathers"] == steps // every and stat["shape"] == [2, 12]
    assert sorted((r, s) for r, s, _ in stat["rows"]) == sorted(
        (r, s) for r in (0, 1) for s in range(every, steps + 1, every))
    for r, s, ms in stat["rows"]:  # pruned rows are in the tiers, not in step_time_samples
        if (r, s) in stored:
            assert math.isclose(ms, stored[(r, s)], rel_tol=2.0 ** -23), (r, s, ms, stored[(r, s)])
