"""Tensor parallelism on the DecoderLM train step, held against the JAX
package, on 4 spawned gloo ranks.

One world of 4 ranks (``tests/torch_spmd.py``, module-scoped) runs the
port's side; the JAX side runs ``init_train_state(mesh=)`` and the jit'd
``make_train_step`` on 4 of the 8 virtual CPU devices, GSPMD sharding
the same layout (``param_shardings``), with the weights passed through
``params_from_jax`` and the batches from a numpy seed
(``test_torch_seq_parallel.jax_train_run``).  The {tensor: 2} mesh alone
runs in ``tests/test_torch_fsdp.py``'s 2-rank world.

* The tiny DecoderLM's AdamW step, f32: the losses of 3 steps within
  1e-5 relative, the first step's gradients and the parameters after the
  steps (each gathered over ``tensor`` to its whole shape) within 1e-5
  relative Frobenius, the f32 bounds of ``tests/test_torch_train_step.py``:
  - {fsdp: 2, tensor: 2}: each rank's slices sharded over ``fsdp`` by
    FSDP2;
  - {data: 2, tensor: 2}: the gradients averaged over ``data`` alone by
    the train step's ``grad_sync`` (both tensor ranks' slices have the
    same shapes, so an average across ``tensor`` would mix them and move
    every update), and under HSDP;
  - {tensor: 2, context: 2}: Ulysses (FSDP2) and ring attention on each
    rank's heads; and Ulysses with 6 heads, whose 3 local heads do not
    divide by the context axis: JAX leaves the heads whole there, and the
    port gathers them over ``tensor``.
* ``gradient_group``: the ranks that differ only on ``data``, never on
  ``tensor``.
* Each rank holds 1/T of every sharded weight (``wq wk wv wo w_gate
  w_up w_down lm_head`` and the embedding) and the whole RMSNorm scales.
* Heads that do not divide by ``tensor`` ({tensor: 4} with 2 kv heads)
  raise ``ValueError`` naming the fix.  JAX leaves the heads unsharded
  there instead (a divergence, CHANGES.md).
"""

import pytest

pytest.importorskip("torch")

import torch_spmd_tasks as tasks  # noqa: E402
from test_torch_seq_parallel import TRAIN_BOUND, jax_train_run, train_errors  # noqa: E402
from torch_spmd import World  # noqa: E402

SIX_HEADS = {"hidden": 96, "n_heads": 6, "n_kv_heads": 2}  # 3 local heads at tensor 2, context 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("spmd4_tp"))
    yield w
    w.close()


@pytest.mark.parametrize("shape,impl,fsdp,overrides", [
    ({"fsdp": 2, "tensor": 2}, "dense", True, None),
    ({"data": 2, "tensor": 2}, "dense", False, None),
    ({"data": 2, "tensor": 2}, "dense", True, None),
    ({"tensor": 2, "context": 2}, "ulysses", True, None),
    ({"tensor": 2, "context": 2}, "ring", False, None),
    ({"tensor": 2, "context": 2}, "ulysses", False, SIX_HEADS),
], ids=["fsdp2-tensor2", "data2-tensor2-grad_sync", "data2-tensor2-hsdp", "tensor2-context2-ulysses-fsdp",
        "tensor2-context2-ring", "tensor2-context2-ulysses-heads_gathered"])
def test_tensor_parallel_train_step_matches_jax(world, shape, impl, fsdp, overrides):
    run = jax_train_run(shape, impl, overrides=overrides)
    results = world.run(tasks.train_step, shape, impl, fsdp, run["start"], run["batches"], overrides=overrides)
    assert all(r[0] == results[0][0] for r in results)  # every rank holds the global loss
    errors = train_errors(run, results[0])
    assert all(errors[k] <= TRAIN_BOUND[k] for k in errors), errors


def test_gradient_group_leaves_tensor_out(world):
    results = world.run(tasks.tensor_parallel_layout, {"data": 2, "tensor": 2})
    for rank, (tensor_rank, _, n, ranks) in enumerate(results):
        # mesh-linear order, data-major: rank = 2 · data + tensor
        assert tensor_rank == rank % 2
        assert n == 2 and ranks == [rank % 2, rank % 2 + 2], (rank, ranks)


def test_each_rank_holds_its_slice_of_the_sharded_weights(world):
    for _, sizes, _, _ in world.run(tasks.tensor_parallel_layout, {"data": 2, "tensor": 2}):
        for name, (local, whole) in sizes.items():
            sharded = not name.endswith(".scale")
            assert local * (2 if sharded else 1) == whole, (name, local, whole)
        assert sum(local for local, _ in sizes.values()) < 0.55 * sum(whole for _, whole in sizes.values())


def test_indivisible_heads_raise(world):
    texts = world.run(tasks.tensor_parallel_layout, {"tensor": 4})
    assert all(isinstance(t, str) and "n_kv_heads (2) must both divide by 4" in t
               and "tensor axis a common divisor" in t for t in texts), texts
