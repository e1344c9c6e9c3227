"""The expert-parallel MoE block (``models/moe.py``) held against the JAX
package's ``traceml_tpu/models/moe.py``.

The port's side runs in spawned gloo worlds of 2 and 4 ranks
(``tests/torch_spmd.py``), the JAX side in this process on the CPU.  The
weights are the flax ``MoEBlock``'s, passed through
``moe_params_from_jax``; x and y come from a numpy seed (y = x rolled by
one on the hidden dim, as in the JAX tests).

* One process, no mesh: the block's output and aux loss against
  ``MoEBlock.apply`` (f32, ≤ 1e-5 relative Frobenius: the same einsums,
  summed in another order), aux ≥ 1 (equality only for uniform
  routing).
* On {expert: 2}, {expert: 2, fsdp: 2} and {expert: 4}: every rank's
  output, aux and loss ``mse + 0.01 · aux``, and the gradients of the
  router, of x, of the norm scale and of every expert's weights
  (gathered over ``expert``, and over ``fsdp`` where FSDP2 shards them)
  against ``jax.grad`` of the same loss, within 1e-5 relative Frobenius.
  A gradient left partial on a rank, or an aux loss counted once per
  expert rank, is off by a factor of 2 or more there.  Each rank holds
  E/ep experts.
* ``make_moe_train_step`` (Adam, lr 1e-3) for 8 steps on {expert: 2,
  fsdp: 2): the losses and aux losses against JAX's ``make_moe_train_step``
  within 1e-4 relative, and the loss falls.
* ``moe_param_shardings`` against JAX's specs on an {expert: 4, fsdp: 2}
  mesh; ``moe_params_from_jax`` raises on a leaf left over or missing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

import torch_spmd_tasks as tasks  # noqa: E402
from test_torch_seq_parallel import _as_placements, _jmesh, _stand_in, rel_fro  # noqa: E402
from torch_spmd import Worlds  # noqa: E402
from traceml_tpu.models import moe as jax_moe  # noqa: E402
from traceml_tpu_torch.models import moe  # noqa: E402
from traceml_tpu_torch.models.convert import moe_params_from_jax  # noqa: E402

E, H, F = 4, 16, 32
AUX_WEIGHT = 0.01
BOUND = 1e-5  # f32, the same einsums in another sum order
TRAIN_BOUND = 1e-4  # 8 Adam steps: the update divides by √v̂, so early rounding is not damped


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = Worlds(tmp_path_factory.mktemp("spmd_moe"))
    yield w
    w.close()


def _case(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 8, H)).astype(np.float32)
    y = np.roll(x, 1, axis=-1)
    model = jax_moe.MoEBlock(n_experts=E, hidden=H, ffn_hidden=F)
    params = model.init(jax.random.PRNGKey(seed + 1), jnp.asarray(x))["params"]
    return model, params, x, y


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_loss_and_grads(model, params, x, y):
    def loss(params, x):
        out, aux = model.apply({"params": params}, x)
        return jnp.mean((out - y) ** 2) + AUX_WEIGHT * aux

    value, (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    grads = moe_params_from_jax(_np_tree(g_params))
    return float(value), {**{n: t.numpy() for n, t in grads.items()}, "x": np.asarray(g_x)}


def test_forward_and_aux_match_jax():
    model, params, x, _ = _case()
    want_out, want_aux = model.apply({"params": params}, jnp.asarray(x))
    block = moe.MoEBlock(E, H, F, device="cpu")
    block.load_state_dict(moe_params_from_jax(_np_tree(params)))
    with torch.no_grad():
        out, aux = block(torch.from_numpy(x))
    assert out.shape == x.shape
    assert rel_fro(out.detach().numpy(), np.asarray(want_out)) <= BOUND
    assert abs(float(aux) - float(want_aux)) <= BOUND * float(want_aux)
    assert float(aux) >= 1.0 - 1e-5


@pytest.mark.parametrize("shape", [{"expert": 2}, {"expert": 2, "fsdp": 2}, {"expert": 4}],
                         ids=["expert2", "expert2-fsdp2", "expert4"])
def test_expert_parallel_gradients_match_jax(worlds, shape):
    model, params, x, y = _case(1)
    want_loss, want = _jax_loss_and_grads(model, params, x, y)
    want_out, want_aux = model.apply({"params": params}, jnp.asarray(x))
    n = int(np.prod(list(shape.values())))
    for out, aux, loss, grads, local in worlds(n).run(tasks.moe_grads, shape, _np_tree(params), x, y, AUX_WEIGHT):
        assert local == E // shape["expert"]
        assert rel_fro(out, np.asarray(want_out)) <= BOUND
        assert abs(aux - float(want_aux)) <= BOUND * float(want_aux)
        assert abs(loss - want_loss) <= BOUND * want_loss
        errors = {name: rel_fro(grads[name], want[name]) for name in want}
        assert max(errors.values()) <= BOUND, errors


def test_train_step_matches_jax_and_learns(worlds):
    model, params, x, y = _case(2)
    init, train_step = jax_moe.make_moe_train_step(model)
    _, opt_state = init(jax.random.PRNGKey(3), jnp.asarray(x))
    step = jax.jit(train_step)
    jparams, want_losses, want_aux = params, [], []
    for _ in range(8):
        jparams, opt_state, metrics = step(jparams, opt_state, jnp.asarray(x), jnp.asarray(y))
        want_losses.append(float(metrics["loss"]))
        want_aux.append(float(metrics["aux"]))
    shape = {"expert": 2, "fsdp": 2}
    for losses, aux, local in worlds(4).run(tasks.moe_train, shape, _np_tree(params), x, y, 8):
        assert local == E // 2
        assert losses[-1] < losses[0]
        assert max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses)) <= TRAIN_BOUND, (losses, want_losses)
        assert max(abs(a - b) / abs(b) for a, b in zip(aux, want_aux)) <= TRAIN_BOUND, (aux, want_aux)


def test_param_shardings_match_jax():
    shape = {"expert": 4, "fsdp": 2}
    jmesh = _jmesh(shape)
    model, params, _, _ = _case()
    specs = jax_moe.moe_param_shardings(params, jmesh)
    flat = {"/".join(getattr(k, "key", str(k)) for k in path): s.spec
            for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]}
    want = {"norm_scale": flat["norm_scale"], "ffn.router": flat["MoEFFN_0/router"],
            "ffn.w_in": flat["MoEFFN_0/w_in"], "ffn.w_out": flat["MoEFFN_0/w_out"]}
    block = moe.MoEBlock(E, H, F, device="cpu")
    got = {n: [str(p) for p in s] for n, s in moe.moe_param_shardings(block, _stand_in(jmesh)).items()}
    assert got == {n: _as_placements(spec, jmesh.axis_names) for n, spec in want.items()}


def test_converter_raises_on_a_leaf_left_over_or_missing():
    _, params, _, _ = _case()
    tree = _np_tree(params)
    extra = {**tree, "stray": np.zeros(2, np.float32)}
    with pytest.raises(ValueError, match="stray"):
        moe_params_from_jax(extra)
    missing = {"norm_scale": tree["norm_scale"], "MoEFFN_0": {k: v for k, v in tree["MoEFFN_0"].items()
                                                              if k != "w_out"}}
    with pytest.raises(KeyError):
        moe_params_from_jax(missing)
