"""The port's TinyMLP and its Adam step against the JAX package's.

A flax-initialised ``TinyMLP`` goes through ``mlp_params_from_jax``; both
take the same numpy (x, y).  All f32: the predictions, the MSE loss and
the weights after 3 Adam steps (optax ``adam(1e-3)`` against torch
``Adam(lr, eps=1e-8)``) agree at atol = rtol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")  # a checkout without torch still collects
import torch

from traceml_tpu.models import mlp as jax_mlp
from traceml_tpu_torch.models import TinyMLP as ExportedTinyMLP
from traceml_tpu_torch.models import mlp as tm
from traceml_tpu_torch.models.convert import mlp_params_from_jax

TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(hidden=256, depth=3, seed=0):
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(64, 64)).astype(np.float32)
    y = rng.normal(size=(64, 1)).astype(np.float32)
    jmodel = jax_mlp.TinyMLP(hidden=hidden, depth=depth)
    jinit, jstep = jax_mlp.make_mlp_train_step(jmodel)
    params, opt_state = jinit(jax.random.PRNGKey(seed), x)
    tmodel = tm.TinyMLP(hidden=hidden, depth=depth, device="cpu")
    tinit, tstep = tm.make_mlp_train_step(tmodel)
    tinit(state_dict=mlp_params_from_jax(_np(params)))
    return (jmodel, params, opt_state, jstep), (tmodel, tstep), x, y


def test_exported_from_models():
    assert ExportedTinyMLP is tm.TinyMLP


@pytest.mark.parametrize("hidden,depth", [(256, 3), (128, 2), (32, 1)])
def test_every_flax_leaf_is_mapped(hidden, depth):
    (jmodel, params, _, _), (tmodel, _), _, _ = _pair(hidden, depth)
    sd = mlp_params_from_jax(_np(params))
    assert sorted(sd) == sorted(tmodel.state_dict())
    assert len(tmodel.layers) == depth


def test_forward_matches_jax():
    (jmodel, params, _, _), (tmodel, _), x, _ = _pair()
    jout = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(x)).numpy()
    assert tout.shape == (64, 1) and tout.dtype == np.float32
    np.testing.assert_allclose(tout, jout, atol=TOL, rtol=TOL)


def test_adam_steps_match_jax():
    (jmodel, params, opt_state, jstep), (tmodel, tstep), x, y = _pair()
    for _ in range(3):
        params, opt_state, jloss = jstep(params, opt_state, jnp.asarray(x), jnp.asarray(y))
        tloss = tstep(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL, rtol=TOL)
    expected = mlp_params_from_jax(_np(params))
    for name, p in tmodel.state_dict().items():
        np.testing.assert_allclose(p.numpy(), expected[name].numpy(), atol=TOL, rtol=TOL, err_msg=name)


def test_init_is_seeded_and_device_explicit():
    a = tm.TinyMLP(hidden=32, depth=2, device="cpu")
    b = tm.TinyMLP(hidden=32, depth=2, device="cpu")
    init_b, _ = tm.make_mlp_train_step(b)
    init_b(0)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    init_b(1)
    assert not torch.equal(a.layers[0].weight, b.layers[0].weight)
    assert torch.count_nonzero(b.layers[0].bias) == 0
    if not torch.cuda.is_available():
        from traceml_tpu_torch.utils.device import DeviceUnavailableError

        with pytest.raises(DeviceUnavailableError):
            tm.TinyMLP()
