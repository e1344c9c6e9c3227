"""The port's DecoderLM against the JAX package's, from the same flax params.

A flax-initialised model's params go through ``params_from_jax``; both
models then take the same numpy tokens in f32.  Tolerance atol=rtol=1e-4:
f32 matmuls summed in another order, through a few layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traceml_tpu.models import transformer as jax_tf
from traceml_tpu_torch.models import transformer as tf
from traceml_tpu_torch.models.convert import params_from_jax
from traceml_tpu_torch.ops import attention as att
from traceml_tpu_torch.ops import flash_attention as fa

TOL = 1e-4


def _pair(cfg_kwargs, seq, seed=0):
    """(jax model, flax params, torch model) sharing one set of weights."""
    jcfg = jax_tf.ModelConfig(dtype=jnp.float32, **cfg_kwargs)
    jmodel = jax_tf.DecoderLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, seq), jnp.int32))["params"]
    tmodel = tf.DecoderLM(tf.ModelConfig(dtype=torch.float32, **cfg_kwargs), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


GQA = dict(vocab_size=256, hidden=128, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=128)


def test_config_matches_jax():
    for kwargs in (GQA, dict(hidden=1024), dict(hidden=64, n_heads=1, n_kv_heads=1)):
        ours, theirs = tf.ModelConfig(**kwargs), jax_tf.ModelConfig(**kwargs)
        assert (ours.head_dim, ours.ffn_hidden) == (theirs.head_dim, theirs.ffn_hidden)
    t, j = tf.ModelConfig.tiny(), jax_tf.ModelConfig.tiny()
    assert (t.vocab_size, t.hidden, t.n_layers, t.n_heads, t.n_kv_heads, t.max_seq_len) == (
        j.vocab_size, j.hidden, j.n_layers, j.n_heads, j.n_kv_heads, j.max_seq_len)


def test_logits_and_loss_match_jax_gqa():
    """4 heads over 2 kv heads: a `repeat` in place of `repeat_interleave`
    would pair the wrong kv head with half the query heads."""
    jmodel, params, tmodel = _pair(GQA, 32)
    tokens = _tokens(GQA["vocab_size"], (2, 33))
    jl = jmodel.apply({"params": params}, jnp.asarray(tokens[:, :-1]))
    with torch.no_grad():
        tl = tmodel(torch.from_numpy(tokens[:, :-1]).long())
    assert tl.dtype == torch.float32 and tl.shape == (2, 32, GQA["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    jloss = jax_tf.loss_fn(params, jmodel.apply, jnp.asarray(tokens))
    with torch.no_grad():
        tloss = tf.loss_fn(tmodel, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL, rtol=TOL)


def test_gqa_repeat_order_matters():
    """The same check turned round: with kv heads tiled instead of repeated
    in place, the logits leave the tolerance."""
    jmodel, params, tmodel = _pair(GQA, 16)
    tokens = _tokens(GQA["vocab_size"], (1, 16))
    jl = np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens)))
    real = torch.Tensor.repeat_interleave

    def tiled(self, repeats, dim=None, **kw):
        if dim == 2 and self.dim() == 4:
            return self.repeat(1, 1, repeats, 1)
        return real(self, repeats, dim, **kw)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "repeat_interleave", tiled)
        wrong = tmodel(torch.from_numpy(tokens).long()).numpy()
    assert not np.allclose(wrong, jl, atol=TOL, rtol=TOL)


def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 3, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    ours = tf._rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 10000.0)
    theirs = jax_tf._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5, rtol=1e-5)
    # half-split, not interleaved pairs: at position 1 (angle 1 for the
    # first frequency) element 0 rotates against element 32, not element 1
    xt = torch.from_numpy(x)
    want = xt[:, 1, :, 0] * np.cos(1.0) - xt[:, 1, :, 32] * np.sin(1.0)
    torch.testing.assert_close(ours[:, 1, :, 0], want, atol=1e-6, rtol=1e-6)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    norm = jax_tf.RMSNorm(dtype=jnp.float32)
    p = norm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ours = tf.RMSNorm(32, dtype=torch.float32)(torch.from_numpy(x))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(norm.apply(p, jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


def test_params_from_jax_maps_every_leaf_and_rejects_extras():
    _, params, tmodel = _pair(GQA, 8)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    sd = params_from_jax(np_params)
    assert set(sd) == set(tmodel.state_dict())
    assert sd["layers.0.attn.wq.weight"].shape == tmodel.layers[0].attn.wq.weight.shape
    np_params = dict(np_params, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(np_params)


def test_long_narrow_model_goes_through_flash_on_both_sides(monkeypatch):
    """S=1024, hidden 64, one layer: the JAX forward runs its Pallas kernel
    (interpret mode), the port's dispatcher takes its flash path."""
    import traceml_tpu.ops.pallas_attention as jax_pallas

    cfg = dict(vocab_size=64, hidden=64, n_layers=1, n_heads=1, n_kv_heads=1, max_seq_len=1024)
    jmodel, params, tmodel = _pair(cfg, 1024)
    jax_calls, torch_calls = [], []
    real_jax, real_plain = jax_pallas.flash_attention, fa.flash_attention_plain

    def jax_spy(*a, **kw):
        # recorded after the kernel ran: the JAX dispatcher swallows errors
        out = real_jax(*a, **kw)
        jax_calls.append(a[0].shape)
        return out

    def torch_spy(*a, **kw):
        torch_calls.append(tuple(a[0].shape))
        return real_plain(*a, **kw)

    monkeypatch.setattr(jax_pallas, "flash_attention", jax_spy)
    monkeypatch.setattr(fa, "flash_attention_plain", torch_spy)
    tokens = _tokens(cfg["vocab_size"], (1, 1024))
    jl = jmodel.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        tl = tmodel(torch.from_numpy(tokens).long())
    assert jax_calls and torch_calls == [(1, 1024, 1, 64)]
    assert att.attention_route(1024, "cpu") == "plain"
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA")
    from traceml_tpu_torch.utils.device import DeviceUnavailableError

    with pytest.raises(DeviceUnavailableError):
        tf.DecoderLM(tf.ModelConfig.tiny())
