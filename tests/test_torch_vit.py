"""The port's ViT against the JAX package's, from the same flax params.

A flax-initialised tiny ViT's params go through ``vit_params_from_jax``;
both models then take the same numpy images (B, H, W, C) and labels.  In
f32 the logits, the loss, every gradient and the weights after 3 AdamW
steps agree at atol = rtol = 1e-4 (the DecoderLM's bound: f32 matmuls
summed in another order).  In bf16 compute (the default, f32 params) the
logits agree to a relative Frobenius error of 2e-2 and the loss to 1e-2
relative: both sides round each layer's activations to bf16, not at the
same points (flax adds the bias after rounding the product, torch's
``addmm`` rounds once).  One encoder block alone agrees at 1e-5 in f32;
a planted fault, the exact GELU in place of flax's default tanh
approximation, must miss that bound (it moves the block's output by
about 5e-4, and the whole model's logits at init by about 1e-4, the
model's own bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
pytest.importorskip("torch")  # a checkout without torch still collects
import torch
import torch.nn.functional as F

from traceml_tpu.models import vit as jax_vit
from traceml_tpu.ops.attention import attention_reference as jax_attention
from traceml_tpu_torch.models import vit as tv
from traceml_tpu_torch.models.convert import vit_params_from_jax
from traceml_tpu_torch.ops.attention import attention_reference

TOL = 1e-4
BLOCK_TOL = 1e-5
BF16_REL_FRO = 2e-2
BF16_LOSS_REL = 1e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(cfg, batch=4, seed=1):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, batch).astype(np.int32)
    return images, labels


def _pair(f32=True, seed=0):
    """(jax model, flax params, torch model, images, labels) on one set of
    weights."""
    jcfg = jax_vit.ViTConfig.tiny()
    tcfg = tv.ViTConfig.tiny()
    if f32:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    jmodel = jax_vit.ViT(jcfg)
    images, labels = _data(tcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(images))["params"]
    tmodel = tv.ViT(tcfg, device="cpu")
    tmodel.load_state_dict(vit_params_from_jax(_np(params)))
    return jmodel, params, tmodel, images, labels


def _jax_loss(jmodel, params, images, labels):
    logits = jmodel.apply({"params": params}, images)
    onehot = jax.nn.one_hot(labels, logits.shape[-1])
    return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1))


def test_config_matches_jax():
    for ours, theirs in ((tv.ViTConfig(), jax_vit.ViTConfig()), (tv.ViTConfig.tiny(), jax_vit.ViTConfig.tiny())):
        fields = ("image_size", "patch_size", "hidden", "n_layers", "n_heads", "ffn_mult", "n_classes", "n_patches")
        assert [getattr(ours, f) for f in fields] == [getattr(theirs, f) for f in fields]
    assert tv.ViTConfig().dtype == torch.bfloat16 and tv.ViTConfig().param_dtype == torch.float32


def test_every_flax_leaf_is_mapped():
    jmodel, params, tmodel, _, _ = _pair()
    sd = vit_params_from_jax(_np(params))
    assert sorted(sd) == sorted(tmodel.state_dict())
    n_flax = sum(np.asarray(leaf).size for leaf in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in tmodel.parameters())
    extra = _np(params)
    extra["stray"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(ValueError, match="stray"):
        vit_params_from_jax(extra)


def test_logits_and_loss_match_jax_f32():
    jmodel, params, tmodel, images, labels = _pair()
    jl = np.asarray(jmodel.apply({"params": params}, jnp.asarray(images)))
    with torch.no_grad():
        tl = tmodel(torch.from_numpy(images))
    assert tl.dtype == torch.float32 and tl.shape == (4, 10)
    np.testing.assert_allclose(tl.numpy(), jl, atol=TOL, rtol=TOL)
    jloss = float(_jax_loss(jmodel, params, jnp.asarray(images), jnp.asarray(labels)))
    tloss = float(F.cross_entropy(tl, torch.from_numpy(labels).long()))
    np.testing.assert_allclose(tloss, jloss, atol=TOL, rtol=TOL)


def test_gradients_match_jax_f32():
    jmodel, params, tmodel, images, labels = _pair()
    jgrads = jax.grad(_jax_loss, argnums=1)(jmodel, params, jnp.asarray(images), jnp.asarray(labels))
    expected = vit_params_from_jax(_np(jgrads))
    F.cross_entropy(tmodel(torch.from_numpy(images)), torch.from_numpy(labels).long()).backward()
    got = {name: p.grad for name, p in tmodel.named_parameters()}
    assert sorted(got) == sorted(expected)
    for name, g in expected.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=TOL, rtol=TOL, err_msg=name)


def test_adamw_steps_match_jax_f32():
    """Three AdamW steps: optax ``adamw(1e-3)`` (weight decay 1e-4 on every
    leaf) against ``make_vit_train_step``'s torch AdamW."""
    jmodel, params, tmodel, images, labels = _pair()
    _, jstep = jax_vit.make_vit_train_step(jmodel)
    state = {"params": params, "opt_state": optax.adamw(1e-3).init(params)}
    init, tstep = tv.make_vit_train_step(tmodel)
    opt = init(state_dict=vit_params_from_jax(_np(params)))
    assert opt.defaults["weight_decay"] == 1e-4 and opt.defaults["eps"] == 1e-8
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    for _ in range(3):
        state, jm = jstep(state, jnp.asarray(images), jnp.asarray(labels))
        tm = tstep(x, y)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=TOL, rtol=TOL)
    expected = vit_params_from_jax(_np(state["params"]))
    for name, p in tmodel.state_dict().items():
        np.testing.assert_allclose(p.numpy(), expected[name].numpy(), atol=TOL, rtol=TOL, err_msg=name)


def test_logits_and_loss_match_jax_bf16():
    jmodel, params, tmodel, images, labels = _pair(f32=False)
    jl = np.asarray(jmodel.apply({"params": params}, jnp.asarray(images)))
    with torch.no_grad():
        tl = tmodel(torch.from_numpy(images))
    assert tl.dtype == torch.float32  # the head promotes the bf16 pool to f32
    assert np.linalg.norm(tl.numpy() - jl) / np.linalg.norm(jl) < BF16_REL_FRO
    jloss = float(_jax_loss(jmodel, params, jnp.asarray(images), jnp.asarray(labels)))
    tloss = float(F.cross_entropy(tl, torch.from_numpy(labels).long()))
    assert abs(tloss - jloss) / jloss < BF16_LOSS_REL


def _block_outputs(params, tmodel, seed=2):
    """One encoder block (``layer_0``) of each package on the same (4, 16,
    64) f32 activations."""
    x = np.random.default_rng(seed).normal(size=(4, 16, 64)).astype(np.float32)
    jcfg = dataclasses.replace(jax_vit.ViTConfig.tiny(), dtype=jnp.float32)
    jout = np.asarray(jax_vit.EncoderBlock(jcfg).apply({"params": params["layer_0"]}, jnp.asarray(x)))
    with torch.no_grad():
        tout = tmodel.layers[0](torch.from_numpy(x)).numpy()
    return tout, jout


def test_encoder_block_matches_jax_f32():
    _, params, tmodel, _, _ = _pair()
    tout, jout = _block_outputs(params, tmodel)
    np.testing.assert_allclose(tout, jout, atol=BLOCK_TOL, rtol=BLOCK_TOL)


def test_planted_exact_gelu_fails(monkeypatch):
    """flax's ``nn.gelu`` is the tanh approximation: the exact GELU in its
    place must miss the block's bound."""
    _, params, tmodel, _, _ = _pair()
    exact = F.gelu
    monkeypatch.setattr(tv.F, "gelu", lambda h, approximate="none": exact(h))
    tout, jout = _block_outputs(params, tmodel)
    assert not np.allclose(tout, jout, atol=BLOCK_TOL, rtol=BLOCK_TOL)


def test_encoder_attention_is_bidirectional():
    """The non-causal path lets EARLY positions see LATE keys, as the JAX
    test checks before the pool; the causal path does not."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 8, 2, 8)).astype(np.float32)) for _ in range(3))
    k2 = k.clone()
    k2[:, -1] += 2.0  # perturb only the LAST key
    full1, full2 = attention_reference(q, k, v, causal=False), attention_reference(q, k2, v, causal=False)
    causal1, causal2 = attention_reference(q, k, v, causal=True), attention_reference(q, k2, v, causal=True)
    assert not torch.allclose(full1[:, 0], full2[:, 0])
    torch.testing.assert_close(causal1[:, :-1], causal2[:, :-1], atol=1e-6, rtol=0)
    jfull = np.asarray(jax_attention(*(jnp.asarray(t.numpy()) for t in (q, k2, v)), causal=False))
    np.testing.assert_allclose(full2.numpy(), jfull, atol=1e-5, rtol=1e-5)


def test_patches_are_row_major_and_sizes_checked():
    """Patch i of the embedding is the (i // (W/p), i % (W/p)) tile, the
    order of ``pos_embed`` and of flax's conv output reshape."""
    cfg = dataclasses.replace(tv.ViTConfig.tiny(), dtype=torch.float32)
    emb = tv.PatchEmbed(cfg, torch.float32, torch.device("cpu"))
    images = torch.zeros((1, 32, 32, 3))
    images[0, 8:16, 24:32, :] = 1.0  # tile (1, 3)
    with torch.no_grad():
        emb.bias.zero_()
        out = emb(images)
    nonzero = [i for i in range(16) if out[0, i].abs().sum() > 0]
    assert nonzero == [1 * 4 + 3]
    with pytest.raises(ValueError):
        emb(torch.zeros((1, 30, 32, 3)))
    with pytest.raises(ValueError):
        tv.ViT(dataclasses.replace(cfg, image_size=30), device="cpu")


def test_train_step_learns():
    """The JAX test's check: 25 steps at lr 5e-3 memorize one batch."""
    cfg = tv.ViTConfig.tiny()
    model = tv.ViT(cfg, device="cpu")
    init, step = tv.make_vit_train_step(model, learning_rate=5e-3)
    init(0)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(8, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.n_classes, (8,)))
    losses = [float(step(images, labels)["loss"]) for _ in range(25)]
    assert losses[-1] < losses[0] * 0.8
