"""The forward's plain-op routes with fewer kernels, against their older
forms and the JAX package.

* RMSNorm as ``F.rms_norm`` on the upcast input against the written-out
  eight-op form (bit-equal on the CPU, forward and scale gradient; the
  input gradient within 1e-4 relative Frobenius, one bf16 ulp on a few
  elements, as on the card) and against the JAX ``RMSNorm`` in f32 and bf16.
* RoPE's roll with the sign folded into the sin table against the
  negate-and-concatenate form: bit-equal, forward and backward.
* ``Dense``'s kept cast: forward and gradients bit-equal to the
  uncached ``.to``, the cast made anew by the optimizer step (for-loop,
  foreach and fused: the fused step bumps no version counter) so the
  next train forward casts nothing, fresh after an in-place ``copy_``,
  inference tensors kept to inference mode, kept under grad with its
  autograd edge (two backwards through one cast accumulate), a weight
  unfrozen after a frozen forward gets its gradient, the tiny DecoderLM's
  AdamW training bit-equal to the uncached route with and without remat,
  DTensor weights and ``cache_cast = False`` on the plain route.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")  # a checkout without torch still collects
import torch
import torch.nn.functional as F

from traceml_tpu.models import transformer as jax_tf
from traceml_tpu_torch.models import transformer as tf

EPS = 1e-6


def _eight_ops(x, scale, dtype):
    x32 = x.float()
    normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + EPS)
    return (normed * scale).to(dtype)


def _negate_concat(x, cos, sin_full):
    half = x.shape[-1] // 2
    xf = x.float()
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin_full).to(x.dtype)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("shape", [(2, 16, 64), (4, 128, 256)])
def test_rms_norm_route_against_eight_ops(shape):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    norm = tf.RMSNorm(shape[-1], dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(1 + 0.1 * rng.standard_normal(shape[-1]).astype(np.float32)))
    xa = x.clone().requires_grad_()
    out = norm(xa)
    out.backward(g)
    xb = x.clone().requires_grad_()
    scale = norm.scale.detach().clone().requires_grad_()
    ref = _eight_ops(xb, scale, torch.bfloat16)
    ref.backward(g)
    assert torch.equal(out, ref)
    assert torch.equal(norm.scale.grad, scale.grad)
    assert _rel(xa.grad, xb.grad) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 96)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    jnorm = jax_tf.RMSNorm(dtype=getattr(jnp, dtype))
    theirs = np.asarray(jnorm.apply({"params": {"scale": jnp.asarray(scale)}},
                                    jnp.asarray(x).astype(getattr(jnp, dtype))).astype(jnp.float32))
    norm = tf.RMSNorm(96, dtype=getattr(torch, dtype), device="cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        ours = norm(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(ours, theirs, atol=tol, rtol=tol)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_rope_route_bit_equal_forward_and_backward(head_dim):
    rng = np.random.default_rng(2)
    B, S, H = 2, 64, 3
    x = torch.from_numpy(rng.standard_normal((B, S, H, head_dim)).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((B, S, H, head_dim)).astype(np.float32)).to(torch.bfloat16)
    positions = torch.arange(S).expand(B, S)
    cos, signed_sin = tf._rope_tables(positions, head_dim, 10000.0)
    half = head_dim // 2
    sin_full = torch.cat([signed_sin[..., half:], signed_sin[..., half:]], dim=-1)
    assert torch.equal(signed_sin[..., :half], -signed_sin[..., half:])
    xa = x.clone().requires_grad_()
    out = tf._apply_rope(xa, cos, signed_sin)
    out.backward(g)
    xb = x.clone().requires_grad_()
    ref = _negate_concat(xb, cos, sin_full)
    ref.backward(g)
    assert torch.equal(out, ref)
    assert torch.equal(xa.grad, xb.grad)


def test_attention_ropes_q_and_k_in_one_pass(monkeypatch):
    """The attention's joint RoPE over q's and k's heads gives the q, k
    and v of two separate passes, bit for bit, and their gradients; the
    model's tables, kept between forwards, are the tables of its
    positions."""
    cfg = dataclasses.replace(tf.ModelConfig.tiny(), dtype=torch.bfloat16)
    torch.manual_seed(0)
    attn = tf.Attention(cfg, torch.bfloat16, "cpu", tf.tensor_parallel(cfg))
    seen = {}

    def record(self, q, k, v):
        seen.update(q=q, k=k, v=v)
        return q

    monkeypatch.setattr(tf.Attention, "_attend", record)
    B, S, hd = 2, 16, cfg.head_dim
    x = torch.randn(B, S, cfg.hidden).to(torch.bfloat16).requires_grad_()
    rope = tf._rope_tables(torch.arange(S).expand(B, S), hd, cfg.rope_theta)
    attn(x, rope).float().pow(2).sum().backward()
    x2 = x.detach().clone().requires_grad_()
    q = tf._apply_rope(attn.wq(x2).view(B, S, cfg.n_heads, hd), *rope)
    k = tf._apply_rope(attn.wk(x2).view(B, S, cfg.n_kv_heads, hd), *rope)
    group = cfg.n_heads // cfg.n_kv_heads
    k = k.repeat_interleave(group, dim=2)
    v = attn.wv(x2).view(B, S, cfg.n_kv_heads, hd).repeat_interleave(group, dim=2)
    assert torch.equal(seen["q"], q) and torch.equal(seen["k"], k) and torch.equal(seen["v"], v)
    # k and v are repeat copies; q stays a view of the joint buffer, read
    # through its strides
    assert seen["k"].is_contiguous() and seen["v"].is_contiguous() and seen["q"].stride(-1) == 1
    grad_x = x.grad
    attn.zero_grad()
    attn.wo(q.reshape(B, S, -1)).float().pow(2).sum().backward()
    assert torch.equal(grad_x, x2.grad)
    model = tf.DecoderLM(cfg, device="cpu")
    for mode in (torch.no_grad, torch.inference_mode, torch.no_grad):
        with mode():
            cos, sin = model.rope_tables(0, S, torch.device("cpu"))
            assert not cos.is_inference() or torch.is_inference_mode_enabled()
        assert torch.equal(cos[None].expand(B, S, 1, hd), rope[0]) and torch.equal(sin[None].expand(B, S, 1, hd), rope[1])
    assert model.rope_tables(0, S, torch.device("cpu"))[0] is model.rope_tables(0, S, torch.device("cpu"))[0]
    assert not torch.equal(model.rope_tables(S, S, torch.device("cpu"))[0], rope[0][0])


def _dense(seed=0, d_in=32, d_out=48):
    torch.manual_seed(seed)
    return tf.Dense(d_in, d_out, torch.bfloat16, torch.float32, "cpu")


def _x(seed=1, d_in=32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((2, 5, d_in)).astype(np.float32)) \
        .to(torch.bfloat16)


def test_cached_cast_forward_and_gradients_bit_equal():
    dense = _dense()
    x = _x()
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 5, 48)).astype(np.float32)) \
        .to(torch.bfloat16)
    with torch.no_grad():
        first = dense(x)
    assert dense._cast_key is not None
    with torch.no_grad():
        assert torch.equal(dense(x), first)
    xs = x.clone().requires_grad_()
    y = dense(xs)  # a hit with grad on: the kept cast, with its autograd edge
    assert y.grad_fn is not None
    y.backward(g)
    w = dense.weight.detach().clone().requires_grad_()
    xr = x.clone().requires_grad_()
    yr = F.linear(xr, w.to(torch.bfloat16))
    yr.backward(g)
    assert torch.equal(y, yr) and torch.equal(first, yr.detach())
    assert torch.equal(xs.grad, xr.grad)
    assert torch.equal(dense.weight.grad, w.grad)
    assert dense.weight.grad.dtype == torch.float32


@pytest.mark.parametrize("impl", ["for_loop", "foreach", "fused"])
def test_cached_cast_fresh_after_adamw_step(impl):
    dense = _dense()
    x = _x()
    opt = torch.optim.AdamW(dense.parameters(), lr=1e-2, weight_decay=0.01,
                            foreach=impl == "foreach", fused=True if impl == "fused" else None)
    with torch.no_grad():
        before = dense(x)
    dense(x).float().pow(2).mean().backward()
    opt.step()  # the fused step writes the weight without a version bump
    with torch.no_grad():
        after = dense(x)
        want = F.linear(x, dense.weight.to(torch.bfloat16))
    assert torch.equal(after, want)
    assert not torch.equal(after, before)
    # the step cast anew: the next forward with grad on casts nothing
    kept = dense._cast
    assert kept.grad_fn is not None
    y = dense(x)
    assert dense._cast is kept
    assert torch.equal(y, F.linear(x, dense.weight.to(torch.bfloat16)))


def test_cached_cast_fresh_after_inplace_copy_and_load_state_dict():
    dense = _dense()
    x = _x()
    with torch.no_grad():
        dense(x)
        dense.weight.copy_(torch.randn_like(dense.weight))
        assert torch.equal(dense(x), F.linear(x, dense.weight.to(torch.bfloat16)))
    other = _dense(seed=7)
    dense.load_state_dict(other.state_dict())
    with torch.no_grad():
        assert torch.equal(dense(x), F.linear(x, other.weight.to(torch.bfloat16)))
    dense.weight.data = torch.randn_like(dense.weight)  # new storage: a new key
    with torch.no_grad():
        assert torch.equal(dense(x), F.linear(x, dense.weight.to(torch.bfloat16)))


def test_cached_cast_modes():
    dense = _dense()
    x = _x()
    # grad on and a miss: the cast is kept, with its autograd edge
    dense(x)
    assert dense._cast_key is not None and dense._cast.grad_fn is not None
    with torch.inference_mode():
        inf = dense(x)
    assert dense._cast.is_inference()
    # an inference-mode copy never serves outside inference mode
    with torch.no_grad():
        plain = dense(x)
    assert not dense._cast.is_inference()
    assert torch.equal(inf, plain)
    xs = x.clone().requires_grad_()
    dense(xs).sum().backward()
    assert dense.weight.grad is not None


def test_kept_cast_accumulates_over_two_backwards_and_sees_unfreezing():
    dense = _dense()
    x = _x()
    dense(x).float().pow(2).sum().backward()
    dense(x).float().sum().backward()  # the same kept cast, a second graph
    w = dense.weight.detach().clone().requires_grad_()
    F.linear(x, w.to(torch.bfloat16)).float().pow(2).sum().backward()
    F.linear(x, w.to(torch.bfloat16)).float().sum().backward()
    assert torch.equal(dense.weight.grad, w.grad)
    # a forward while frozen keeps a cast without an edge; unfrozen, the
    # weight gets its gradient
    frozen = _dense(seed=3)
    frozen.weight.requires_grad_(False)
    frozen(x)
    assert frozen._cast.grad_fn is None
    frozen.weight.requires_grad_(True)
    frozen(x).float().sum().backward()
    assert frozen.weight.grad is not None


@pytest.mark.parametrize("impl", ["for_loop", "fused"])
@pytest.mark.parametrize("remat", [False, True])
def test_kept_casts_train_the_decoder_as_plain_casts(impl, remat):
    """Three AdamW steps of the tiny DecoderLM with the kept casts and
    with ``cache_cast = False``: the same losses, gradients and weights,
    bit for bit, with each block checkpointed or not."""
    cfg = dataclasses.replace(tf.ModelConfig.tiny(), dtype=torch.bfloat16, remat=remat)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 17)))
    runs = []
    for cache in (True, False):
        torch.manual_seed(0)
        model = tf.DecoderLM(cfg, device="cpu")
        for m in model.modules():
            if isinstance(m, tf.Dense):
                m.cache_cast = cache
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=0.01,
                                foreach=False, fused=True if impl == "fused" else None)
        losses, grads = [], []
        for _ in range(3):
            loss = tf.loss_fn(model, tokens)
            loss.backward()
            losses.append(loss.detach())
            grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
            opt.step()
            opt.zero_grad(set_to_none=True)
        runs.append((losses, grads, {k: v.clone() for k, v in model.state_dict().items()}))
    (l1, g1, s1), (l2, g2, s2) = runs
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(g1, g2) for k in a)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


def test_uncached_routes_for_dtensor_and_sharded(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    dense = _dense()
    x = _x()
    dense.cache_cast = False  # what shard_model sets on every Dense
    with torch.no_grad():
        out = dense(x)
    assert dense._cast_key is None
    assert torch.equal(out, F.linear(x, dense.weight.to(torch.bfloat16)))
    dense.cache_cast = True
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        dense.weight = torch.nn.Parameter(distribute_tensor(dense.weight.detach(), mesh, [Replicate()]))
        with torch.no_grad():
            cast = dense.cast_weight()
        assert isinstance(cast, DTensor) and cast.dtype == torch.bfloat16
        assert dense._cast_key is None
        assert torch.equal(cast.to_local(), dense.weight.to_local().to(torch.bfloat16))
    finally:
        dist.destroy_process_group()


def test_shard_model_turns_the_cache_off(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("fsdp",))
        cfg = dataclasses.replace(tf.ModelConfig.tiny(), dtype=torch.float32)
        model = tf.DecoderLM(cfg, device="cpu")
        tf.shard_model(model, mesh)
        denses = [m for m in model.modules() if isinstance(m, tf.Dense)]
        assert denses and all(not m.cache_cast for m in denses)
    finally:
        dist.destroy_process_group()


def test_seeded_weights_kept_on_disk_are_the_seeds(tmp_path, monkeypatch):
    """The dev workload's weights, read back from the build dir, equal
    the ones made from the seed; another seed or width is another file;
    a torn file is made again."""
    from traceml_tpu_torch.dev import workload as W
    from traceml_tpu_torch.models.convert import params_from_jax
    from traceml_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    cfg = tf.ModelConfig.tiny()
    want = params_from_jax(W.random_flax_params(cfg, 5))
    made = W.seeded_state_dict(cfg, 5)
    files = sorted(tmp_path.glob("weights-*.pt"))
    assert len(files) == 1
    read = W.seeded_state_dict(cfg, 5)
    assert set(made) == set(read) == set(want)
    assert all(torch.equal(made[k], want[k]) and torch.equal(read[k], want[k]) for k in want)
    W.seeded_state_dict(cfg, 6)
    W.seeded_state_dict(dataclasses.replace(cfg, n_layers=1), 5)
    assert len(list(tmp_path.glob("weights-*.pt"))) == 3
    files[0].write_bytes(b"torn")
    again = W.seeded_state_dict(cfg, 5)
    assert all(torch.equal(again[k], want[k]) for k in want)
    model = W.build_model(cfg, 5, device="cpu")
    assert all(torch.equal(model.state_dict()[k], want[k]) for k in want)


def test_seeded_weights_file_follows_the_makers_source(tmp_path, monkeypatch):
    """A change to the code that makes the weights names another file:
    the kept weights of the old code are never read for the new."""
    from traceml_tpu_torch.dev import workload as W
    from traceml_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    cfg = tf.ModelConfig.tiny()
    W.seeded_state_dict(cfg, 5)
    original = W.random_flax_params

    def random_flax_params(cfg, seed):  # another source, the same weights
        return original(cfg, seed)

    monkeypatch.setattr(W, "random_flax_params", random_flax_params)
    W.seeded_state_dict(cfg, 5)
    assert len(list(tmp_path.glob("weights-*.pt"))) == 2
