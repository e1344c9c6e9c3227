"""The port's flash attention against the JAX package's.

The same numpy inputs go through ``traceml_tpu.ops.pallas_attention.
flash_attention`` (interpret mode on the CPU, as the JAX package's own
tests run it), the JAX reference, and the port's plain version and
dispatcher.  Tolerances: f32 atol=rtol=2e-5 (sum order only), bf16 3e-2
(one bf16 rounding of the output, as the JAX tests use).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traceml_tpu.ops.attention import causal_attention_reference as jax_reference
from traceml_tpu.ops.pallas_attention import flash_attention as jax_flash
from traceml_tpu_torch.ops import attention as att
from traceml_tpu_torch.ops import flash_attention as fa

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _qkv(B=2, S=256, H=4, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        (rng.standard_normal((B, S, H, D)) * 0.3).astype(np.float32) for _ in range(3)
    )


def _torch(xs, dtype=torch.float32):
    return tuple(torch.from_numpy(x).to(dtype) for x in xs)


def _jax(xs, dtype=jnp.float32):
    return tuple(jnp.asarray(x, dtype) for x in xs)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def test_plain_matches_jax_flash_and_reference_f32():
    xs = _qkv()
    ours = fa.flash_attention_plain(*_torch(xs))
    np.testing.assert_allclose(_np(ours), _np(jax_flash(*_jax(xs))), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(_np(ours), _np(jax_reference(*_jax(xs))), atol=F32_TOL, rtol=F32_TOL)


def test_plain_matches_jax_flash_bf16():
    xs = _qkv()
    ours = fa.flash_attention_plain(*_torch(xs, torch.bfloat16))
    assert ours.dtype == torch.bfloat16
    theirs = jax_flash(*_jax(xs, jnp.bfloat16))
    np.testing.assert_allclose(_np(ours), _np(theirs), atol=BF16_TOL, rtol=BF16_TOL)


def test_reference_matches_jax_reference():
    xs = _qkv(S=128)
    for causal in (True, False):
        from traceml_tpu.ops.attention import attention_reference as jax_attention

        ours = att.attention_reference(*_torch(xs), causal=causal)
        np.testing.assert_allclose(
            _np(ours), _np(jax_attention(*_jax(xs), causal=causal)), atol=F32_TOL, rtol=F32_TOL
        )


def test_flash_is_causal():
    q, k, v = _torch(_qkv(B=1, S=128, H=2))
    out1 = fa.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] += 1.0
    v2[:, -1] += 1.0
    out2 = fa.flash_attention(q, k2, v2)
    np.testing.assert_allclose(_np(out1[:, :-1]), _np(out2[:, :-1]), atol=1e-5)
    assert not np.allclose(_np(out1[:, -1]), _np(out2[:, -1]))


def test_flash_rejects_ragged_seq():
    q, k, v = _torch(_qkv(S=100))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, blk_q=64, blk_k=64)


@pytest.mark.parametrize("S,blocks", [(64, (128, 128)), (256, (128, 64))])
def test_block_clamp_and_uneven_pair_match_jax(S, blocks):
    xs = _qkv(B=1, S=S, H=2)
    ours = fa.flash_attention(*_torch(xs), *blocks)
    theirs = jax_flash(*_jax(xs), *blocks)
    np.testing.assert_allclose(_np(ours), _np(theirs), atol=F32_TOL, rtol=F32_TOL)


def test_route_predicate():
    assert att.attention_route(1024, "cuda") == "kernel"
    assert att.attention_route(2048, "cuda") == "kernel"
    assert att.attention_route(1024, "cpu") == "plain"
    assert att.attention_route(512, "cuda") == "reference"
    assert att.attention_route(1023, "cuda") == "reference"
    assert att.attention_route(1088, "cuda") == "reference"  # 128 does not divide it


def test_dispatcher_takes_plain_at_long_seq_on_cpu(monkeypatch):
    calls = []
    real = fa.flash_attention_plain

    def spy(*args, **kwargs):
        calls.append(args[0].shape[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_plain", spy)
    q, k, v = _torch(_qkv(B=1, S=1024, H=1))
    att.causal_attention(q, k, v)
    assert calls == [1024]
    q, k, v = _torch(_qkv(B=1, S=128, H=1))
    att.causal_attention(q, k, v)
    assert calls == [1024]  # short sequences stay on the reference path


def test_kernel_launch_error_propagates(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("flash_attention_fwd launch failed: injected")

    monkeypatch.setattr(att, "flash_attention", broken)
    q, k, v = _torch(_qkv(B=1, S=1024, H=1))
    with pytest.raises(RuntimeError, match="injected"):
        att.causal_attention(q, k, v)


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    q, k, v = _torch(_qkv(B=1, S=128, H=1))
    with pytest.raises(ValueError):
        fa._launch(q, k, v)
    with pytest.raises(ValueError):
        fa._launch(q, k[:, :64], v)
