"""Tests of the port that need the card.  They import no JAX, so they run
where the port runs: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Without a CUDA card they skip.

Besides the kernel against its plain version: the parallel workloads in
a one-rank NCCL group on the card, each against its unsharded reference
on the same weights and inputs (one rank of each axis runs the same ops
as the reference, with its collectives skipped): the tiny DecoderLM's
AdamW step (hidden 256, head_dim 64) tensor-parallel on {tensor: 1} at
S = 1024 (the flash kernel,
once a layer and a forward), the MoE block on {expert: 1}, the pipeline
on {stage: 1} against the sequential stack.  The ViT's traced AdamW
step in bf16 (on the device clock, no compile phase, the loss falling)
and the compile tracker under inductor (a compiled model's shapes as
``compile_time`` events in their steps, a fixed shape compiling once)."""

import dataclasses
import socket

import numpy as np
import pytest
pytest.importorskip("torch")  # a checkout without torch still collects
import torch

from traceml_tpu_torch.dev.attention_check import TOLERANCES, compare
from traceml_tpu_torch.ops import flash_attention as fa


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda", 0)


# (dtype, B, S, H, D, q scale).  bf16 runs the wgmma kernel, f32 the
# CUDA-core kernel.  S=1088 leaves a ragged last 128-row tile; 9 x 16 = 144
# (batch, head) pairs give more blocks per query tile than the card has
# SMs; q x 8 gives scores of standard deviation ~8, so the running max
# moves and the online rescale does real work.  Each case is held to
# attention_check.TOLERANCES: allclose (bf16 3e-2: the kernel rounds P to
# bf16 before the P V product, where the plain version keeps it in f32,
# and rounds the output to bf16 once; f32 1e-4: sum order only) and the
# two checks that scale with the output.
BF16, F32 = torch.bfloat16, torch.float32
CASES = [
    (F32, 2, 1024, 2, 64, 1.0),
    (F32, 2, 1024, 2, 128, 1.0),
    (BF16, 2, 1024, 2, 64, 1.0),
    (BF16, 2, 1024, 2, 128, 1.0),
    (BF16, 2, 1088, 2, 64, 1.0),
    (BF16, 2, 1088, 2, 128, 1.0),
    (BF16, 1, 4096, 2, 64, 1.0),
    (BF16, 1, 4096, 2, 128, 1.0),
    (BF16, 9, 1024, 16, 64, 1.0),
    (BF16, 9, 1024, 16, 128, 1.0),
    (BF16, 2, 1024, 2, 64, 8.0),
    (BF16, 2, 1088, 2, 128, 8.0),
]


@pytest.mark.cuda
def test_tensor_map_cache_fresh_on_new_pointer_shape_or_strides(cuda_device):
    """The bf16 kernel encodes its TMA maps once per (pointer, shape,
    strides): the same tensors again find all three maps; a new buffer, a
    new shape or new strides encode fresh maps, and every result agrees
    with the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def qkv(shape):
        return [torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16) for _ in range(3)]

    def check(out, q, k, v):
        ref = fa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
        tol = TOLERANCES[torch.bfloat16]
        torch.testing.assert_close(out.float(), ref.float(), atol=tol["atol"], rtol=tol["atol"])

    def delta(fn):
        before = fa.tensor_map_cache_stats()
        out = fn()
        torch.cuda.synchronize()
        after = fa.tensor_map_cache_stats()
        return out, after["hits"] - before["hits"], after["misses"] - before["misses"]

    fa.clear_tensor_map_cache()
    assert fa.tensor_map_cache_stats() == {"hits": 0, "misses": 0}
    q, k, v = qkv((2, 1024, 2, 64))
    out, hits, misses = delta(lambda: fa.flash_attention(q, k, v))
    assert (hits, misses) == (0, 3)
    check(out, q, k, v)
    out, hits, misses = delta(lambda: fa.flash_attention(q, k, v))
    assert (hits, misses) == (3, 0)
    check(out, q, k, v)
    # a new buffer for q alone: its map is new, k's and v's are found
    q2 = q.clone() * 2
    out, hits, misses = delta(lambda: fa.flash_attention(q2, k, v))
    assert (hits, misses) == (2, 1)
    check(out, q2, k, v)
    # the same buffers read as another shape: (2, 512, 4, 64) over the same bytes
    qs, ks, vs = (t.view(2, 512, 4, 64) for t in (q, k, v))
    out, hits, misses = delta(lambda: fa.flash_attention(qs, ks, vs))
    assert (hits, misses) == (0, 3)
    check(out, qs, ks, vs)
    # the same first pointers and shape with other strides: views of (2, 1024, 4, 64),
    # which the wrapper passes through with their strides
    wide = qkv((2, 1024, 4, 64))
    packed = [t.view(-1)[:2 * 1024 * 2 * 64].view(2, 1024, 2, 64) for t in wide]
    narrow = [t[:, :, :2] for t in wide]
    assert [t.data_ptr() for t in packed] == [t.data_ptr() for t in narrow]
    out, hits, misses = delta(lambda: fa.flash_attention(*packed))
    assert (hits, misses) == (0, 3)
    check(out, *packed)
    out, hits, misses = delta(lambda: fa.flash_attention(*narrow))
    assert (hits, misses) == (0, 3)
    check(out, *narrow)
    out, hits, misses = delta(lambda: fa.flash_attention(*narrow))
    assert (hits, misses) == (3, 0)
    check(out, *narrow)


@pytest.mark.cuda
def test_rms_norm_and_cached_cast_on_card(cuda_device):
    """RMSNorm's ``F.rms_norm`` route against the written-out eight-op
    form on the card, at the main path's (8, 1024, 1024) bf16: torch's
    fused CUDA norm sums in another order, so a few outputs and input
    gradients move by one bf16 ulp; held to a relative Frobenius error of
    1e-4 and, in the bf16 output and input gradient, at most one element
    in 10^4 off (the f32 scale gradient, a sum over 8M products, moves in
    most elements within the 1e-4).  Dense's cached cast is
    bit-equal to ``.to`` in the forward and the gradients."""
    from traceml_tpu_torch.models.transformer import Dense, RMSNorm

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((8, 1024, 1024), generator=gen, device=cuda_device).to(torch.bfloat16)
    g = torch.randn((8, 1024, 1024), generator=gen, device=cuda_device).to(torch.bfloat16)
    norm = RMSNorm(1024, dtype=torch.bfloat16, device=cuda_device)
    with torch.no_grad():
        norm.scale.mul_(1.0 + 0.1 * torch.randn((1024,), generator=gen, device=cuda_device))
    xa = x.clone().requires_grad_()
    out = norm(xa)
    out.backward(g)
    xb = x.clone().requires_grad_()
    scale = norm.scale.detach().clone().requires_grad_()
    x32 = xb.float()
    ref = (x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6) * scale).to(torch.bfloat16)
    ref.backward(g)
    for got, want in ((out.detach(), ref.detach()), (xa.grad, xb.grad), (norm.scale.grad, scale.grad)):
        diff = (got.float() - want.float())
        assert (diff.norm() / want.float().norm()).item() <= 1e-4
    for got, want in ((out.detach(), ref.detach()), (xa.grad, xb.grad)):  # bf16: a few ulps moved
        assert (got != want).sum().item() <= max(1, got.numel() // 10_000)

    dense = Dense(1024, 1024, torch.bfloat16, torch.float32, cuda_device)
    with torch.no_grad():
        dense(x[:1])  # fills the cache
    xs = x[:1].clone().requires_grad_()
    y = dense(xs)
    y.backward(g[:1])
    w = dense.weight.detach().clone().requires_grad_()
    xr = x[:1].clone().requires_grad_()
    yr = torch.nn.functional.linear(xr, w.to(torch.bfloat16))
    yr.backward(g[:1])
    assert torch.equal(y, yr) and torch.equal(xs.grad, xr.grad) and torch.equal(dense.weight.grad, w.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,S,H,D,q_scale", CASES)
def test_kernel_matches_plain_on_card(cuda_device, dtype, B, S, H, D, q_scale):
    rng = np.random.default_rng(0)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32)).to(cuda_device)
        for _ in range(3)
    )
    q, k, v = (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)
    blk = 128 if S % 128 == 0 else 64
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, blk_q=blk, blk_k=blk)
    ref = fa.flash_attention_plain(q, k, v, blk, blk)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    assert bool(torch.isfinite(out).all())
    tol = TOLERANCES[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol["atol"], rtol=tol["atol"])
    got = compare(out, ref)
    assert got["ok"], got


@pytest.fixture()
def nccl_group(cuda_device):
    """A one-rank NCCL process group on the card, destroyed afterwards."""
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        yield cuda_device
    finally:
        dist.destroy_process_group()


def _rel(a, b):
    return float((a - b).float().norm() / b.float().norm())


@pytest.mark.cuda
def test_tensor_parallel_train_step_on_card(nccl_group):
    from traceml_tpu_torch.models import transformer as tf
    from traceml_tpu_torch.parallel.mesh import make_mesh

    cfg = dataclasses.replace(tf.ModelConfig.tiny(), hidden=256)  # head_dim 64, a width the kernel takes
    whole = {n: p.detach().clone() for n, p in tf.DecoderLM(cfg, device="cuda").state_dict().items()}
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 1025))).cuda()
    out = {}
    for name, c in (("dense", cfg), ("tensor", dataclasses.replace(cfg, mesh=make_mesh({"tensor": 1})))):
        model, optimizer = tf.init_train_state(c, state_dict=whole)
        assert model.tp == tf.TensorParallel(1, 0, None)
        step = tf.make_train_step(model, optimizer)
        before = fa.flash_attention.launches
        losses = [step(tokens)["loss"].item() for _ in range(2)]
        out[name] = (losses, fa.flash_attention.launches - before, dict(model.named_parameters()))
    assert out["tensor"][1] == out["dense"][1] == 2 * cfg.n_layers
    assert max(abs(a - b) / b for a, b in zip(out["tensor"][0], out["dense"][0])) <= 1e-5
    assert max(_rel(out["tensor"][2][n], p) for n, p in out["dense"][2].items()) <= 1e-5


@pytest.mark.cuda
def test_moe_block_on_card(nccl_group):
    from traceml_tpu_torch.models.moe import MoEBlock, init_expert_parallel, make_moe_train_step, moe_state_dict
    from traceml_tpu_torch.parallel.mesh import make_mesh

    whole = {n: t.cuda() for n, t in moe_state_dict(4, 64, 128, 0).items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 64, 64)).astype(np.float32)).cuda()
    y = torch.roll(x, 1, dims=-1)
    ref = MoEBlock(4, 64, 128)
    ref.load_state_dict(whole)
    placed = init_expert_parallel(4, 64, 128, make_mesh({"expert": 1}), state_dict=whole)["model"]
    got = {}
    for name, block in (("unsharded", ref), ("expert", placed)):
        _, step = make_moe_train_step(block)
        got[name] = [step(x, y)["loss"].item() for _ in range(3)]
    assert got["expert"][-1] < got["expert"][0]
    assert max(abs(a - b) / b for a, b in zip(got["expert"], got["unsharded"])) <= 1e-5


@pytest.mark.cuda
def test_pipeline_on_card(nccl_group):
    from traceml_tpu_torch.parallel.mesh import make_mesh
    from traceml_tpu_torch.parallel.pipeline import (init_linear_stages, linear_stage_apply, make_pipeline_fn,
                                                     shard_stage_params, stack_stage_params)

    stacked = stack_stage_params(init_linear_stages(1, 64, 0))
    mesh = make_mesh({"stage": 1})
    micro = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 8, 64)).astype(np.float32)).cuda()
    out = make_pipeline_fn(linear_stage_apply, mesh, 4)(shard_stage_params(stacked, mesh), micro)
    ref = linear_stage_apply({n: t[0] for n, t in stacked.items()}, micro)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_vit_traced_train_step_on_card(cuda_device):
    from traceml_tpu_torch.models.vit import ViT, ViTConfig, make_vit_train_step
    from traceml_tpu_torch.samplers.step_time_sampler import _aggregate_step
    from traceml_tpu_torch.sdk import initial
    from traceml_tpu_torch.sdk.instrumentation import trace_step
    from traceml_tpu_torch.sdk.state import reset_state_for_tests
    from traceml_tpu_torch.sdk.step_fn import wrap_step_fn
    from traceml_tpu_torch.utils import timing as T

    reset_state_for_tests()
    try:
        initial.init(mode="auto")
        model = ViT(ViTConfig.tiny())
        init, train_step = make_vit_train_step(model, learning_rate=5e-3)
        init(0)
        rng = np.random.default_rng(0)
        images = torch.from_numpy(rng.normal(size=(8, 32, 32, 3)).astype(np.float32)).cuda()
        labels = torch.from_numpy(rng.integers(0, 10, 8)).cuda()
        step = wrap_step_fn(train_step)
        T.GLOBAL_STEP_QUEUE.drain()
        losses = []
        for _ in range(10):
            with trace_step():
                losses.append(step(images, labels)["loss"])
        torch.cuda.synchronize()
        batches = T.GLOBAL_STEP_QUEUE.drain()
        for batch in batches:
            for ev in batch.events:
                ev.try_resolve(late=False)
        rows = [_aggregate_step(b.events)[0] for b in batches]
        assert len(rows) == 10 and all(r["clock"] == "device" for r in rows)
        assert not any(T.COMPILE_TIME in r["events"] for r in rows)
        assert losses[-1].item() < losses[0].item()
    finally:
        reset_state_for_tests()


@pytest.mark.cuda
def test_compile_tracker_under_inductor_on_card(cuda_device):
    import torch._dynamo

    from traceml_tpu_torch.models.mlp import TinyMLP
    from traceml_tpu_torch.sdk import initial
    from traceml_tpu_torch.sdk.instrumentation import trace_step
    from traceml_tpu_torch.sdk.state import get_state, reset_state_for_tests
    from traceml_tpu_torch.utils import timing as T

    torch._dynamo.reset()
    reset_state_for_tests()
    try:
        initial.init(mode="auto")
        model = torch.compile(TinyMLP(hidden=64, depth=2), dynamic=False)  # inductor
        T.GLOBAL_STEP_QUEUE.drain()
        for rows in (17, 17, 17, 18):
            with trace_step():
                model(torch.randn(rows, 64, device="cuda"))
        torch.cuda.synchronize()
        compiles = [(b.step, e.meta["trigger"]) for b in T.GLOBAL_STEP_QUEUE.drain()
                    for e in b.events if e.name == T.COMPILE_TIME]
        assert compiles == [(1, "dynamo"), (4, "dynamo")]
        assert get_state().compile_events_seen == 2
    finally:
        reset_state_for_tests()
        torch._dynamo.reset()
