"""Tests of the port that need the card.  They import no JAX, so they run
where the port runs: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Without a CUDA card they skip."""

import numpy as np
import pytest
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
