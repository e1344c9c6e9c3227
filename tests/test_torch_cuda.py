"""Tests of the port that need the card.  They import no JAX, so they run
where the port runs: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Without a CUDA card they skip."""

import numpy as np
import pytest
import torch

from traceml_tpu_torch.ops import flash_attention as fa


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 1e-4)])
def test_kernel_matches_plain_on_card(cuda_device, D, dtype, tol):
    rng = np.random.default_rng(0)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((2, 1024, 2, D)).astype(np.float32)).to(cuda_device, dtype)
        for _ in range(3)
    )
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
