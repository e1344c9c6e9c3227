"""The checks that hold the flash kernel against its plain version
(``traceml_tpu_torch.dev.attention_check``) on the CPU: an emulation of
the sound bf16 kernel passes them, and each planted fault fails the
checks that scale with the output, not only ``allclose``."""

import numpy as np
import pytest
pytest.importorskip("torch")  # a checkout without torch still collects
import torch

from traceml_tpu_torch.dev.attention_check import TOLERANCES, compare, dense_causal, planted_faults
from traceml_tpu_torch.ops.flash_attention import flash_attention_plain


def _qkv(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype) for _ in range(3)
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
def test_sound_output_passes(dtype, D):
    # bf16: the kernel's own roundings (P to bf16 before P·V)
    q, k, v = _qkv((1, 512, 2, D), dtype)
    ref = flash_attention_plain(q, k, v)
    got = compare(dense_causal(q, k, v, torch.bfloat16 if dtype == torch.bfloat16 else None), ref)
    assert got["ok"], got


@pytest.mark.parametrize("fault", ["p_fp8", "kv_tile_from_previous_stage", "k_tile_zeroed"])
@pytest.mark.parametrize("D", [64, 128])
def test_planted_fault_fails_the_scaled_checks(fault, D):
    q, k, v = _qkv((1, 512, 2, D), torch.bfloat16)
    ref = flash_attention_plain(q, k, v)
    got = compare(planted_faults(q, k, v)[fault], ref)
    tol = TOLERANCES[torch.bfloat16]
    assert not got["ok"]
    assert got["rel_fro"] > tol["rel_fro"] and got["row_rel_max"] > tol["row_rel_max"], got
