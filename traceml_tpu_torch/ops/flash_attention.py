"""Causal flash attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``traceml_tpu/ops/pallas_attention.py``.  ``flash_attention``
takes q, k, v as (B, S, H, D), the layout of the JAX wrapper, and returns
softmax(Q Kᵀ / √D) V under a causal mask in the same layout.

* On CUDA tensors it launches ``csrc/flash_attention_fwd.cu`` (built by
  ``ops/_build.py`` at first use) or raises: there is no other path.
  bf16 runs on the tensor cores (``wgmma``, K/V streamed by TMA through
  an ``mbarrier`` ring); f32 runs on the CUDA cores.
* On CPU tensors it runs :func:`flash_attention_plain`, the same blocked
  online softmax written in plain PyTorch with f32 math.

It is the custom op ``torch.ops.traceml_tpu_torch.flash_attention``, so
autograd and ``FlopCounterMode`` see it.  Its backward is the op
``flash_attention_backward``: plain PyTorch that recomputes the masked
einsum attention of ``ops/attention.py:attention_reference`` from the
saved q, k and v and returns its gradients dq, dk and dv.  The JAX
package has no backward kernel either: under ``jax.grad`` its dispatcher
runs the jnp reference, so its train step differentiates the same
einsums.  Both ops
carry a FLOP formula with the count XLA gives the jnp path, the full
S×S products (not half for the causal mask): 4·B·H·S²·D forward,
8·B·H·S²·D backward.  The recompute inside the backward is not counted:
it is not the model's work.

``flash_attention.launches`` counts kernel launches (forward only), so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from traceml_tpu_torch.ops import _build

_NEG_INF = -1e30
KERNEL = "flash_attention_fwd"
#: S must be a multiple of this; the bf16 kernel masks a ragged last
#: 128-row tile (S = 64 * odd) itself
KERNEL_SEQ_MULTIPLE = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _check_blocks(S: int, blk_q: int, blk_k: int) -> tuple:
    blk_q = min(blk_q, S)
    blk_k = min(blk_k, S)
    if S % blk_q or S % blk_k:
        raise ValueError(f"S={S} not divisible by blocks ({blk_q},{blk_k})")
    return blk_q, blk_k


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    blk_q: int = 128,
    blk_k: int = 128,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per q block, an online softmax
    over the k blocks up to the causal diagonal, with f32 ``m``/``l``/``acc``
    and the output cast to the input dtype (as ``_flash_kernel`` does)."""
    B, S, H, D = q.shape
    blk_q, blk_k = _check_blocks(S, blk_q, blk_k)
    scale = 1.0 / (D ** 0.5)
    qf = q.float().permute(0, 2, 1, 3) * scale  # (B, H, S, D)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty_like(qf)
    for q_start in range(0, S, blk_q):
        qb = qf[:, :, q_start:q_start + blk_q]
        m = torch.full((B, H, blk_q, 1), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, blk_q, D), dtype=torch.float32, device=q.device)
        q_ids = torch.arange(q_start, q_start + blk_q, device=q.device)[:, None]
        n_kv = (q_start + blk_q + blk_k - 1) // blk_k
        for j in range(n_kv):
            kb = kf[:, :, j * blk_k:(j + 1) * blk_k]
            vb = vf[:, :, j * blk_k:(j + 1) * blk_k]
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kb)
            k_ids = torch.arange(j * blk_k, (j + 1) * blk_k, device=q.device)[None, :]
            s = torch.where(q_ids >= k_ids, s, torch.full_like(s, _NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vb)
            m = m_new
        out[:, :, q_start:q_start + blk_q] = acc / l
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _load_kernel() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 4 + [i32] * 5 + [i64] * 12 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


def kernel_smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory of one block of the kernel, in bytes (builds
    the kernel library if it is not built yet)."""
    return _load_kernel().flash_attention_smem_bytes(_DTYPE_CODES[dtype], head_dim)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    B, S, H, D = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must match q in shape, dtype and device: "
                f"{tuple(t.shape)} {t.dtype} {t.device} vs "
                f"{tuple(q.shape)} {q.dtype} {q.device}"
            )
    if not all(t.is_cuda for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, not {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {_HEAD_DIMS}, not {D}")
    if S % KERNEL_SEQ_MULTIPLE:
        raise ValueError(
            f"flash_attention kernel needs S divisible by {KERNEL_SEQ_MULTIPLE}, got {S}"
        )
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    lib = _load_kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        strides = []
        for t in (q, k, v, out):
            strides.extend(t.stride()[:3])
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, D, _DTYPE_CODES[q.dtype], *strides,
            1.0 / math.sqrt(D), stream,
        )
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} ({err})")
    flash_attention.launches += 1
    return out


@torch.library.custom_op("traceml_tpu_torch::flash_attention", mutates_args=())
def _flash_attention_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, blk_q: int, blk_k: int
) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, blk_q, blk_k)
    return _launch(q, k, v)


@torch.library.custom_op("traceml_tpu_torch::flash_attention_backward", mutates_args=())
def _flash_attention_backward_op(
    grad_out: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of causal attention: the probabilities of
    ``attention_reference`` recomputed from q, k and v, then its gradient
    step by step, with the reference's casts (scores and softmax in f32,
    the products in the input dtype).  A custom op's body runs below
    autograd, so the gradient is written out rather than taken with
    ``torch.autograd.grad``; ``tests/test_torch_train_step.py`` holds it
    to autograd through the reference and to ``jax.grad``."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    del scores
    dv = torch.einsum("bhqk,bqhd->bkhd", probs.to(q.dtype), grad_out)
    dprobs = torch.einsum("bqhd,bkhd->bhqk", grad_out, v).float()
    # softmax backward; masked entries have p = 0, so their gradient is 0
    dscores = probs * (dprobs - (dprobs * probs).sum(dim=-1, keepdim=True))
    del probs, dprobs
    dscores = (dscores * scale).to(q.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", dscores, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", dscores, q)
    return dq, dk, dv


def _setup_context(ctx, inputs, output) -> None:
    q, k, v, _, _ = inputs
    ctx.save_for_backward(q, k, v)


def _backward(ctx, grad_out):
    dq, dk, dv = _flash_attention_backward_op(grad_out, *ctx.saved_tensors)
    return dq, dk, dv, None, None


_flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.traceml_tpu_torch.flash_attention)
def _forward_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    B, S, H, D = q_shape
    return 4 * B * H * S * S * D  # Q Kᵀ and P V, 2·S²·D each


@register_flop_formula(torch.ops.traceml_tpu_torch.flash_attention_backward)
def _backward_flops(grad_shape, q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    B, S, H, D = q_shape
    return 8 * B * H * S * S * D  # dP, dV, dQ and dK, 2·S²·D each


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    blk_q: int = 128,
    blk_k: int = 128,
) -> torch.Tensor:
    """Causal flash attention; q, k, v: (B, S, H, D) → (B, S, H, D).

    ``blk_q``/``blk_k`` are clamped to S and must divide it (``ValueError``
    otherwise), as in the JAX wrapper; they set the plain version's blocks.
    The kernel tiles by its own blocks whatever they are: 128 query rows
    by 128-key tiles in bf16, 64 by 64 in f32 (``csrc/flash_attention_fwd.cu``).
    Differentiable: the backward is :func:`_flash_attention_backward_op`.
    """
    blk_q, blk_k = _check_blocks(q.shape[1], blk_q, blk_k)
    return _flash_attention_op(q, k, v, blk_q, blk_k)


flash_attention.launches = 0
