"""Causal attention: the einsum reference path and the flash path.

Counterpart of ``traceml_tpu/ops/attention.py``.  ``causal_attention``
picks a path with one explicit predicate, :func:`attention_route`:

* ``"kernel"``: S ≥ 1024, both flash blocks divide S, tensor on CUDA —
  the CUDA flash kernel;
* ``"plain"``: the same on a CPU tensor — the kernel's plain version;
* ``"reference"``: everything else — :func:`attention_reference`.

A failure on the flash path propagates; nothing falls back, under
autograd either.  The one difference from the JAX dispatcher: under
``jax.grad`` the Pallas kernel fails and JAX runs the jnp reference, while
the port's "kernel" route holds under autograd too: the forward launches
the CUDA kernel and the backward is plain PyTorch
(``flash_attention_backward``, the gradient of :func:`attention_reference`).
"""

from __future__ import annotations

import math

import torch

from traceml_tpu_torch.ops.flash_attention import flash_attention

_PALLAS_MIN_SEQ = 1024  # the JAX package's threshold, kept for parity
_FLASH_BLOCKS = (128, 128)  # flash_attention's default (blk_q, blk_k)


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """q, k, v: (B, S, H, D) → (B, S, H, D); softmax(QKᵀ)V, optionally
    causal-masked.  Scores masked at −1e30, softmax in f32, probabilities
    cast to the input dtype."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    return attention_reference(q, k, v, causal=True)


def attention_route(seq_len: int, device_type: str) -> str:
    """"kernel", "plain" or "reference" for a sequence length and device."""
    blocks_divide = all(seq_len % min(b, seq_len) == 0 for b in _FLASH_BLOCKS)
    if seq_len < _PALLAS_MIN_SEQ or not blocks_divide:
        return "reference"
    return "kernel" if device_type == "cuda" else "plain"


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if attention_route(q.shape[1], q.device.type) == "reference":
        return causal_attention_reference(q, k, v)
    # flash_attention launches the kernel on CUDA, its plain version on CPU
    return flash_attention(q, k, v)
