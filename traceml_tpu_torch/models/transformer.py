"""Flagship decoder-only LM (llama-style), in PyTorch.

Counterpart of ``traceml_tpu/models/transformer.py``: embedding, then
n × [RMSNorm → GQA attention with RoPE → RMSNorm → SwiGLU], a final
RMSNorm and an f32 ``lm_head``.  Numerics follow the flax module:

* linear layers and the embedding compute in ``dtype`` (flax casts its
  f32 params to ``dtype`` at each call; storing them in ``dtype`` gives
  the same products);
* RMSNorm scales are f32 and the norm computes in f32, then casts;
* RoPE is the half-split rotation, computed in f32, cast back;
* GQA repeats each kv head in place (``repeat_interleave``), as
  ``jnp.repeat(k, group, axis=2)`` does;
* ``lm_head`` promotes the activations to f32: the logits are f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from traceml_tpu_torch.ops.attention import causal_attention
from traceml_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    ffn_mult: float = 2.6667  # SwiGLU hidden = mult * hidden (rounded)
    max_seq_len: int = 1024
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    @property
    def ffn_hidden(self) -> int:
        # rounded to a multiple of 128, as the JAX config does
        h = int(self.hidden * self.ffn_mult)
        return max(128, (h + 127) // 128 * 128)

    @classmethod
    def tiny(cls) -> "ModelConfig":
        return cls(vocab_size=256, hidden=128, n_layers=2, n_heads=4,
                   n_kv_heads=2, max_seq_len=128)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.bfloat16,
                 device: Any = None) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.scale).to(self.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings over the last dim of x: (..., seq, heads, head_dim)."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta)
        * (2.0 * torch.arange(half, dtype=torch.float32, device=x.device) / head_dim)
    )
    angles = positions[..., None].float() * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def _linear(d_in: int, d_out: int, dtype: torch.dtype, device: Any) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, dtype=dtype, device=device)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: Any) -> None:
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.wq = _linear(cfg.hidden, cfg.n_heads * hd, dtype, device)
        self.wk = _linear(cfg.hidden, cfg.n_kv_heads * hd, dtype, device)
        self.wv = _linear(cfg.hidden, cfg.n_kv_heads * hd, dtype, device)
        self.wo = _linear(cfg.n_heads * hd, cfg.hidden, dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.head_dim
        q = self.wq(x).view(B, S, cfg.n_heads, hd)
        k = self.wk(x).view(B, S, cfg.n_kv_heads, hd)
        v = self.wv(x).view(B, S, cfg.n_kv_heads, hd)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        # GQA: each kv head repeats in place up to n_heads
        group = cfg.n_heads // cfg.n_kv_heads
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
        out = causal_attention(q, k, v)  # (B, S, heads, hd)
        return self.wo(out.reshape(B, S, cfg.n_heads * hd))


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: Any) -> None:
        super().__init__()
        self.w_gate = _linear(cfg.hidden, cfg.ffn_hidden, dtype, device)
        self.w_up = _linear(cfg.hidden, cfg.ffn_hidden, dtype, device)
        self.w_down = _linear(cfg.ffn_hidden, cfg.hidden, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: Any) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp_norm = RMSNorm(cfg.hidden, dtype=dtype, device=device)
        self.mlp = MLP(cfg, dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class DecoderLM(nn.Module):
    """``DecoderLM(cfg, device=..., dtype=...)``; ``dtype`` defaults to
    ``cfg.dtype``, ``device`` to CUDA (``device="cpu"`` to run on the CPU)."""

    def __init__(self, cfg: ModelConfig, *, device: Any = "cuda",
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or cfg.dtype
        self.cfg = cfg
        self.dtype = dtype
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden, dtype=dtype, device=dev)
        self.layers = nn.ModuleList(Block(cfg, dtype, dev) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.hidden, dtype=dtype, device=dev)
        self.lm_head = _linear(cfg.hidden, cfg.vocab_size, torch.float32, dev)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        x = self.embed(tokens)
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        for layer in self.layers:
            x = layer(x, positions)
        x = self.final_norm(x)
        return self.lm_head(x.float())


def loss_fn(model: DecoderLM, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (inputs=tokens[:, :-1], targets=[:, 1:])."""
    logits = model(tokens[:, :-1])
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean()
