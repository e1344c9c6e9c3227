"""Vision Transformer encoder, the second model family.

Counterpart of ``traceml_tpu/models/vit.py``: a stride-p patch embedding,
a learned position embedding, n × [RMSNorm → bidirectional attention →
RMSNorm → GELU MLP], a final RMSNorm, a mean-pool over the patches and an
f32 classifier head.  It exercises the NON-causal attention path: the
einsum reference (``ops/attention.py:attention_reference(causal=False)``)
as in JAX, whose ViT never reaches the Pallas kernel, so no kernel of the
port runs here.  Numerics follow the flax modules:

* parameters are f32 and cast to ``dtype`` at each call (``Dense``,
  :class:`BiasedDense`); ``wq wk wv wo`` have no bias, ``w_up``,
  ``w_down``, the patch embedding and the head have one;
* the patch embedding is flax's ``Conv(hidden, (p, p), strides=(p, p),
  padding="SAME")`` on (B, H, W, C) images.  With kernel = stride = p and
  H, W divisible by p the padding is zero and the conv is one GEMM of
  each flattened (p, p, C) patch: :class:`PatchEmbed` keeps its weight as
  (hidden, p·p·C) in that (row, column, channel) order, and its patches
  row-major over (H/p, W/p), the order of ``pos_embed``;
* the MLP's GELU is flax's default, the tanh approximation;
* the mean-pool runs in ``dtype``, then the head promotes to f32: the
  logits are f32.

``ViTConfig`` adds ``channels`` (3) to the JAX fields: flax infers the
input channels from the first call, a torch module needs them up front.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from traceml_tpu_torch.models.transformer import Dense, RMSNorm
from traceml_tpu_torch.ops.attention import attention_reference
from traceml_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 64
    patch_size: int = 8
    hidden: int = 256
    n_layers: int = 4
    n_heads: int = 4
    ffn_mult: float = 4.0
    n_classes: int = 10
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    channels: int = 3

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def ffn_hidden(self) -> int:
        return int(self.hidden * self.ffn_mult)

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(image_size=32, patch_size=8, hidden=64, n_layers=2, n_heads=2)


class BiasedDense(Dense):
    """``Dense`` with an f32 bias, cast to ``dtype`` with the weight at
    each call (flax ``Dense(use_bias=True)``; the bias starts at 0)."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, param_dtype: torch.dtype, device: Any) -> None:
        super().__init__(d_in, d_out, dtype, param_dtype, device)
        self.bias = nn.Parameter(torch.zeros(d_out, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class PatchEmbed(BiasedDense):
    """(B, H, W, C) images → (B, (H/p)·(W/p), hidden): each p × p patch
    flattened in (row, column, channel) order, then one GEMM."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype, device: Any) -> None:
        p = cfg.patch_size
        if cfg.image_size % p:
            raise ValueError(f"image_size {cfg.image_size} is not a multiple of patch_size {p}")
        super().__init__(p * p * cfg.channels, cfg.hidden, dtype, cfg.param_dtype, device)
        self.patch = p

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, C = images.shape
        p = self.patch
        if H % p or W % p:
            raise ValueError(f"images {H}x{W} are not a multiple of the patch size {p}")
        x = images.to(self.dtype).reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        return super().forward(x.reshape(B, (H // p) * (W // p), p * p * C))


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype, device: Any) -> None:
        super().__init__()
        H, pd = cfg.hidden, cfg.param_dtype
        self.n_heads = cfg.n_heads
        self.attn_norm = RMSNorm(H, dtype=dtype, device=device)
        self.wq, self.wk, self.wv, self.wo = (Dense(H, H, dtype, pd, device) for _ in range(4))
        self.mlp_norm = RMSNorm(H, dtype=dtype, device=device)
        self.w_up = BiasedDense(H, cfg.ffn_hidden, dtype, pd, device)
        self.w_down = BiasedDense(cfg.ffn_hidden, H, dtype, pd, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, H = x.shape
        y = self.attn_norm(x)
        q, k, v = (w(y).reshape(B, S, self.n_heads, H // self.n_heads) for w in (self.wq, self.wk, self.wv))
        x = x + self.wo(attention_reference(q, k, v, causal=False).reshape(B, S, H))
        h = self.w_up(self.mlp_norm(x))
        return x + self.w_down(F.gelu(h, approximate="tanh"))


class ViT(nn.Module):
    """``ViT(cfg, device=..., dtype=...)``: (B, H, W, C) images → (B,
    n_classes) f32 logits.  ``dtype`` defaults to ``cfg.dtype``,
    ``device`` to CUDA (``device="cpu"`` to run on the CPU)."""

    def __init__(self, cfg: ViTConfig, *, device: Any = "cuda", dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or cfg.dtype
        self.cfg = cfg
        self.dtype = dtype
        self.patch_embed = PatchEmbed(cfg, dtype, dev)
        self.pos_embed = nn.Parameter(torch.empty((1, cfg.n_patches, cfg.hidden), dtype=cfg.param_dtype,
                                                  device=dev))
        self.layers = nn.ModuleList(EncoderBlock(cfg, dtype, dev) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.hidden, dtype=dtype, device=dev)
        self.head = BiasedDense(cfg.hidden, cfg.n_classes, torch.float32, cfg.param_dtype, dev)
        self.reset_parameters(0)

    def reset_parameters(self, seed: int) -> None:
        """Draw every weight from ``seed`` on the CPU (flax's inits up to
        their truncation: N(0, 1/fan_in) kernels, N(0, 0.02²) positions,
        zero biases, unit norm scales), so a seed gives the same model on
        every device."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf == "bias":
                    p.zero_()
                elif leaf == "scale":
                    p.fill_(1.0)
                elif name == "pos_embed":
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
                else:
                    p.copy_(torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(images) + self.pos_embed.to(self.dtype)
        for layer in self.layers:
            x = layer(x)
        x = self.final_norm(x).mean(dim=1)  # mean-pool the patches, in dtype
        return self.head(x)


def make_vit_train_step(model: ViT, learning_rate: float = 1e-3) -> Tuple[Callable, Callable]:
    """``(init, train_step)`` as the JAX function returns, here closures
    over the module and AdamW with optax ``adamw``'s defaults (β 0.9,
    0.999, ε 1e-8, weight decay 1e-4 on every parameter; torch's default
    decay is 1e-2).  ``init(seed=0, state_dict=None)`` sets the weights
    and returns a fresh optimizer; ``train_step(images, labels)`` is one
    step on the cross entropy of the f32 logits and returns ``{"loss":
    loss}``, detached and unsynchronized."""
    optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)

    def init(seed: int = 0, state_dict: Optional[Mapping[str, torch.Tensor]] = None) -> torch.optim.AdamW:
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            model.reset_parameters(seed)
        optimizer.state.clear()
        return optimizer

    def train_step(images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        loss = F.cross_entropy(model(images), labels.long())
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return {"loss": loss.detach()}

    return init, train_step
