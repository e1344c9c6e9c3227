"""Flagship decoder-only LM (llama-style), in PyTorch.

Counterpart of ``traceml_tpu/models/transformer.py``: embedding, then
n × [RMSNorm → GQA attention with RoPE → RMSNorm → SwiGLU], a final
RMSNorm and an f32 ``lm_head``.  Numerics follow the flax module:

* linear and embedding weights are stored in ``param_dtype`` (f32) and
  cast to ``dtype`` at each call, as flax's ``Dense(dtype=bf16,
  param_dtype=f32)`` does.  Storing them in bf16 would give the same
  forward products but not the same training: AdamW's update of
  ``lr·m̂/√v̂`` (~3e-4) is below half a bf16 ulp of most weights, so a
  bf16 parameter would lose most of it;
* RMSNorm scales are f32 and the norm computes in f32, then casts;
* RoPE is the half-split rotation, computed in f32, cast back;
* GQA repeats each kv head in place (``repeat_interleave``), as
  ``jnp.repeat(k, group, axis=2)`` does;
* ``lm_head`` promotes the activations to f32: the logits are f32.  The
  flax ``Dense(dtype=float32)`` sets no ``precision``, so XLA's DEFAULT
  leaves it to the backend: TF32 on a Hopper GPU.  The port runs the
  ``lm_head``'s three GEMMs (forward and both gradients) at TF32 and no
  other matmul (``TF32Dense``); on the CPU TF32 does not exist and
  nothing changes;
* ``remat`` checkpoints each block, as ``nn.remat(Block)`` does: the
  forward keeps only each block's input, and the backward recomputes the
  block's forward (``torch.utils.checkpoint``, non-reentrant) before
  differentiating it.  The flash kernel then runs twice a layer and a
  step, once in the forward and once in the recompute.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    param_dtype: torch.dtype = torch.float32
    remat: bool = False

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


class Dense(nn.Module):
    """A bias-free linear layer with its weight, (out, in) as in
    ``nn.Linear``, stored in ``param_dtype``; input and weight are cast
    to ``dtype`` at each call."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: Any) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty((d_out, d_in), dtype=param_dtype, device=device))
        nn.init.normal_(self.weight, std=d_in ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


@contextlib.contextmanager
def tf32_matmul() -> Iterator[None]:
    """CUDA f32 matmuls at TF32 inside the block; on exit every
    precision flag reads what it read before, whichever API the caller
    set them with.

    The legacy ``allow_tf32`` flag and ``fp32_precision`` are one state
    that torch checks for consistency, and a mix of the two APIs makes the
    legacy getter raise.  So: already TF32 → nothing to do; a legacy
    precision of "high" or "medium" → set only ``fp32_precision``; at
    "highest" → the legacy setter, which sets both, and on exit
    ``set_float32_matmul_precision("highest")`` plus the two per-backend
    values it touches.  A state the legacy getter cannot read (the caller
    mixed the APIs) is left alone."""
    cuda_mm = torch.backends.cuda.matmul
    before = cuda_mm.fp32_precision
    try:
        legacy = torch.get_float32_matmul_precision() if before != "tf32" else None
    except RuntimeError:
        legacy = None
    if legacy is None:
        yield
        return
    mkldnn_before = torch.backends.mkldnn.matmul.fp32_precision
    if legacy == "highest":
        cuda_mm.allow_tf32 = True
    else:
        cuda_mm.fp32_precision = "tf32"
    try:
        yield
    finally:
        if legacy == "highest":
            torch.set_float32_matmul_precision("highest")
            torch.backends.mkldnn.matmul.fp32_precision = mkldnn_before
        cuda_mm.fp32_precision = before


class _TF32Linear(torch.autograd.Function):
    """``F.linear(x, w)`` whose forward GEMM and both gradient GEMMs run
    under ``tf32_matmul``: autograd runs the backward later, maybe on its
    own thread, after a context around the forward has closed."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        with tf32_matmul():
            return F.linear(x, w)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        x, w = ctx.saved_tensors
        gx = gw = None
        with tf32_matmul():
            if ctx.needs_input_grad[0]:
                gx = grad.matmul(w)
            if ctx.needs_input_grad[1]:
                gw = grad.reshape(-1, grad.shape[-1]).t().mm(x.reshape(-1, x.shape[-1]))
        return gx, gw


class TF32Dense(Dense):
    """``Dense`` whose GEMMs run at TF32 on a GPU: the ``lm_head``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _TF32Linear.apply(x.to(self.dtype), self.weight.to(self.dtype))


class Embed(nn.Module):
    """Token embedding stored in ``param_dtype``; the gathered rows are
    cast to ``dtype`` (the same values as flax, which casts the table
    first, without casting all of it)."""

    def __init__(self, vocab: int, dim: int, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: Any) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty((vocab, dim), dtype=param_dtype, device=device))
        nn.init.normal_(self.weight)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.weight).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: Any) -> None:
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        pd = cfg.param_dtype
        self.wq = Dense(cfg.hidden, cfg.n_heads * hd, dtype, pd, device)
        self.wk = Dense(cfg.hidden, cfg.n_kv_heads * hd, dtype, pd, device)
        self.wv = Dense(cfg.hidden, cfg.n_kv_heads * hd, dtype, pd, device)
        self.wo = Dense(cfg.n_heads * hd, cfg.hidden, dtype, pd, device)

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
        pd = cfg.param_dtype
        self.w_gate = Dense(cfg.hidden, cfg.ffn_hidden, dtype, pd, device)
        self.w_up = Dense(cfg.hidden, cfg.ffn_hidden, dtype, pd, device)
        self.w_down = Dense(cfg.ffn_hidden, cfg.hidden, dtype, pd, device)

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
        self.embed = Embed(cfg.vocab_size, cfg.hidden, dtype, cfg.param_dtype, dev)
        self.layers = nn.ModuleList(Block(cfg, dtype, dev) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.hidden, dtype=dtype, device=dev)
        self.lm_head = TF32Dense(cfg.hidden, cfg.vocab_size, torch.float32, cfg.param_dtype, dev)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        x = self.embed(tokens)
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        for layer in self.layers:
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, positions, use_reentrant=False)
            else:
                x = layer(x, positions)
        return self.lm_head(self.final_norm(x))


def loss_fn(model: DecoderLM, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (inputs=tokens[:, :-1], targets=[:, 1:])."""
    logits = model(tokens[:, :-1])
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean()


# -- training ------------------------------------------------------------


def init_train_state(
    cfg: ModelConfig,
    *,
    device: Any = "cuda",
    learning_rate: float = 3e-4,
    seed: int = 0,
) -> Tuple[DecoderLM, torch.optim.AdamW]:
    """``(model, optimizer)``: a DecoderLM initialised from ``seed`` and
    AdamW with weight decay 0.01 on every parameter, as the JAX
    ``init_train_state`` builds with ``optax.adamw(lr, weight_decay=0.01)``.
    ``cfg.remat`` checkpoints each block, as in the JAX model.

    Torch's AdamW and optax's compute the same update,
    ``p ← p − lr·(m̂/(√v̂+ε) + wd·p)`` with the decay read from the
    parameter before the update and the same bias corrections
    (``tests/test_torch_train_step.py`` holds the two to it).  The
    moments and step counts are made here, as ``tx.init(params)`` makes
    them, so the first step does not allocate 2 × the parameters' bytes.
    """
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        model = DecoderLM(cfg, device=dev)
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01
    )
    for group in optimizer.param_groups:
        for p in group["params"]:
            optimizer.state[p] = {
                # on the host, as torch's own lazy init puts it
                "step": torch.tensor(0.0),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }
    return model, optimizer


def make_train_step(
    model: DecoderLM, optimizer: torch.optim.Optimizer
) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """The train step ``step(tokens) → {"loss": loss}``: the loss of
    ``tokens`` (B, S+1), its gradients, one optimizer update, and the
    gradients freed.  The loss is returned on the device, unsynchronized."""

    def train_step(tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        loss = loss_fn(model, tokens)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return {"loss": loss.detach()}

    return train_step
