"""Flagship decoder-only LM (llama-style), in PyTorch.

Counterpart of ``traceml_tpu/models/transformer.py``: embedding, then
n × [RMSNorm → GQA attention with RoPE → RMSNorm → SwiGLU], a final
RMSNorm and an f32 ``lm_head``.  Numerics follow the flax module:

* linear and embedding weights are stored in ``param_dtype`` (f32) and
  cast to ``dtype`` at each call, as flax's ``Dense(dtype=bf16,
  param_dtype=f32)`` does.  Storing them in bf16 would give the same
  forward products but not the same training: AdamW's update of
  ``lr·m̂/√v̂`` (~3e-4) is below half a bf16 ulp of most weights, so a
  bf16 parameter would lose most of it.  A linear layer keeps its cast
  weight while the weight is unchanged (``Dense.cast_weight``): the
  forward loop casts once, the train step once a step, in its optimizer
  step;
* RMSNorm scales are f32 and the norm computes in f32 (``F.rms_norm``),
  then casts;
* RoPE is the half-split rotation, computed in f32, cast back; its cos
  and sin tables are computed once a forward from the positions and
  shared by every layer, and the rotation runs as x·cos + [x2, x1]·[−sin,
  sin]: the same IEEE operations on the same values in fewer kernels.
  The forward loop is paced by the host's enqueue of its kernels, so
  each kernel a layer saves is host time;
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

Parallelism.  JAX partitions the global arrays with GSPMD; each rank of
the port runs its own piece (SPMD) and does by hand what the compiler
did:

* ``ModelConfig(attention_impl="ring" | "ulysses", context_axis=...,
  mesh=...)`` shards attention BY SEQUENCE over the mesh's context axis
  (``ops/ring_attention.py``, ``ops/ulysses_attention.py``).
  :func:`loss_fn` takes the GLOBAL token batch, shifts it into inputs
  and targets, then keeps this rank's piece of both by
  :func:`seq_parallel_spec` (batch over the data-parallel axes, sequence
  over the context axis); ``DecoderLM.forward`` then takes the local
  sequence shard and builds GLOBAL RoPE positions (offset by the rank's
  context coordinate × S_local).  Every shard holds as many tokens, so
  JAX's global-mean cross-entropy is the mean of the local means: the
  train step averages the loss, and the gradients, over the mesh.
* ``init_train_state(mesh=...)`` applies :func:`param_shardings`'s
  ``fsdp`` part through FSDP2 (``fully_shard`` on each block and the
  root, each parameter sharded on the dim JAX's spec shards over
  ``fsdp``).  Parameters are replicated across ``context``, so FSDP2
  shards over the flattened ``fsdp × context`` mesh (torchtitan's
  recipe; HSDP with ``data`` as the replicate dim when it is > 1) and its
  reduce-scatter averages over both; JAX shards over ``fsdp`` only.
  Without FSDP the train step averages the gradients over the batch and
  context ranks after the backward (``make_train_step``'s ``grad_sync``
  path).
* A ``tensor`` axis in ``cfg.mesh`` makes the model tensor-parallel, by
  JAX's :func:`param_shardings` layout (Megatron's): each rank holds its
  slice of ``wq wk wv w_gate w_up lm_head`` split on the output features
  (:class:`ColumnParallelDense`), of ``wo w_down`` split on the input
  features with a sum over ``tensor`` after the product
  (:class:`RowParallelDense`), and of the embedding split on hidden
  (:class:`HiddenParallelEmbed`, its rows gathered after the lookup).
  Attention runs on the rank's ``n_heads/T`` query and ``n_kv_heads/T``
  kv heads.  The cross-rank edges are the autograd collectives of
  ``parallel/comm.py``: a replicated activation enters each attention,
  MLP and the ``lm_head`` through ``copy_to_group`` (its gradient summed
  over ``tensor``), the row-parallel products leave through
  ``reduce_from_group``.  The loss gathers the vocabulary-sharded logits
  (``gather_from_group``) and takes the log-softmax over the whole
  vocabulary on every rank, JAX's cross-entropy on the same values.  At
  ``tensor`` = 1 every collective is skipped and each slice is whole.  ``init_train_state`` cuts each rank's slice from a global
  ``state_dict`` (``models/convert.py:local_state_dict``); the gradients
  are never averaged over ``tensor``, whose ranks hold different slices.
  Head counts or widths that do not divide by the axis raise
  ``ValueError``.  A model without a ``tensor`` axis (no mesh, or a mesh
  without one) is the same model at ``tensor`` = 1: one set of modules
  serves every mesh.  The DecoderLM has no ``expert`` or ``stage`` axis: a
  mesh with one raises ``NotImplementedError`` naming the modules that
  take them (``models/moe.py``, ``parallel/pipeline.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from traceml_tpu_torch.ops.attention import causal_attention
from traceml_tpu_torch.parallel.comm import copy_to_group, gather_from_group, reduce_from_group
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
    # sequence/context parallelism: "dense" runs attention on this rank's
    # tensors whole; "ring" / "ulysses" shard it BY SEQUENCE over
    # ``context_axis`` of ``mesh`` (a DeviceMesh; set both)
    attention_impl: str = "dense"
    context_axis: Any = None     # mesh axis name, e.g. "context"
    mesh: Any = None             # torch.distributed DeviceMesh

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
        # x·rsqrt(mean(x²) + eps)·scale in f32, as three kernels on CUDA
        # (upcast, torch's fused norm, cast) where the written-out form
        # took eight; on the CPU the same IEEE operations
        return F.rms_norm(x.float(), self.scale.shape, self.scale, self.eps).to(self.dtype)


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE's tables for ``positions`` (..., seq), f32, shaped to
    broadcast over heads, (..., seq, 1, head_dim): cos repeated over both
    halves, and sin with its first half negated, [−sin, sin]."""
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta)
        * (2.0 * torch.arange(half, dtype=torch.float32, device=positions.device) / head_dim)
    )
    angles = positions[..., None].float() * freqs  # (..., seq, half)
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The half-split rotation of x (..., seq, heads, head_dim) by the
    tables of :func:`_rope_tables`, in f32, cast back: [x1·cos − x2·sin,
    x2·cos + x1·sin] computed as x·cos + [x2, x1]·[−sin, sin].  These are
    the same IEEE operations on the same values (a − b is a + (−b), and
    x2·(−s) is −(x2·s), exactly), forward and backward, in fewer kernels:
    the halves swap in one ``roll`` and the sign rides in the table,
    made once a forward."""
    xf = x.float()
    return (xf * cos + xf.roll(x.shape[-1] // 2, -1) * sin).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings over the last dim of x: (..., seq, heads, head_dim)."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1], theta))


def _mesh_axes(mesh) -> Dict[str, int]:
    from traceml_tpu_torch.parallel.mesh import axis_sizes

    return axis_sizes(mesh)


def seq_parallel_spec(cfg: "ModelConfig", batch_size: Optional[int] = None) -> Tuple[Any, ...]:
    """Placements (one per mesh dim) of the (B, S, heads, hd) q/k/v under
    sequence parallelism: JAX's ``PartitionSpec`` as DTensor placements.

    Batch shards over whichever of ``BATCH_AXES`` the mesh has (dim 0,
    data-major), the sequence over ``cfg.context_axis`` (dim 1) and heads
    over ``tensor`` (dim 2) when the mesh has one and the head count
    divides.  With ``batch_size`` it keeps the LARGEST dividing subset
    of the batch axes, by JAX's exhaustive search (mesh {data:2, fsdp:4}
    with B=4 picks fsdp, not data); none divides → batch replicated.
    Heads stay whole when the Ulysses all-to-all could not spread the
    per-shard head count over the context axis."""
    from torch.distributed.tensor import Replicate, Shard

    from traceml_tpu_torch.parallel.mesh import BATCH_AXES

    sizes = _mesh_axes(cfg.mesh)
    batch_axes = tuple(ax for ax in BATCH_AXES if ax in sizes and ax != cfg.context_axis)
    if batch_axes and batch_size is not None:
        best, best_dp = (), 1
        for mask in range(1, 1 << len(batch_axes)):
            subset = tuple(ax for i, ax in enumerate(batch_axes) if mask >> i & 1)
            dp = 1
            for ax in subset:
                dp *= sizes[ax]
            if batch_size % dp == 0 and (dp > best_dp or (dp == best_dp and len(subset) > len(best))):
                best, best_dp = subset, dp
        batch_axes = best
    heads_axis = None
    if "tensor" in sizes and cfg.context_axis != "tensor" and cfg.n_heads % sizes["tensor"] == 0:
        local_heads = cfg.n_heads // sizes["tensor"]
        if cfg.attention_impl != "ulysses" or local_heads % sizes[cfg.context_axis] == 0:
            heads_axis = "tensor"

    def placement(ax: str) -> Any:
        if ax in batch_axes:
            return Shard(0)
        if ax == cfg.context_axis:
            return Shard(1)
        if ax == heads_axis:
            return Shard(2)
        return Replicate()

    return tuple(placement(ax) for ax in sizes)


def _sequence_parallel(cfg: "ModelConfig") -> bool:
    return cfg.attention_impl in ("ring", "ulysses") and cfg.mesh is not None


#: the Dense layers that keep a cast weight, by the weight's id: an
#: optimizer step casts anew those whose weights it stepped
_cast_owners: "weakref.WeakValueDictionary[int, Dense]" = weakref.WeakValueDictionary()
_refresh_hook: Any = None


def _refresh_casts(optimizer: Any, args: Any, kwargs: Any) -> None:
    """A global optimizer step post-hook: each kept cast of a weight the
    step wrote is made anew, outside the next forward (a fused optimizer
    writes without bumping the weights' version counters)."""
    if not _cast_owners:
        return
    for group in optimizer.param_groups:
        for p in group["params"]:
            owner = _cast_owners.get(id(p))
            if owner is not None and owner.weight is p and owner.cache_cast:
                owner.keep_cast()


class Dense(nn.Module):
    """A bias-free linear layer with its weight, (out, in) as in
    ``nn.Linear``, stored in ``param_dtype``; input and weight are cast
    to ``dtype`` at each call.  ``fan_in`` (default ``d_in``) sets the
    init's std, ``fan_in ** -0.5``.

    The cast weight is kept between calls while the weight is unchanged:
    keyed on the weight's storage, its version counter (which every
    in-place write through the parameter bumps: ``copy_``,
    ``load_state_dict``, most optimizers), whether it requires grad, and
    inference mode.  Where the weight requires grad, the kept cast is
    made with grad on and carries the cast's own autograd edge, so a
    forward with grad on uses it as it is: the gradients are those of
    ``.to``, and two backwards through one kept cast accumulate as
    through two casts.  After each optimizer step a global step
    post-hook casts anew the kept weights that step wrote, outside the
    forward: the forward loop casts once, the train step's forward not
    at all (its casts run in the optimizer step).  One cast copy of each
    weight stays allocated, the copy the step's backward holds anyway.
    Writes through ``weight.data`` bypass the version counter, as they
    bypass autograd's checks, and are not seen.  ``cache_cast = False``
    (set by :func:`shard_model`: FSDP2 refills its gathered weights in
    place and keeps their version) and a weight that is no plain
    ``nn.Parameter`` (a DTensor) take the plain ``.to``."""

    _linear = staticmethod(F.linear)
    cache_cast = True

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: Any, fan_in: Optional[int] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty((d_out, d_in), dtype=param_dtype, device=device))
        nn.init.normal_(self.weight, std=(fan_in or d_in) ** -0.5)
        self._cast: Optional[torch.Tensor] = None
        self._cast_key: Optional[tuple] = None

    @staticmethod
    def _key(w: torch.Tensor) -> tuple:
        return (w.data_ptr(), w._version, w.requires_grad, torch.is_inference_mode_enabled())

    def cast_weight(self) -> torch.Tensor:
        """The weight in ``dtype``, the kept cast where it is fresh."""
        w = self.weight
        if w.dtype == self.dtype:
            return w
        if not self.cache_cast or type(w) is not nn.Parameter or w.is_inference():
            return w.to(self.dtype)
        if self._cast_key == self._key(w):
            return self._cast
        return self.keep_cast()

    def keep_cast(self) -> torch.Tensor:
        """Cast the weight anew and keep the cast (see the class)."""
        global _refresh_hook
        w = self.weight
        with torch.enable_grad():
            cast = w.to(self.dtype)
        self._cast, self._cast_key = cast, self._key(w)
        _cast_owners[id(w)] = self
        if _refresh_hook is None:
            from torch.optim.optimizer import register_optimizer_step_post_hook

            _refresh_hook = register_optimizer_step_post_hook(_refresh_casts)
        return cast

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != self.dtype:
            x = x.to(self.dtype)
        return self._linear(x, self.cast_weight())


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

    _linear = staticmethod(_TF32Linear.apply)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The ``tensor`` axis a tensor-parallel model runs over: its size,
    this rank's coordinate and its process group (``None`` at size 1,
    where every collective is skipped)."""

    size: int
    rank: int
    group: Any


def tensor_parallel(cfg: "ModelConfig") -> TensorParallel:
    """The ``tensor`` axis of ``cfg.mesh``; size 1 when there is no mesh
    or it has no such axis (every slice is then whole).  A head count or
    a width that does not divide by the axis raises ``ValueError`` naming
    the fix."""
    from traceml_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

    if cfg.mesh is None or "tensor" not in (cfg.mesh.mesh_dim_names or ()):
        return TensorParallel(1, 0, None)
    T = axis_size(cfg.mesh, "tensor")
    if cfg.n_heads % T or cfg.n_kv_heads % T:
        raise ValueError(
            f"tensor parallelism over {T} ranks splits the heads: n_heads ({cfg.n_heads}) and n_kv_heads "
            f"({cfg.n_kv_heads}) must both divide by {T}; make the mesh's tensor axis a common divisor of "
            "the two (1 keeps every head on each rank) or change the head counts"
        )
    widths = {"hidden": cfg.hidden, "ffn_hidden": cfg.ffn_hidden, "vocab_size": cfg.vocab_size}
    bad = {k: v for k, v in widths.items() if v % T}
    if bad:
        raise ValueError(f"tensor parallelism over {T} ranks splits {sorted(bad)} ({bad}), which do not divide "
                         f"by {T}; make the mesh's tensor axis a divisor of each")
    return TensorParallel(T, axis_index(cfg.mesh, "tensor"), axis_group(cfg.mesh, "tensor") if T > 1 else None)


class ColumnParallelDense(Dense):
    """``Dense`` holding this rank's slice of the output features, a
    (d_out/T, d_in) weight.  Its input must be replicated over ``tensor``
    and enter through ``copy_to_group`` (once for the layers that share
    it), so that its gradient is summed over the ranks' slices."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, param_dtype: torch.dtype, device: Any,
                 tp: TensorParallel) -> None:
        super().__init__(d_in, d_out // tp.size, dtype, param_dtype, device)


class ColumnParallelTF32Dense(ColumnParallelDense, TF32Dense):
    """The TF32 ``lm_head``, column-parallel over the vocabulary."""


class RowParallelDense(Dense):
    """``Dense`` holding this rank's slice of the input features, a
    (d_out, d_in/T) weight: it takes the column-parallel layers' local
    output, and its products are summed over ``tensor``
    (``reduce_from_group``), which leaves the output replicated."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, param_dtype: torch.dtype, device: Any,
                 tp: TensorParallel) -> None:
        super().__init__(d_in // tp.size, d_out, dtype, param_dtype, device, fan_in=d_in)
        self.group = tp.group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_group(super().forward(x), self.group)


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


class HiddenParallelEmbed(Embed):
    """``Embed`` holding this rank's slice of the hidden dim, a (vocab,
    hidden/T) table; the looked-up rows are gathered over ``tensor``
    (``gather_from_group``), so the output is whole and replicated."""

    def __init__(self, vocab: int, dim: int, dtype: torch.dtype, param_dtype: torch.dtype, device: Any,
                 tp: TensorParallel) -> None:
        super().__init__(vocab, dim // tp.size, dtype, param_dtype, device)
        self.group = tp.group

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return gather_from_group(super().forward(tokens), self.group, -1)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: Any, tp: TensorParallel) -> None:
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.n_heads, self.n_kv_heads = cfg.n_heads // tp.size, cfg.n_kv_heads // tp.size  # this rank's
        hd = cfg.head_dim
        pd = cfg.param_dtype
        self.wq = ColumnParallelDense(cfg.hidden, cfg.n_heads * hd, dtype, pd, device, tp)
        self.wk = ColumnParallelDense(cfg.hidden, cfg.n_kv_heads * hd, dtype, pd, device, tp)
        self.wv = ColumnParallelDense(cfg.hidden, cfg.n_kv_heads * hd, dtype, pd, device, tp)
        self.wo = RowParallelDense(cfg.n_heads * hd, cfg.hidden, dtype, pd, device, tp)

    def forward(self, x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """``rope``: the (cos, sin) tables of this shard's positions.
        Tensor-parallel, q, k and v hold this rank's heads: its column
        slices of ``wq wk wv`` are whole heads, and local query head j
        maps to local kv head j // (n_heads / n_kv_heads), as global
        query head r·n_heads/T + j maps to global kv head r·n_kv_heads/T
        + j // (n_heads / n_kv_heads)."""
        B, S, _ = x.shape
        hd = self.cfg.head_dim
        x = copy_to_group(x, self.tp.group)
        q = self.wq(x).view(B, S, self.n_heads, hd)
        k = self.wk(x).view(B, S, self.n_kv_heads, hd)
        v = self.wv(x).view(B, S, self.n_kv_heads, hd)
        # one RoPE pass over q's and k's heads side by side: the same
        # elementwise operations on the same values, in 7 kernels, not 12
        qk = _apply_rope(torch.cat([q, k], dim=2), *rope)
        q, k = qk[:, :, :self.n_heads], qk[:, :, self.n_heads:]
        # GQA: each kv head repeats in place up to n_heads (a copy, so
        # contiguous like v; q stays a view of qk, which the kernel reads
        # through its strides)
        group = self.n_heads // self.n_kv_heads
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
        out = self._attend(q, k, v)  # (B, S, heads, hd)
        return self.wo(out.reshape(B, S, self.n_heads * hd))

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Attention dispatch per ``cfg.attention_impl``.  "dense": this
        rank's tensors whole (``causal_attention``: the flash kernel on
        CUDA at S ≥ 1024).  "ring" / "ulysses": q, k, v are this rank's
        sequence shard; the op runs over the context axis's group, and
        RoPE was applied on global positions.  The errors are JAX's.

        Tensor-parallel, each op runs on this rank's heads, as JAX's
        ``seq_parallel_spec`` shards heads over ``tensor``, except under
        Ulysses when the local head count does not divide by the context
        axis: JAX then leaves heads whole, and so does this, gathering
        the heads over ``tensor`` and keeping its own of the output."""
        cfg = self.cfg
        if cfg.attention_impl == "dense":
            return causal_attention(q, k, v)
        if cfg.attention_impl == "ring":
            from traceml_tpu_torch.ops.ring_attention import ring_attention as op
        elif cfg.attention_impl == "ulysses":
            from traceml_tpu_torch.ops.ulysses_attention import ulysses_attention as op
        else:
            raise ValueError(
                f"unknown attention_impl {cfg.attention_impl!r} "
                "(dense | ring | ulysses)"
            )
        if cfg.mesh is None or cfg.context_axis is None:
            raise ValueError(
                f"attention_impl={cfg.attention_impl!r} requires cfg.mesh "
                "and cfg.context_axis (sequence-parallel attention runs "
                "inside shard_map); use attention_impl='dense' for "
                "single-mesh GSPMD partitioning"
            )
        from traceml_tpu_torch.parallel.mesh import axis_size

        context = cfg.mesh.get_group(cfg.context_axis)
        tp = self.tp
        if (cfg.attention_impl == "ulysses" and tp.group is not None
                and self.n_heads % axis_size(cfg.mesh, cfg.context_axis)):
            q, k, v = (gather_from_group(t, tp.group, 2) for t in (q, k, v))
            return op(q, k, v, context).narrow(2, tp.rank * self.n_heads, self.n_heads)
        return op(q, k, v, context)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: Any, tp: TensorParallel) -> None:
        super().__init__()
        pd = cfg.param_dtype
        self.group = tp.group
        self.w_gate = ColumnParallelDense(cfg.hidden, cfg.ffn_hidden, dtype, pd, device, tp)
        self.w_up = ColumnParallelDense(cfg.hidden, cfg.ffn_hidden, dtype, pd, device, tp)
        self.w_down = RowParallelDense(cfg.ffn_hidden, cfg.hidden, dtype, pd, device, tp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_group(x, self.group)
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device: Any, tp: TensorParallel) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype, device, tp)
        self.mlp_norm = RMSNorm(cfg.hidden, dtype=dtype, device=device)
        self.mlp = MLP(cfg, dtype, device, tp)

    def forward(self, x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), rope)
        return x + self.mlp(self.mlp_norm(x))


class DecoderLM(nn.Module):
    """``DecoderLM(cfg, device=..., dtype=...)``; ``dtype`` defaults to
    ``cfg.dtype``, ``device`` to CUDA (``device="cpu"`` to run on the CPU).
    Its layers are the tensor-parallel ones over ``cfg.mesh``'s
    ``tensor`` axis (:func:`tensor_parallel`): each rank holds its
    slices, whole at size 1 or without the axis."""

    def __init__(self, cfg: ModelConfig, *, device: Any = "cuda",
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or cfg.dtype
        self.cfg = cfg
        self.dtype = dtype
        tp = self.tp = tensor_parallel(cfg)
        pd = cfg.param_dtype
        self.embed = HiddenParallelEmbed(cfg.vocab_size, cfg.hidden, dtype, pd, dev, tp)
        self.layers = nn.ModuleList(Block(cfg, dtype, dev, tp) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.hidden, dtype=dtype, device=dev)
        self.lm_head = ColumnParallelTF32Dense(cfg.hidden, cfg.vocab_size, torch.float32, pd, dev, tp)
        self._rope_key: Optional[tuple] = None
        self._rope_cached: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def rope_tables(self, offset: int, S: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """RoPE's tables for positions ``offset .. offset + S``, (S, 1,
        head_dim), broadcast over the batch and the heads: made once, not
        in each layer, and kept for the next forward of the same positions
        (they depend on nothing else; inference mode keeps its own)."""
        key = (offset, S, device, torch.is_inference_mode_enabled())
        if key != self._rope_key:
            positions = torch.arange(offset, offset + S, device=device)
            self._rope_cached = _rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
            self._rope_key = key
        return self._rope_cached

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits of ``tokens`` (B, S); under ring or Ulysses attention
        ``tokens`` is this rank's sequence shard, whose RoPE positions
        start at its context coordinate × S.  Tensor-parallel, the
        ``lm_head``'s vocabulary slices are gathered: every rank returns
        the whole logits."""
        B, S = tokens.shape
        x = self.embed(tokens)
        offset = 0
        if _sequence_parallel(self.cfg):
            offset = self.cfg.mesh.get_local_rank(self.cfg.context_axis) * S
        rope = self.rope_tables(offset, S, tokens.device)
        for layer in self.layers:
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, rope, use_reentrant=False)
            else:
                x = layer(x, rope)
        x = self.final_norm(x)
        return gather_from_group(self.lm_head(copy_to_group(x, self.tp.group)), self.tp.group, -1)


def shard_inputs(cfg: ModelConfig, inputs: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's piece of the global (B, S) inputs and targets: the
    batch and sequence placements of :func:`seq_parallel_spec` (the
    sequence only under ring or Ulysses attention; heads do not apply)."""
    from torch.distributed.tensor import Replicate

    from traceml_tpu_torch.parallel.mesh import local_shard

    keep = (0, 1) if _sequence_parallel(cfg) else (0,)
    placements = tuple(pl if getattr(pl, "dim", None) in keep else Replicate()
                       for pl in seq_parallel_spec(cfg, batch_size=inputs.shape[0]))
    return local_shard(inputs, cfg.mesh, placements), local_shard(targets, cfg.mesh, placements)


def loss_fn(model: DecoderLM, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (inputs=tokens[:, :-1], targets=[:, 1:]).
    With ``cfg.mesh`` set, ``tokens`` is the GLOBAL batch: it is shifted
    first, then this rank keeps its shard of inputs and targets
    (:func:`shard_inputs`), and the loss is this shard's mean."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if model.cfg.mesh is not None:
        inputs, targets = shard_inputs(model.cfg, inputs, targets)
    logits = model(inputs)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean()


# -- sharding ------------------------------------------------------------

_COL_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up", "lm_head")
_ROW_PARALLEL = ("wo", "w_down")


def _jax_spec(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The JAX ``param_shardings`` spec of a parameter, in the flax
    leaf's dim order: 2-D kernels shard dim 0 over ``fsdp`` and dim 1
    over ``tensor`` (column-parallel ``wq wk wv w_gate w_up lm_head``),
    or dim 0 over ``tensor`` and dim 1 over ``fsdp`` (row-parallel ``wo
    w_down``); the embedding vocab over ``fsdp``, hidden over ``tensor``;
    1-D scales replicated."""
    parts = name.split(".")
    if ndim <= 1:
        return ()
    owner = next((n for n in parts if n in _COL_PARALLEL + _ROW_PARALLEL), None)
    if "embed" in parts and ndim == 2:
        return ("fsdp", "tensor")
    if owner in _COL_PARALLEL:
        return ("fsdp", "tensor")
    if owner in _ROW_PARALLEL:
        return ("tensor", "fsdp")
    return ("fsdp",)


def param_shardings(params: Union[nn.Module, Mapping[str, torch.Tensor]], mesh) -> Dict[str, Tuple[Any, ...]]:
    """Every parameter's JAX ``param_shardings`` spec as DTensor
    placements over ``mesh``'s dims, keyed by the port's parameter names.

    The specs are JAX's (see :func:`_jax_spec`).  A flax kernel is (in,
    out) and the port's ``Dense`` weight (out, in) (``models/convert.py``),
    so a kernel's two dims swap; the embedding has the same layout in
    both."""
    from torch.distributed.tensor import Replicate, Shard

    named = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    out: Dict[str, Tuple[Any, ...]] = {}
    for name, p in named:
        spec = _jax_spec(name, p.ndim)
        transposed = p.ndim == 2 and name.split(".")[0] != "embed"
        by_axis = {ax: (1 - j if transposed else j) for j, ax in enumerate(spec)}
        out[name] = tuple(Shard(by_axis[ax]) if ax in by_axis else Replicate()
                          for ax in _mesh_axes(mesh))
    return out


def _fsdp_mesh(mesh):
    """FSDP2's mesh: the flattened ``fsdp × context`` dims (parameters are
    replicated across ``context``, so they shard over both), with ``data``
    as HSDP's replicate dim when it is > 1."""
    sizes = _mesh_axes(mesh)
    shard_dims = tuple(ax for ax in ("fsdp", "context") if ax in sizes)
    name = "_".join(shard_dims)
    # _flatten also registers ``name`` on the root mesh, for HSDP's 2-D slice
    shard = mesh[shard_dims]._flatten(name) if len(shard_dims) > 1 else mesh[name]
    return mesh["data", name] if sizes.get("data", 1) > 1 else shard


def _check_mesh(mesh, cfg: ModelConfig) -> None:
    """The DecoderLM shards over ``data fsdp tensor context``; an
    ``expert`` or ``stage`` axis belongs to the MoE block and the
    pipeline.  A ``tensor`` axis > 1 shards a model built tensor-parallel,
    so ``cfg.mesh`` must hold the same axis."""
    from traceml_tpu_torch.parallel.mesh import AXES, axis_size

    sizes = _mesh_axes(mesh)
    extra = [ax for ax in sizes if ax not in AXES]
    if extra:
        raise NotImplementedError(
            f"the DecoderLM has no {extra} axis: expert parallelism is models/moe.py "
            "(init_expert_parallel), pipeline parallelism parallel/pipeline.py (make_pipeline_fn)"
        )
    T = sizes.get("tensor", 1)
    if T > 1 and (cfg.mesh is None or axis_size(cfg.mesh, "tensor") != T):
        raise ValueError(
            f"a mesh with a tensor axis of {T} shards a tensor-parallel model: set ModelConfig.mesh to the "
            "mesh, so that the model is built with its slices"
        )


def shard_model(model: "DecoderLM", mesh) -> "DecoderLM":
    """Apply :func:`param_shardings`'s ``fsdp`` part through FSDP2:
    ``fully_shard`` on each block, then the root, each parameter sharded
    on the dim that JAX's spec shards over ``fsdp`` (dim 0 where it is
    replicated, and on a shard group of one rank, where the dim is moot).
    ``model`` must hold its final weights already.  A tensor-parallel
    model is sliced first (built so), then FSDP2 shards each rank's slices
    over the mesh's ``fsdp × context`` dims, which leave ``tensor`` out,
    as torch's 2-D recipe composes the two."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    _check_mesh(mesh, model.cfg)
    fsdp_mesh = _fsdp_mesh(mesh)
    # a shard group of one rank holds every parameter whole whatever the
    # dim, so it takes FSDP2's dim-0 path (no chunk-and-concatenate copies
    # per parameter) and keeps the gathered parameters from the forward to
    # the backward (resharding would only free a copy to gather it again)
    whole = fsdp_mesh.size(fsdp_mesh.ndim - 1) == 1
    dims = {}
    if not whole and "fsdp" in _mesh_axes(mesh):
        fsdp_at = list(_mesh_axes(mesh)).index("fsdp")
        for name, spec in param_shardings(model, mesh).items():
            if isinstance(spec[fsdp_at], Shard):
                dims[name] = spec[fsdp_at].dim
    by_param = {p: dims.get(name, 0) for name, p in model.named_parameters()}

    def placement(p: torch.Tensor) -> Any:
        return Shard(by_param.get(p, 0))

    for module in (*model.layers, model):
        fully_shard(module, mesh=fsdp_mesh, shard_placement_fn=placement, reshard_after_forward=not whole)
    for module in model.modules():
        if isinstance(module, Dense):
            module.cache_cast = False  # FSDP2 refills the gathered weights in place, version kept
    return model


def is_sharded(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


# -- training ------------------------------------------------------------


def init_train_state(
    cfg: ModelConfig,
    *,
    device: Any = "cuda",
    learning_rate: float = 3e-4,
    seed: int = 0,
    mesh: Any = None,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[DecoderLM, torch.optim.AdamW]:
    """``(model, optimizer)``: a DecoderLM initialised from ``seed`` (then
    loaded from ``state_dict`` when given) and AdamW with weight decay
    0.01 on every parameter, as the JAX ``init_train_state`` builds with
    ``optax.adamw(lr, weight_decay=0.01)``.  ``cfg.remat`` checkpoints
    each block, as in the JAX model.  With a ``mesh`` (a DeviceMesh) the
    parameters and AdamW's state are sharded by FSDP2
    (:func:`shard_model`) after the weights are loaded.

    Over a ``tensor`` axis > 1 in ``cfg.mesh`` the model holds this
    rank's slices, which are cut from the whole ``state_dict`` (or,
    without one, from the whole model ``seed`` initialises), so a seed
    gives the same weights at every axis size.

    Torch's AdamW and optax's compute the same update,
    ``p ← p − lr·(m̂/(√v̂+ε) + wd·p)`` with the decay read from the
    parameter before the update and the same bias corrections
    (``tests/test_torch_train_step.py`` holds the two to it).  The
    moments and step counts are made here, as ``tx.init(params)`` makes
    them, so the first step does not allocate 2 × the parameters' bytes.
    """
    from traceml_tpu_torch.models.convert import local_state_dict

    dev = resolve_device(device)
    if mesh is not None:
        _check_mesh(mesh, cfg)
    rng_devices = [dev] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=rng_devices):
        torch.manual_seed(seed)
        if state_dict is None and tensor_parallel(cfg).size > 1:
            whole = dataclasses.replace(cfg, mesh=None, attention_impl="dense", context_axis=None)
            state_dict = DecoderLM(whole, device=dev).state_dict()
        model = DecoderLM(cfg, device=dev)
    if state_dict is not None:
        if model.tp.size > 1:
            state_dict = local_state_dict(state_dict, param_shardings(state_dict, cfg.mesh), cfg.mesh, ("tensor",))
        model.load_state_dict(state_dict)
    if mesh is not None:
        shard_model(model, mesh)
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


#: the axes a gradient is averaged over: the batch and the sequence are
#: split over them; ``tensor`` ranks hold different slices of the weights
GRADIENT_AXES = ("data", "fsdp", "context")


def gradient_group(mesh) -> Tuple[Any, int]:
    """``(group, size)`` of the ranks that average their gradients and
    their losses: this rank's slice of ``mesh`` along
    :data:`GRADIENT_AXES`, never across ``tensor``.  With every other
    axis of size 1 that is the whole mesh's group; the group is ``None``
    at size 1."""
    from traceml_tpu_torch.parallel.mesh import axis_group, mesh_group

    sizes = _mesh_axes(mesh)
    n = math.prod(sizes.get(ax, 1) for ax in GRADIENT_AXES)
    if n == 1:
        return None, 1
    if all(size == 1 for ax, size in sizes.items() if ax not in GRADIENT_AXES):
        return mesh_group(mesh), n
    return axis_group(mesh, GRADIENT_AXES), n


def make_train_step(
    model: DecoderLM,
    optimizer: torch.optim.Optimizer,
    grad_sync: Optional[Callable[[], Any]] = None,
) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """The train step ``step(tokens) → {"loss": loss}``: the loss of
    ``tokens`` (B, S+1), its gradients, ``grad_sync()`` when given (a
    data-parallel gradient all-reduce between backward and the update),
    one optimizer update, and the gradients freed.  The loss is returned
    on the device, unsynchronized.

    With ``cfg.mesh`` set, ``tokens`` is the global batch and each rank
    trains on its shard (:func:`loss_fn`); the returned loss is the mean
    of the ranks' losses (JAX's global mean), and without FSDP2 and
    without a ``grad_sync`` of the caller's the gradients are averaged
    over the batch and context ranks after the backward
    (:func:`gradient_group`; FSDP2's reduce-scatter averages over them
    itself).  Neither is averaged over ``tensor``: its ranks hold
    different slices of the weights, whose gradients would mix wherever
    their shapes match, and the same loss."""
    mesh = model.cfg.mesh
    group = n_ranks = None
    if mesh is not None:
        group, n_ranks = gradient_group(mesh)
        if grad_sync is None and n_ranks > 1 and not is_sharded(model):
            grad_sync = average_gradients(model, group, n_ranks)

    def train_step(tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        loss = loss_fn(model, tokens)
        loss.backward()
        if grad_sync is not None:
            grad_sync()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        loss = loss.detach()
        if n_ranks is not None and n_ranks > 1:
            import torch.distributed as dist

            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            loss = loss / n_ranks
        return {"loss": loss}

    return train_step


def average_gradients(model: nn.Module, group: Any, n_ranks: int) -> Callable[[], torch.Tensor]:
    """A ``grad_sync`` that averages the gradients over ``group``: one
    all-reduce (sum) of the flat gradients, divided by ``n_ranks``, copied
    back.  Gloo has no average reduction, so it is a sum and a divide on
    every backend."""
    import torch.distributed as dist

    params = list(model.parameters())

    def sync() -> torch.Tensor:
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat.div_(n_ranks)
        offset = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n
        return flat

    return sync
