"""Ring attention: causal attention over a sequence-sharded mesh axis.

Counterpart of ``traceml_tpu/ops/ring_attention.py``.  Long-context
training shards the SEQUENCE across ranks (context parallelism): each
rank holds a contiguous S/P slice of Q, K and V.  K/V blocks rotate one
hop around the ring per step (``dist.batch_isend_irecv`` on the context
group, where JAX uses ``jax.lax.ppermute``) while each rank accumulates
its Q block's output with an online softmax.

    out = ring_attention(q, k, v, group)

takes the LOCAL (B, S_local, H, D) shards, sequence-ordered by the rank's
place in ``group`` (rank p holds positions [p·S_local, (p+1)·S_local)).
Causality is enforced with global position ids; blocks entirely in the
future contribute nothing (masked at −1e30, as in JAX).  The block order
is JAX's: after ``step`` hops a rank holds the block of ring position
``(p − step) mod P``, so each rank starts with its own diagonal block,
and the last step skips its hop (P − 1 hops).

The per-block attention is plain torch einsums with f32 softmax
accumulation, as the JAX blocks are jnp; ring attention never reaches the
flash kernel.  The hop is an autograd ``Function`` whose backward sends
the gradient the other way round the ring, which is what ``jax.grad``
does through ``ppermute`` (``parallel/comm.py:ring_hop``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from traceml_tpu_torch.parallel.comm import ring_hop

_NEG = -1e30


def _block_attend(q, k_blk, q_offset: int, k_offset: int, scale: float) -> torch.Tensor:
    """Causally-masked score matrix for one (q block × kv block) pair.

    q: (B, Sq, H, D); k_blk: (B, Sk, H, D) → (B, H, Sq, Sk) f32 scores,
    masked by GLOBAL positions (future pairs set to −1e30).
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * scale
    Sq, Sk = q.shape[1], k_blk.shape[1]
    q_ids = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_ids = k_offset + torch.arange(Sk, device=q.device)[None, :]
    return torch.where(q_ids >= k_ids, s, torch.full_like(s, _NEG))


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: Optional[Any] = None,
) -> torch.Tensor:
    """Causal ring attention over ``group`` (the default group when None);
    q, k, v: local (B, S_local, H, D) → local (B, S_local, H, D)."""
    import torch.distributed as dist

    axis_size = dist.get_world_size(group)
    my_idx = dist.get_rank(group)
    B, S_loc, H, D = q.shape
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))  # JAX's, in f32
    q_offset = my_idx * S_loc

    m = torch.full((B, H, S_loc, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S_loc, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S_loc, D), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for step in range(axis_size):
        # after `step` hops this rank holds the block that started at
        # ring position (my_idx − step) mod P
        src = (my_idx - step) % axis_size
        s = _block_attend(q, k_blk, q_offset, src * S_loc, scale)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p.to(v_blk.dtype), v_blk).float()
        m = m_new
        if step < axis_size - 1:  # the last hop would be dead: P − 1 suffice
            k_blk = ring_hop(k_blk, group)
            v_blk = ring_hop(v_blk, group)
    # causal rows always include self-attention → l > 0
    out = (acc / l).to(q.dtype)  # (B, H, S_loc, D)
    return out.transpose(1, 2)


def make_ring_attention(mesh, axis_name: str = "context"):
    """Ring attention over DTensors: q, k, v sharded by sequence
    (``Shard(1)``) over ``axis_name`` of ``mesh`` in, the causal
    attention output with the same placements out, as JAX's
    ``shard_map`` wrapper takes and gives global arrays."""
    from torch.distributed.tensor import DTensor

    group = mesh.get_group(axis_name)

    def fn(q, k, v):
        out = ring_attention(q.to_local(), k.to_local(), v.to_local(), group).contiguous()
        return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False,
                                  shape=q.shape, stride=q.stride())

    return fn


__all__ = ["ring_attention", "make_ring_attention"]
