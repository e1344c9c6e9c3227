"""Ulysses-style sequence parallelism: all-to-all head scattering.

Counterpart of ``traceml_tpu/ops/ulysses_attention.py``.  Instead of
rotating K/V blocks around a ring (``ops/ring_attention.py``), ONE
all-to-all re-shards the activations from sequence-sharded to
head-sharded, every rank runs ordinary full causal attention for its
head slice, and a second all-to-all restores the sequence sharding
(the DeepSpeed-Ulysses recipe).

* Communication: two all-to-alls of the activations per layer against
  the ring's P − 1 hops of K/V; they cannot overlap with the attention
  math the way the ring's hops can.
* Memory: the full sequence is materialized for the head slice, so the
  S² scores exist per head slice (the ring keeps O(S_local²) blocks).
* Constraint: the head count must divide by the axis size.

    out = ulysses_attention(q, k, v, group)

with q, k, v the LOCAL (B, S_local, H, D) shards, sequence-ordered by the
rank's place in ``group`` (the ring's contract).  After the head scatter
each rank holds the FULL sequence for H/P heads, so
``ops/attention.py:causal_attention`` applies unchanged: on CUDA at
P·S_local ≥ 1024 that is the flash kernel.  A group of one rank skips
both exchanges, which are the identity there.

The all-to-alls are ``torch.distributed.nn.functional.all_to_all_single``
(differentiable).  It splits and joins dim 0, where JAX's
``all_to_all(split_axis=2, concat_axis=1, tiled=True)`` splits heads and
joins sequence, so each side permutes the chunk axis to dim 0 first and
back after.
"""

from __future__ import annotations

from typing import Any, Optional

import torch


def _all_to_all(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Chunk i of dim 0 goes to group rank i; chunk i of the result came
    from group rank i."""
    from torch.distributed.nn.functional import all_to_all_single

    x = x.contiguous()
    return all_to_all_single(torch.empty_like(x), x, group=group)


def seq_to_heads(x: torch.Tensor, group: Any, P: int) -> torch.Tensor:
    """(B, S_loc, H, D) → (B, P·S_loc, H/P, D): trade the sequence shard
    for a head shard.  Head chunk j goes to rank j; the chunk from rank i
    is sequence block i."""
    B, S_loc, H, D = x.shape
    chunks = x.reshape(B, S_loc, P, H // P, D).permute(2, 0, 1, 3, 4)  # (P, B, S_loc, H/P, D)
    got = _all_to_all(chunks, group)
    return got.permute(1, 0, 2, 3, 4).reshape(B, P * S_loc, H // P, D).contiguous()


def heads_to_seq(x: torch.Tensor, group: Any, P: int) -> torch.Tensor:
    """Inverse: (B, P·S_loc, H/P, D) → (B, S_loc, H, D).  Sequence block j
    goes to rank j; the chunk from rank i is head slice i."""
    B, S, h, D = x.shape
    S_loc = S // P
    chunks = x.reshape(B, P, S_loc, h, D).permute(1, 0, 2, 3, 4)  # (P, B, S_loc, h, D)
    got = _all_to_all(chunks, group)
    return got.permute(1, 2, 0, 3, 4).reshape(B, S_loc, P * h, D)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: Optional[Any] = None,
) -> torch.Tensor:
    """Causal attention over a sequence-sharded group via all-to-all.

    q, k, v: local (B, S_local, H, D); H must be divisible by the group
    size.  Returns the local (B, S_local, H, D) output shard.
    """
    import torch.distributed as dist

    from traceml_tpu_torch.ops.attention import causal_attention

    P = dist.get_world_size(group)
    B, S_loc, H, D = q.shape
    if H % P != 0:
        raise ValueError(
            f"ulysses_attention needs heads ({H}) divisible by the "
            f"sequence-axis size ({P}); use ring_attention otherwise"
        )
    if P == 1:
        # a one-rank group exchanges nothing: both all-to-alls are the
        # identity (XLA drops them too), and through NCCL each costs
        # 0.15-0.46 ms of host time on an H100 (PERF.md, parallel layer)
        return causal_attention(q, k, v).to(q.dtype)
    out_full = causal_attention(seq_to_heads(q, group, P), seq_to_heads(k, group, P),
                                seq_to_heads(v, group, P))
    return heads_to_seq(out_full, group, P).to(q.dtype)


def make_ulysses_attention(mesh, axis_name: str = "context"):
    """Ulysses attention over DTensors sharded by sequence (``Shard(1)``)
    over ``axis_name`` of ``mesh``, in and out (``make_ring_attention``'s
    contract)."""
    from torch.distributed.tensor import DTensor

    group = mesh.get_group(axis_name)

    def fn(q, k, v):
        out = ulysses_attention(q.to_local(), k.to_local(), v.to_local(), group)
        return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False,
                                  shape=q.shape, stride=q.stride())

    return fn


__all__ = ["ulysses_attention", "make_ulysses_attention", "seq_to_heads", "heads_to_seq"]
