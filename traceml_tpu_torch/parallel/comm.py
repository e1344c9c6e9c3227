"""Differentiable collectives for the hand-sharded paths.

JAX shards these paths with GSPMD or ``shard_map`` and gets each
collective's transpose from ``jax.grad``.  The port runs one program per
rank, so each cross-rank edge is an autograd ``Function`` whose backward
is the collective's transpose, Megatron style:

* :func:`copy_to_group`: identity forward, all-reduce (sum) of the
  gradient backward.  A replicated activation entering a region where
  each rank uses it for its own slice of the work (column-parallel
  layers, local experts): every rank's gradient is partial.
* :func:`reduce_from_group`: all-reduce (sum) forward, identity
  backward.  Each rank holds a partial sum (a row-parallel layer's
  product, the local experts' combine, the pipeline's masked output
  buffers) and everything after it is replicated, so every rank already
  holds the whole gradient.
* :func:`gather_from_group`: all-gather along a dim forward, this rank's
  chunk of the gradient backward (the vocabulary-sharded logits, the
  hidden-sharded embedding): what follows is replicated.
* :func:`ring_hop`: send to the next group rank, receive from the
  previous one (``jax.lax.ppermute`` over a ring); backward, the reverse.

A ``group`` of ``None`` stands for a group of one rank: every function is
then the identity and issues no collective, as XLA drops them.  The
collectives go through ``torch.distributed``'s module attributes
(``dist.all_reduce``, ``dist.all_gather``, ``dist.batch_isend_irecv``),
so ``patch_dist_collectives`` records them.
"""

from __future__ import annotations

from typing import Any, Optional

import torch


def _all_reduce(x: torch.Tensor, group: Any) -> torch.Tensor:
    import torch.distributed as dist

    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor):
        return _all_reduce(grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
        import torch.distributed as dist

        n = dist.get_world_size(group)
        ctx.dim, ctx.rank, ctx.size = dim, dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor):
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(), None, None


def copy_to_group(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """Identity forward; the gradient all-reduced (sum) over ``group``."""
    return x if group is None else _Copy.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the gradient passed through."""
    return x if group is None else _Reduce.apply(x, group)


def gather_from_group(x: torch.Tensor, group: Optional[Any], dim: int) -> torch.Tensor:
    """The group ranks' ``x`` concatenated along ``dim`` in group-rank
    order; backward, this rank's chunk of the gradient."""
    return x if group is None else _Gather.apply(x, group, dim % x.dim())


def ring_shift(x: torch.Tensor, group: Any, shift: int) -> torch.Tensor:
    """Send ``x`` to the group rank ``shift`` places ahead, receive from
    the one ``shift`` places behind."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    send = x.contiguous()
    recv = torch.empty_like(send)
    peer_to = dist.get_global_rank(group, (me + shift) % n)
    peer_from = dist.get_global_rank(group, (me - shift) % n)
    ops = [dist.P2POp(dist.isend, send, peer_to, group), dist.P2POp(dist.irecv, recv, peer_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _RingHop(torch.autograd.Function):
    """One hop around the ring: group rank p's tensor moves to p + 1."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return ring_shift(x, group, 1)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor):
        return ring_shift(grad, ctx.group, -1), None


def ring_hop(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """``x`` of the previous group rank (rank p's goes to p + 1, the last
    rank's to rank 0); the gradient goes back the other way."""
    return x if group is None else _RingHop.apply(x, group)


__all__ = ["copy_to_group", "reduce_from_group", "gather_from_group", "ring_hop", "ring_shift"]
