"""Mixture-of-Experts FFN with expert parallelism, in PyTorch.

Counterpart of ``traceml_tpu/models/moe.py``: dense dispatch, as there.
Routing and dispatch are one pair of einsums over a static expert
dimension, with no top-k scatter, no capacity and no dynamic shapes:
every expert sees every token, weighted by its gate probability
(soft-MoE style).  The weights are f32, as the flax params: a router
(H, E), ``w_in`` (E, H, F) and ``w_out`` (E, F, H).  An auxiliary
load-balance loss, Σ_e mean_gate_e² · E (switch-transformer importance,
1 for uniform routing), keeps the router from collapsing onto one expert.
:class:`MoEBlock` wraps the FFN in a pre-norm residual block (RMSNorm,
eps 1e-6, f32).

Expert parallelism.  JAX shards the expert dim of ``w_in``/``w_out``
over the mesh's ``expert`` axis and GSPMD partitions the einsums, with
a sum over ``expert`` after the combine.  Here each rank of an ``expert``
axis of size ep holds E/ep experts (expert rank r the experts
[r·E/ep, (r+1)·E/ep)) and computes only theirs; the edges are the
autograd collectives of ``parallel/comm.py``:

* the gates and the aux loss are computed whole on every rank (the
  router is replicated across ``expert``);
* the experts' input x and the combine's gates enter the local work
  through ``copy_to_group``, so their gradients, partial on each rank,
  are summed over ``expert``;
* the local combine leaves through ``reduce_from_group`` (the sum over
  ``expert``), and everything after it is replicated;
* the aux loss takes the whole gates outside both, so its gradient is
  counted once.

The gradients of the router, of x and of each rank's experts then equal
the unsharded block's on every rank, and no gradient is synced across
``expert``.  A ``fsdp`` axis shards the parameters with FSDP2 on the dims
:func:`moe_param_shardings` gives it (the experts' dim 1, the router's dim
0); every rank computes on the whole batch, as the JAX tests' replicated
``x`` does, so FSDP2's average over ``fsdp`` is a mean of equal
gradients.  The products are plain ``torch.einsum`` (f32), as the JAX
ones are ``jnp.einsum``: no kernel of the port's is on this path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from traceml_tpu_torch.parallel.comm import copy_to_group, reduce_from_group
from traceml_tpu_torch.utils.device import resolve_device


def _expert_axis(mesh, n_experts: int, expert_axis: str) -> Tuple[int, int, Any]:
    """``(ep, rank, group)`` of ``expert_axis`` (1, 0, None without a mesh
    or the axis; the group is None at size 1)."""
    from traceml_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

    if mesh is None or expert_axis not in (mesh.mesh_dim_names or ()):
        return 1, 0, None
    ep = axis_size(mesh, expert_axis)
    if n_experts % ep:
        raise ValueError(f"{n_experts} experts do not divide over the {expert_axis} axis of size {ep}: "
                         f"make the axis a divisor of the expert count")
    return ep, axis_index(mesh, expert_axis), axis_group(mesh, expert_axis) if ep > 1 else None


class MoEFFN(nn.Module):
    """Expert-parallel feed-forward block: ``forward(x)`` with x (batch,
    seq, hidden) → ``(out, aux_loss)``.  With a ``mesh`` holding
    ``expert_axis`` this rank holds and computes E/ep experts."""

    def __init__(self, n_experts: int, hidden: int, ffn_hidden: int, *, device: Any = "cuda", mesh: Any = None,
                 expert_axis: str = "expert") -> None:
        super().__init__()
        dev = resolve_device(device)
        self.n_experts = n_experts
        self.ep, self.ep_rank, self.group = _expert_axis(mesh, n_experts, expert_axis)
        local = n_experts // self.ep
        self.router = nn.Parameter(torch.empty((hidden, n_experts), device=dev))
        self.w_in = nn.Parameter(torch.empty((local, hidden, ffn_hidden), device=dev))
        self.w_out = nn.Parameter(torch.empty((local, ffn_hidden, hidden), device=dev))
        for p in self.parameters():
            nn.init.normal_(p, std=0.02)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        gates = torch.softmax(torch.einsum("bsh,he->bse", x, self.router), dim=-1)  # (B, S, E)
        local = self.w_in.shape[0]
        mine = copy_to_group(gates, self.group).narrow(-1, self.ep_rank * local, local)
        xe = copy_to_group(x, self.group)
        inner = F.silu(torch.einsum("bsh,ehf->ebsf", xe, self.w_in))
        expert_out = torch.einsum("ebsf,efh->ebsh", inner, self.w_out)
        out = reduce_from_group(torch.einsum("bse,ebsh->bsh", mine, expert_out), self.group)
        importance = gates.mean(dim=(0, 1))  # (E,)
        aux = (importance ** 2).sum() * self.n_experts
        return out, aux


class MoEBlock(nn.Module):
    """Pre-norm residual block around :class:`MoEFFN`: ``forward(x)`` →
    ``(x + out, aux_loss)``."""

    def __init__(self, n_experts: int, hidden: int, ffn_hidden: int, *, device: Any = "cuda", mesh: Any = None,
                 expert_axis: str = "expert") -> None:
        super().__init__()
        dev = resolve_device(device)
        self.n_experts, self.hidden, self.ffn_hidden = n_experts, hidden, ffn_hidden
        self.norm_scale = nn.Parameter(torch.ones(hidden, device=dev))
        self.ffn = MoEFFN(n_experts, hidden, ffn_hidden, device=dev, mesh=mesh, expert_axis=expert_axis)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        normed = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6) * self.norm_scale
        out, aux = self.ffn(normed)
        return x + out, aux


def moe_param_shardings(params: Any, mesh, expert_axis: str = "expert") -> Dict[str, Tuple[Any, ...]]:
    """JAX's ``moe_param_shardings`` as DTensor placements (one per mesh
    dim), keyed by the port's names: ``w_in``/``w_out`` shard dim 0 over
    ``expert_axis`` and dim 1 over ``fsdp``, the router dim 0 over
    ``fsdp``, the rest is replicated (the layouts are JAX's)."""
    from torch.distributed.tensor import Replicate, Shard

    from traceml_tpu_torch.parallel.mesh import axis_sizes

    named = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    out = {}
    for name, _ in named:
        leaf = name.split(".")[-1]
        if leaf in ("w_in", "w_out"):
            by_axis = {expert_axis: 0, "fsdp": 1}
        elif leaf == "router":
            by_axis = {"fsdp": 0}
        else:
            by_axis = {}
        out[name] = tuple(Shard(by_axis[ax]) if ax in by_axis else Replicate() for ax in axis_sizes(mesh))
    return out


def moe_state_dict(n_experts: int, hidden: int, ffn_hidden: int, seed: int) -> Dict[str, torch.Tensor]:
    """A whole f32 ``MoEBlock`` state_dict from a numpy seed: router,
    ``w_in`` and ``w_out`` normal with std 0.02 (the flax init's), the
    norm's scale ones."""
    rng = np.random.default_rng(seed)

    def normal(*shape: int) -> torch.Tensor:
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02))

    return {"norm_scale": torch.ones(hidden), "ffn.router": normal(hidden, n_experts),
            "ffn.w_in": normal(n_experts, hidden, ffn_hidden), "ffn.w_out": normal(n_experts, ffn_hidden, hidden)}


def init_expert_parallel(n_experts: int, hidden: int, ffn_hidden: int, mesh, *, device: Any = "cuda",
                         seed: int = 0, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                         expert_axis: str = "expert") -> Dict[str, Any]:
    """``{"model": block, "shardings": specs}``: a :class:`MoEBlock`
    placed over ``mesh`` (JAX's ``init_expert_parallel``).  Each rank
    loads its experts' slice of the whole ``state_dict`` (by default
    :func:`moe_state_dict` of ``seed``); a ``fsdp`` axis > 1 then shards
    the parameters with FSDP2 on :func:`moe_param_shardings`' dims."""
    from traceml_tpu_torch.models.convert import local_state_dict
    from traceml_tpu_torch.parallel.mesh import axis_size

    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        block = MoEBlock(n_experts, hidden, ffn_hidden, device=dev, mesh=mesh, expert_axis=expert_axis)
    whole = state_dict if state_dict is not None else moe_state_dict(n_experts, hidden, ffn_hidden, seed)
    specs = moe_param_shardings(whole, mesh, expert_axis)
    block.load_state_dict(local_state_dict(whole, specs, mesh, (expert_axis,)))
    if axis_size(mesh, "fsdp") > 1:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        fsdp_at = list(mesh.mesh_dim_names).index("fsdp")
        dims = {p: getattr(specs[name][fsdp_at], "dim", 0) for name, p in block.named_parameters()}
        fully_shard(block, mesh=mesh["fsdp"], shard_placement_fn=lambda p: Shard(dims[p]))
    return {"model": block, "shardings": specs}


def make_moe_train_step(model: MoEBlock, learning_rate: float = 1e-3, aux_weight: float = 0.01
                        ) -> Tuple[torch.optim.Adam, Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]]:
    """``(optimizer, train_step)``: ``train_step(x, y)`` takes the loss
    ``mean((out − y)²) + aux_weight · aux``, its gradients and one Adam
    update (lr ``learning_rate``, ``optax.adam``'s defaults: β 0.9, 0.999,
    ε 1e-8 outside the root, as torch's), and returns ``{"loss", "mse",
    "aux"}`` on the device, unsynchronized.  Every rank holds the same
    loss: the block's output is replicated."""
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def train_step(x: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, aux = model(x)
        mse = ((out - y) ** 2).mean()
        loss = mse + aux_weight * aux
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return {"loss": loss.detach(), "mse": mse.detach(), "aux": aux.detach()}

    return optimizer, train_step


__all__ = ["MoEFFN", "MoEBlock", "moe_param_shardings", "moe_state_dict", "init_expert_parallel",
           "make_moe_train_step"]
