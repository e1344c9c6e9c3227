"""Pipeline parallelism over a mesh axis, in PyTorch.

Counterpart of ``traceml_tpu/parallel/pipeline.py``: a GPipe schedule of
``n_microbatches + S − 1`` ticks over the ``stage`` axis (S ranks).

* Per-stage parameters are stacked on a leading stage dim
  (:func:`stack_stage_params`) and sharded over ``stage``
  (:func:`stage_param_shardings`; :func:`shard_stage_params` places them
  as DTensors), so each rank holds its stage.
* Every rank runs the same loop of ticks.  Stage 0 injects microbatch t
  at tick t (ticks past the last microbatch inject it again, into the
  bubble); the others take what the previous stage sent.  The last stage
  collects microbatch m at tick m + S − 1.  After each tick the stage's
  output goes one hop round the ring (``parallel/comm.py:ring_hop``,
  ``dist.batch_isend_irecv``, where JAX uses ``lax.ppermute``); its
  backward sends the gradient back the other way, as ``ppermute``'s
  transpose does.  The wrap-around edge is ignored by stage 0's
  injection select.
* The selects are ``torch.where`` on masks, as the JAX ones are
  ``jnp.where``: every tick's hop and stage computation stays in each
  rank's autograd graph, so every rank runs every hop's backward in the
  same (reverse tick) order and the ring's sends and receives pair up.
  The last tick's hop, whose output nothing reads, is skipped: the
  schedule hops ``n_microbatches + S − 2`` times each way.
* At the end every rank returns the last stage's collected outputs: an
  all-reduce of the stage-masked buffers (JAX's closing ``psum``), whose
  backward passes the gradient through unchanged
  (``reduce_from_group``).  Each rank's loss then sends its gradient to
  the last stage's buffer only, and each stage's parameters get the
  gradient of one loss, as under ``jax.grad`` (JAX's closing ``psum``
  adds no factor either).

At ``stage`` = 1 the hop and the all-reduce are the identity and are
skipped.  The stage computation here (:func:`linear_stage_apply`) is
plain torch, as the JAX one is jnp: no kernel of the port's is on this
path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from traceml_tpu_torch.parallel.comm import reduce_from_group, ring_hop
from traceml_tpu_torch.utils.device import resolve_device


def stack_stage_params(per_stage_params: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """[stage0 params, stage1 params, …] → one dict with a leading stage
    dim on each leaf."""
    return {name: torch.stack([p[name] for p in per_stage_params]) for name in per_stage_params[0]}


def stage_param_shardings(stacked_params: Dict[str, torch.Tensor], mesh, axis: str = "stage"
                          ) -> Dict[str, Tuple[Any, ...]]:
    """The leading (stage) dim over the pipeline axis, the rest replicated
    within the stage group, as DTensor placements (one per mesh dim)."""
    from torch.distributed.tensor import Replicate, Shard

    from traceml_tpu_torch.parallel.mesh import axis_sizes

    return {name: tuple(Shard(0) if ax == axis else Replicate() for ax in axis_sizes(mesh))
            for name in stacked_params}


def shard_stage_params(stacked_params: Dict[str, torch.Tensor], mesh, axis: str = "stage"
                       ) -> Dict[str, torch.nn.Parameter]:
    """The stacked params placed by :func:`stage_param_shardings`, as
    DTensor parameters: each rank keeps its stage's slice of the whole
    stack it holds (no communication), their shape the global one."""
    from torch.distributed.tensor import distribute_tensor

    specs = stage_param_shardings(stacked_params, mesh, axis)
    return {name: torch.nn.Parameter(distribute_tensor(t, mesh, specs[name], src_data_rank=None))
            for name, t in stacked_params.items()}


def make_pipeline_fn(stage_apply: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor], mesh,
                     n_microbatches: int, axis: str = "stage"):
    """Build the pipelined forward.

    ``stage_apply(stage_params, x) -> x`` is one stage's computation
    (stage params WITHOUT the leading stage dim).  Returns
    ``pipeline_fn(stacked_params, microbatches)`` with ``stacked_params``
    the stacked params, DTensors sharded over ``axis``
    (:func:`shard_stage_params`) or whole tensors every rank holds, and
    ``microbatches`` (n_micro, mb, …), the same on every rank →
    (n_micro, mb, …) outputs, the last stage's, on every rank."""
    from torch.distributed.tensor import Replicate, Shard

    from traceml_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size, axis_sizes, local_shard

    n_stages = axis_size(mesh, axis)
    total_ticks = n_microbatches + n_stages - 1
    stage_index = axis_index(mesh, axis)
    group = axis_group(mesh, axis) if n_stages > 1 else None
    # every leaf's placements (stage_param_shardings'), and the select masks
    # on each device, made once: a tensor made from a host bool is a
    # synchronous copy
    placements = tuple(Shard(0) if ax == axis else Replicate() for ax in axis_sizes(mesh))
    flags: Dict[Tuple[torch.device, bool], torch.Tensor] = {}

    def flag(value: bool, device: torch.device) -> torch.Tensor:
        if (device, value) not in flags:
            flags[device, value] = torch.tensor(value, device=device)
        return flags[device, value]

    def _check_stage_dim(stacked_params) -> None:
        for leaf in stacked_params.values():
            if leaf.shape[0] != n_stages:
                raise ValueError(
                    f"stacked stage dim {leaf.shape[0]} != mesh {axis} "
                    f"size {n_stages} — each chip must hold exactly one "
                    "stage (a mismatch would silently drop stages)"
                )

    def _local(leaf: torch.Tensor) -> torch.Tensor:
        if hasattr(leaf, "to_local"):
            return leaf.to_local()[0]
        return local_shard(leaf, mesh, placements)[0]

    def pipeline_fn(stacked_params: Dict[str, torch.Tensor], microbatches: torch.Tensor) -> torch.Tensor:
        _check_stage_dim(stacked_params)
        if microbatches.shape[0] != n_microbatches:
            raise ValueError(
                f"got {microbatches.shape[0]} microbatches, schedule was "
                f"built for {n_microbatches} — the clamp in the injection "
                "gather would silently duplicate the last microbatch"
            )
        params = {name: _local(leaf) for name, leaf in stacked_params.items()}
        dev = microbatches.device
        last = stage_index == n_stages - 1
        outputs = [torch.zeros_like(microbatches[0]) for _ in range(n_microbatches)]
        inbuf = torch.zeros_like(microbatches[0])
        for t in range(total_ticks):
            x = torch.where(flag(stage_index == 0, dev), microbatches[min(t, n_microbatches - 1)], inbuf)
            y = stage_apply(params, x)
            # microbatch m completes on the last stage at tick m + S − 1
            m = min(max(t - (n_stages - 1), 0), n_microbatches - 1)
            outputs[m] = torch.where(flag(last and t >= n_stages - 1, dev), y, outputs[m])
            if t < total_ticks - 1:  # the last tick's hop would be dead
                inbuf = ring_hop(y, group)
        # every rank returns the LAST stage's outputs: the sum of the
        # stage-masked buffers, the gradient passed through to each
        return reduce_from_group(torch.stack(outputs) * flag(last, dev), group)

    return pipeline_fn


def _local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself, which its in-place
    updates write), or ``t``."""
    return getattr(t, "_local_tensor", t)


def make_pipeline_train_step(stage_apply: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor], mesh,
                             n_microbatches: int, axis: str = "stage", learning_rate: float = 1e-2
                             ) -> Tuple[Callable, Callable]:
    """``(init, train_step)`` for a pipelined regression objective:
    ``init(stacked_params)`` gives the SGD optimizer (``optax.sgd``: no
    momentum), ``train_step(stacked_params, optimizer, micro_x,
    micro_y)`` takes ``mean((out − micro_y)²)``, its gradients through the
    schedule and one update in place, and returns ``{"loss": loss}`` on
    the device (the same on every rank).

    The optimizer steps each parameter's local tensor, a DTensor's shard
    (this rank's stage) with the shard of its gradient: the update is
    elementwise, so it is the same, without DTensor's dispatch on every
    op of the step."""
    pipeline_fn = make_pipeline_fn(stage_apply, mesh, n_microbatches, axis)

    def init(stacked_params: Dict[str, torch.Tensor]) -> torch.optim.SGD:
        return torch.optim.SGD([_local_tensor(p) for p in stacked_params.values()], lr=learning_rate)

    def train_step(stacked_params, optimizer, micro_x, micro_y) -> Dict[str, torch.Tensor]:
        loss = ((pipeline_fn(stacked_params, micro_x) - micro_y) ** 2).mean()
        loss.backward()
        for p in stacked_params.values():
            local = _local_tensor(p)
            if local is not p:
                local.grad, p.grad = _local_tensor(p.grad), None
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return {"loss": loss.detach()}

    return init, train_step


def linear_stage_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Reference stage: y = tanh(x @ w + b)."""
    return torch.tanh(x @ params["w"] + params["b"])


def init_linear_stages(n_stages: int, width: int, seed: int, device: Any = "cuda") -> List[Dict[str, torch.Tensor]]:
    """``n_stages`` linear stages from a numpy seed: ``w`` (width, width)
    normal × 0.3, ``b`` zeros, f32 (JAX's ``init_linear_stages`` with a
    numpy generator in place of the JAX key)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return [{"w": torch.from_numpy(rng.standard_normal((width, width), dtype=np.float32) * np.float32(0.3)).to(dev),
             "b": torch.zeros(width, device=dev)} for _ in range(n_stages)]


__all__ = ["stack_stage_params", "stage_param_shardings", "shard_stage_params", "make_pipeline_fn",
           "make_pipeline_train_step", "linear_stage_apply", "init_linear_stages"]
