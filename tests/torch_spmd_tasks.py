"""Tasks the spawned gloo ranks of ``tests/torch_spmd.py`` run.

Each runs on every rank with the same arguments (numpy arrays made from
a seed in the test process) and returns plain data: numpy arrays, lists,
placements.  This module imports torch and the port only, never JAX: the
tests hold the results against the JAX package in their own process.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mesh(shape: Dict[str, int]):
    from traceml_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shape, device_type="cpu")


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _np(t: torch.Tensor) -> np.ndarray:
    return _full(t).detach().float().numpy()


# -- sequence-parallel attention ------------------------------------------


def attention(impl: str, shape: Dict[str, int], dtype: str, q, k, v, g):
    """This rank's sequence shard of the global (B, S, H, D) q, k, v
    through ring or Ulysses attention over the mesh's context axis: the
    rank's context index, its output and the gradients of
    ``sum(out · g)`` with respect to its q, k, v shards (f32 numpy)."""
    from traceml_tpu_torch.ops.ring_attention import ring_attention
    from traceml_tpu_torch.ops.ulysses_attention import ulysses_attention

    mesh = _mesh(shape)
    P = shape["context"]
    c = mesh.get_local_rank("context")
    n = q.shape[1] // P
    part = slice(c * n, (c + 1) * n)
    loc = [torch.from_numpy(x[:, part]).to(DTYPES[dtype]).requires_grad_(True) for x in (q, k, v)]
    op = ring_attention if impl == "ring" else ulysses_attention
    out = op(*loc, mesh.get_group("context"))
    (out.float() * torch.from_numpy(g[:, part])).sum().backward()
    return c, [_np(t) for t in (out, *(x.grad for x in loc))]


def attention_dtensor(impl: str, shape: Dict[str, int], q, k, v, g):
    """``make_ring_attention`` / ``make_ulysses_attention`` on DTensors
    sharded by sequence over the context axis: the whole output and the
    whole gradients of ``sum(out · g)``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from traceml_tpu_torch.ops.ring_attention import make_ring_attention
    from traceml_tpu_torch.ops.ulysses_attention import make_ulysses_attention

    mesh = _mesh(shape)
    placements = tuple(Shard(1) if ax == "context" else Replicate() for ax in mesh.mesh_dim_names)
    ts = [distribute_tensor(torch.from_numpy(x), mesh, placements, src_data_rank=None).requires_grad_(True)
          for x in (q, k, v)]
    fn = (make_ring_attention if impl == "ring" else make_ulysses_attention)(mesh, "context")
    out = fn(*ts)
    (out.full_tensor() * torch.from_numpy(g)).sum().backward()
    return [_np(t) for t in (out, *(x.grad for x in ts))], [str(p) for p in out.placements]


def indivisible_heads(shape: Dict[str, int]) -> str:
    from traceml_tpu_torch.ops.ulysses_attention import ulysses_attention

    mesh = _mesh(shape)
    x = torch.zeros((1, 4, 3, 8))
    try:
        ulysses_attention(x, x, x, mesh.get_group("context"))
    except ValueError as exc:
        return str(exc)
    return "no error"


# -- the train step ---------------------------------------------------------


def train_step(shape: Dict[str, int], impl: str, fsdp: bool, start: Dict[str, Any], batches: Sequence[np.ndarray],
               dtype: str = "float32", remat: bool = False):
    """The tiny DecoderLM from the JAX params ``start``
    (``params_from_jax``) on ``make_mesh(shape)``: ``impl`` attention
    (ring / Ulysses over ``context``, or dense), FSDP2-sharded when
    ``fsdp`` (else the gradients averaged by ``average_gradients``).
    Returns the global losses of ``len(batches)`` AdamW steps and, on rank
    0, the first batch's whole gradients and the whole parameters after
    the steps."""
    from traceml_tpu_torch.models import transformer as tf
    from traceml_tpu_torch.models.convert import params_from_jax
    from traceml_tpu_torch.parallel.mesh import mesh_group

    mesh = _mesh(shape)
    cfg = dataclasses.replace(tf.ModelConfig.tiny(), dtype=DTYPES[dtype], remat=remat, mesh=mesh,
                              attention_impl=impl, context_axis="context" if impl != "dense" else None)
    model, optimizer = tf.init_train_state(cfg, device="cpu", mesh=mesh if fsdp else None,
                                           state_dict=params_from_jax(start))
    assert tf.is_sharded(model) == fsdp
    tokens = [torch.from_numpy(b).long() for b in batches]
    tf.loss_fn(model, tokens[0]).backward()
    if not fsdp and mesh.size() > 1:
        tf.average_gradients(model, mesh_group(mesh), mesh.size())()
    grads = {n: _np(p.grad) for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    step = tf.make_train_step(model, optimizer)
    losses = [float(step(t)["loss"]) for t in tokens]
    end = {n: _np(p) for n, p in model.named_parameters()}  # full_tensor() is a collective: every rank
    if dist.get_rank() != 0:
        return losses, None, None
    return losses, grads, end


def fsdp_layout(shape: Dict[str, int]):
    """FSDP2's placement and local shape of every parameter of the tiny
    model under ``init_train_state(mesh=make_mesh(shape))``, with
    ``param_shardings``' placements on the same mesh."""
    from traceml_tpu_torch.models import transformer as tf

    mesh = _mesh(shape)
    model, optimizer = tf.init_train_state(tf.ModelConfig.tiny(), device="cpu", mesh=mesh)
    specs = tf.param_shardings(model, mesh)
    state = optimizer.state[next(iter(model.parameters()))]
    return ({n: ([str(x) for x in p.placements], tuple(p.to_local().shape), tuple(p.shape), str(p.device_mesh))
             for n, p in model.named_parameters()},
            {n: [str(x) for x in s] for n, s in specs.items()},
            type(state["exp_avg"]).__name__)


def step_flops(shape: Dict[str, int], impl: str, fsdp: bool, tokens: np.ndarray) -> float:
    """``estimate_step_flops`` of one train step of the tiny model on this
    rank (its shard of the global batch)."""
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.models import transformer as tf
    from traceml_tpu_torch.sdk.state import get_state

    get_state().set_device("cpu")
    mesh = _mesh(shape)
    cfg = dataclasses.replace(tf.ModelConfig.tiny(), mesh=mesh, attention_impl=impl,
                              context_axis="context" if impl != "dense" else None)
    model, optimizer = tf.init_train_state(cfg, device="cpu", mesh=mesh if fsdp else None)
    return tm.estimate_step_flops(tf.make_train_step(model, optimizer), torch.from_numpy(tokens).long())


def build_raises(shape: Dict[str, int]) -> str:
    from traceml_tpu_torch.models import transformer as tf

    mesh = _mesh(shape)
    try:
        tf.init_train_state(tf.ModelConfig.tiny(), device="cpu", mesh=mesh)
    except NotImplementedError as exc:
        return str(exc)
    return "no error"


# -- specs and placements -----------------------------------------------------


def specs(shape: Dict[str, int], cases: Sequence[tuple]):
    """``seq_parallel_spec`` on a real DeviceMesh for each (impl, n_heads,
    batch size) case, and ``param_shardings`` of the tiny model."""
    from traceml_tpu_torch.models import transformer as tf

    mesh = _mesh(shape)
    out = {}
    for impl, n_heads, batch in cases:
        cfg = dataclasses.replace(tf.ModelConfig.tiny(), n_heads=n_heads, attention_impl=impl,
                                  context_axis="context", mesh=mesh)
        out[(impl, n_heads, batch)] = [str(p) for p in tf.seq_parallel_spec(cfg, batch_size=batch)]
    model = tf.DecoderLM(tf.ModelConfig.tiny(), device="cpu")
    return out, {n: [str(p) for p in s] for n, s in tf.param_shardings(model, mesh).items()}


def batch_shard(shape: Dict[str, int], tokens: np.ndarray):
    """This rank's coordinate, its ``local_shard`` and DTensor piece of
    ``tokens`` under ``batch_sharding``, and both placements' strings."""
    from torch.distributed.tensor import distribute_tensor

    from traceml_tpu_torch.parallel.mesh import batch_sharding, local_shard, replicated

    mesh = _mesh(shape)
    pl = batch_sharding(mesh)
    t = torch.from_numpy(tokens)
    return (tuple(mesh.get_coordinate()), local_shard(t, mesh, pl).numpy(),
            distribute_tensor(t, mesh, pl, src_data_rank=None).to_local().numpy(),
            [str(p) for p in pl], [str(p) for p in replicated(mesh)])


# -- the stat all-gather ---------------------------------------------------------


def stat_gather(shape: Dict[str, int], vectors: List[Dict[str, float]], axis: Optional[str] = None):
    """``IciStatAggregator(make_mesh(shape), axis)``: ``aggregate_many``
    of ``vectors`` and ``aggregate`` of this rank's own entry, and the
    rank skew of ``step_ms`` on the first."""
    from traceml_tpu_torch.parallel.ici_stats import IciStatAggregator, StatVector

    mesh = _mesh(shape)
    agg = IciStatAggregator(mesh, axis=axis)
    many = agg.aggregate_many([StatVector(v) for v in vectors])
    me = dist.get_rank(agg._group)
    own = agg.aggregate(StatVector(vectors[me]))
    return agg.n_participants, many, own, agg.rank_skew(many, "step_ms")


def _events(steps: Sequence[tuple]):
    from traceml_tpu_torch.utils.timing import DeviceMarker, TimeEvent

    out = []
    for name, step, start, end, ready in steps:
        ev = TimeEvent(name, step)
        ev.cpu_start, ev.cpu_end = start, end
        if ready is not None:
            ev.marker = DeviceMarker([], dispatched_at=ready)
        out.append(ev)
    return out


def hook_run(shape: Dict[str, int], every: int, per_rank: Dict[int, List[tuple]]):
    """``IciTelemetryHook`` installed on a fresh ``TraceState``: this
    rank's steps (``per_rank[rank]``: ``(step, events)`` with events
    ``(name, step, cpu_start, cpu_end, device ready or None)``; a step
    with no events flushes no batch) flushed one by one.  Returns the
    gathers, the last matrix, the rows, the diagnosis, the rank skew of
    ``step_ms`` and whether ``uninstall`` removed both callbacks."""
    from traceml_tpu_torch.parallel.ici_telemetry import IciTelemetryHook
    from traceml_tpu_torch.sdk.state import TraceState

    mesh = _mesh(shape)
    state = TraceState(device="cpu")
    hook = IciTelemetryHook(mesh, every_n_steps=every, window_steps=200).install(state)
    for step, events in per_rank[dist.get_rank()]:
        for ev in _events(events):
            state.buffer.add(ev)
        state.flush_step(step)
    result = hook.diagnose()
    hook.uninstall()
    removed = not state.on_batch_flushed and not state.on_step_flushed
    issues = [(i.kind, i.severity, i.summary, tuple(i.ranks)) for i in result.issues]
    return (hook.gather_count, hook.last_matrix, hook.rank_rows(), issues, hook.rank_skew("step_ms"), removed,
            len(hook.wait_ms), len(hook.gather_ms))
