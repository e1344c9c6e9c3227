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


def _whole(model, name: str, t: torch.Tensor) -> np.ndarray:
    """The whole (global) value of parameter ``name``'s tensor ``t``: FSDP2's
    shards gathered (``full_tensor``), then a tensor-parallel model's
    slices gathered over ``tensor`` on the dim ``param_shardings`` gives
    it.  Collectives: every rank calls it for every name in one order."""
    from traceml_tpu_torch.models import transformer as tf
    from traceml_tpu_torch.parallel.mesh import axis_group

    t = _full(t).detach().float()
    tp = getattr(model, "tp", None)
    if tp is None or tp.size == 1:
        return t.numpy()
    mesh = model.cfg.mesh
    spec = tf.param_shardings({name: t}, mesh)[name][list(mesh.mesh_dim_names).index("tensor")]
    if not hasattr(spec, "dim"):
        return t.numpy()
    parts = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(parts, t.contiguous(), group=axis_group(mesh, "tensor"))
    return torch.cat(parts, dim=spec.dim).numpy()


def train_step(shape: Dict[str, int], impl: str, fsdp: bool, start: Dict[str, Any], batches: Sequence[np.ndarray],
               dtype: str = "float32", remat: bool = False, overrides: Optional[Dict[str, Any]] = None):
    """The tiny DecoderLM (its fields replaced by ``overrides``) from the
    JAX params ``start`` (``params_from_jax``) on ``make_mesh(shape)``:
    ``impl`` attention (ring / Ulysses over ``context``, or dense),
    tensor-parallel over a ``tensor`` axis, FSDP2-sharded when ``fsdp``
    (else the gradients averaged by ``average_gradients`` over
    ``gradient_group``).  Returns the global losses of ``len(batches)``
    AdamW steps and, on rank 0, the first batch's whole gradients and the
    whole parameters after the steps."""
    from traceml_tpu_torch.models import transformer as tf
    from traceml_tpu_torch.models.convert import params_from_jax

    mesh = _mesh(shape)
    cfg = dataclasses.replace(tf.ModelConfig.tiny(), dtype=DTYPES[dtype], remat=remat, mesh=mesh,
                              attention_impl=impl, context_axis="context" if impl != "dense" else None,
                              **(overrides or {}))
    model, optimizer = tf.init_train_state(cfg, device="cpu", mesh=mesh if fsdp else None,
                                           state_dict=params_from_jax(start))
    assert tf.is_sharded(model) == fsdp
    tokens = [torch.from_numpy(b).long() for b in batches]
    tf.loss_fn(model, tokens[0]).backward()
    group, n = tf.gradient_group(mesh)
    if not fsdp and n > 1:
        tf.average_gradients(model, group, n)()
    grads = {n: _whole(model, n, p.grad) for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    step = tf.make_train_step(model, optimizer)
    losses = [float(step(t)["loss"]) for t in tokens]
    end = {n: _whole(model, n, p) for n, p in model.named_parameters()}  # collectives: every rank
    if dist.get_rank() != 0:
        return losses, None, None
    return losses, grads, end


def tensor_parallel_layout(shape: Dict[str, int], overrides: Optional[Dict[str, Any]] = None):
    """The tiny DecoderLM built tensor-parallel on ``make_mesh(shape)``
    (``init_train_state``, no FSDP2): this rank's tensor coordinate, each
    parameter's local and whole element counts, the size and the ranks
    of ``gradient_group``, or the ``ValueError`` text the build raised."""
    from traceml_tpu_torch.models import transformer as tf

    mesh = _mesh(shape)
    cfg = dataclasses.replace(tf.ModelConfig.tiny(), mesh=mesh, **(overrides or {}))
    try:
        model, _ = tf.init_train_state(cfg, device="cpu")
    except ValueError as exc:
        return str(exc)
    whole = tf.DecoderLM(dataclasses.replace(cfg, mesh=None), device="cpu")
    sizes = {n: (p.numel(), dict(whole.named_parameters())[n].numel()) for n, p in model.named_parameters()}
    group, n = tf.gradient_group(mesh)
    ranks = dist.get_process_group_ranks(group) if group is not None else [dist.get_rank()]
    return mesh.get_local_rank("tensor"), sizes, n, sorted(ranks)


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


def build_raises(shape: Dict[str, int], tensor_parallel: bool = False) -> str:
    """The text ``init_train_state(mesh=make_mesh(shape))`` of the tiny
    DecoderLM raises (``NotImplementedError`` or ``ValueError``), or "no
    error"; ``tensor_parallel`` sets ``cfg.mesh`` to the mesh too."""
    from traceml_tpu_torch.models import transformer as tf

    mesh = _mesh(shape)
    cfg = dataclasses.replace(tf.ModelConfig.tiny(), mesh=mesh if tensor_parallel else None)
    try:
        tf.init_train_state(cfg, device="cpu", mesh=mesh)
    except (NotImplementedError, ValueError) as exc:
        return f"{type(exc).__name__}: {exc}"
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


# -- expert parallelism (MoE) ------------------------------------------------------


def _gather_experts(block, name: str, t: torch.Tensor, expert_axis: str = "expert") -> np.ndarray:
    """The whole value of a MoE parameter's tensor: FSDP2's shards gathered,
    then the experts over ``expert_axis`` (dim 0 of ``w_in``/``w_out``)."""
    from traceml_tpu_torch.parallel.mesh import axis_group

    t = _full(t).detach().float()
    ffn = block.ffn
    if name.split(".")[-1] not in ("w_in", "w_out") or ffn.ep == 1:
        return t.numpy()
    parts = [torch.empty_like(t) for _ in range(ffn.ep)]
    dist.all_gather(parts, t.contiguous(), group=ffn.group)
    return torch.cat(parts, dim=0).numpy()


def moe_grads(shape: Dict[str, int], params: Dict[str, Any], x: np.ndarray, y: np.ndarray, aux_weight: float):
    """The MoE block from the flax ``params`` (``moe_params_from_jax``)
    placed by ``init_expert_parallel`` on ``make_mesh(shape)``: its
    output, aux loss and loss ``mse + aux_weight · aux`` on ``x``, ``y``,
    the whole gradients of every parameter and of ``x``, and this rank's
    expert count."""
    from traceml_tpu_torch.models.convert import moe_params_from_jax
    from traceml_tpu_torch.models.moe import init_expert_parallel

    mesh = _mesh(shape)
    E, H = params["MoEFFN_0"]["router"].shape[1], x.shape[-1]
    F = params["MoEFFN_0"]["w_in"].shape[-1]
    block = init_expert_parallel(E, H, F, mesh, device="cpu", state_dict=moe_params_from_jax(params))["model"]
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = block(xt)
    loss = ((out - torch.from_numpy(y)) ** 2).mean() + aux_weight * aux
    loss.backward()
    local = block.ffn.w_in.shape[0]
    grads = {n: _gather_experts(block, n, p.grad) for n, p in block.named_parameters()}
    grads["x"] = xt.grad.numpy()
    return out.detach().numpy(), aux.item(), loss.item(), grads, local


def moe_train(shape: Dict[str, int], params: Dict[str, Any], x: np.ndarray, y: np.ndarray, steps: int):
    """The losses of ``steps`` Adam steps of ``make_moe_train_step`` on the
    placed block, and whether every parameter is still this rank's
    slice afterwards (FSDP2 DTensors stay DTensors)."""
    from traceml_tpu_torch.models.convert import moe_params_from_jax
    from traceml_tpu_torch.models.moe import init_expert_parallel, make_moe_train_step

    mesh = _mesh(shape)
    E, H = params["MoEFFN_0"]["router"].shape[1], x.shape[-1]
    F = params["MoEFFN_0"]["w_in"].shape[-1]
    block = init_expert_parallel(E, H, F, mesh, device="cpu", state_dict=moe_params_from_jax(params))["model"]
    _, step = make_moe_train_step(block)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    metrics = [step(xt, yt) for _ in range(steps)]
    return [float(m["loss"]) for m in metrics], [float(m["aux"]) for m in metrics], \
        block.ffn.w_in.shape[0]


# -- pipeline parallelism ------------------------------------------------------


def pipeline_run(shape: Dict[str, int], stacked: Dict[str, np.ndarray], x: np.ndarray, y: np.ndarray,
                 n_micro: int):
    """``make_pipeline_fn(linear_stage_apply)`` on ``make_mesh(shape)`` with
    the stacked stage params placed by ``shard_stage_params``, under
    ``patch_dist_collectives``: the output on ``x``, the whole gradients
    of ``mean((out − y)²)``, and the collectives the patch recorded in the
    forward and in the backward (op, bytes)."""
    from traceml_tpu_torch.instrumentation import collectives as coll
    from traceml_tpu_torch.models.convert import stage_params_from_jax
    from traceml_tpu_torch.parallel.pipeline import linear_stage_apply, make_pipeline_fn, shard_stage_params

    mesh = _mesh(shape)
    params = shard_stage_params(stage_params_from_jax(stacked), mesh)
    fn = make_pipeline_fn(linear_stage_apply, mesh, n_micro)
    saved = {name: getattr(dist, name) for name in coll._DIST_COLLECTIVES if hasattr(dist, name)}
    coll._dist_patched = False
    coll.GLOBAL_COLLECTIVES_QUEUE.drain()
    try:
        assert coll.patch_dist_collectives()
        out = fn(params, torch.from_numpy(x))
        forward = [(r["op"], r["bytes"]) for r in coll.GLOBAL_COLLECTIVES_QUEUE.drain()]
        ((out - torch.from_numpy(y)) ** 2).mean().backward()
        backward = [(r["op"], r["bytes"]) for r in coll.GLOBAL_COLLECTIVES_QUEUE.drain()]
    finally:
        for name, f in saved.items():
            setattr(dist, name, f)
        coll._dist_patched = False
    grads = {n: _full(p.grad).numpy() for n, p in params.items()}
    return out.detach().numpy(), grads, forward, backward


def pipeline_train(shape: Dict[str, int], stacked: Dict[str, np.ndarray], x: np.ndarray, y: np.ndarray,
                   n_micro: int, steps: int, lr: float):
    """The losses of ``steps`` SGD steps of ``make_pipeline_train_step``."""
    from traceml_tpu_torch.models.convert import stage_params_from_jax
    from traceml_tpu_torch.parallel.pipeline import linear_stage_apply, make_pipeline_train_step, shard_stage_params

    mesh = _mesh(shape)
    params = shard_stage_params(stage_params_from_jax(stacked), mesh)
    init, step = make_pipeline_train_step(linear_stage_apply, mesh, n_micro, learning_rate=lr)
    optimizer = init(params)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    return [float(step(params, optimizer, xt, yt)["loss"]) for _ in range(steps)]


def pipeline_errors(shape: Dict[str, int], stacked: Dict[str, np.ndarray], x: np.ndarray, n_micro: int):
    """The ``ValueError`` texts of ``pipeline_fn`` for a stack of one stage
    too many and for one microbatch too few."""
    from traceml_tpu_torch.models.convert import stage_params_from_jax
    from traceml_tpu_torch.parallel.pipeline import linear_stage_apply, make_pipeline_fn

    mesh = _mesh(shape)
    fn = make_pipeline_fn(linear_stage_apply, mesh, n_micro)
    params = stage_params_from_jax(stacked)
    texts = []
    for args in (({k: torch.cat([v, v[:1]]) for k, v in params.items()}, torch.from_numpy(x)),
                 (params, torch.from_numpy(x[:-1]))):
        try:
            fn(*args)
            texts.append("no error")
        except ValueError as exc:
            texts.append(str(exc))
    return texts
