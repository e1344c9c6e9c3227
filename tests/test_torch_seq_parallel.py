"""Sequence-parallel attention, the sharded train step and the mesh's
placements, held against the JAX package.

The port's side runs on one world of 4 spawned gloo ranks
(``tests/torch_spmd.py``, a module-scoped fixture); the JAX side on the
8 virtual CPU devices of ``tests/conftest.py``.  Inputs come from a
numpy seed; the model's weights from the JAX ``init_train_state``
through ``params_from_jax``.

* Ring and Ulysses attention (``ops/ring_attention.py``,
  ``ops/ulysses_attention.py``) against ``make_ring_attention`` and
  ``make_ulysses_attention`` at P = 2 (mesh {fsdp: 2, context: 2}) and
  P = 4 ({context: 4}): the output and ``jax.grad`` of ``sum(out · g)``
  with respect to q, k and v, by ‖port − jax‖_F / ‖jax‖_F.  f32 ≤ 1e-5
  (the same block order and f32 accumulation; sum order only); bf16 ≤
  1e-2 (both round scores, probabilities and products to bf16 at the
  same places, XLA and PyTorch accumulate the bf16 products in another
  order).  The DTensor wrappers (``make_*_attention``) at P = 2 in f32.
* Causality across shards: with the output gradient on the first shard
  only, the K/V gradients of every later shard are exactly 0, and the
  first shard's output does not move when later shards' K/V change.
* Ulysses with heads indivisible by P raises JAX's ``ValueError`` text.
* The tiny DecoderLM's AdamW step with ring and Ulysses attention on
  {fsdp: 2, context: 2}, FSDP2-sharded over the flattened fsdp × context
  (``init_train_state(mesh=)``), against the JAX ``init_train_state(mesh=)``
  + ``make_train_step``: the losses of 3 steps within 1e-5 relative and
  the parameters after them within 1e-5 relative Frobenius (the f32
  bounds of ``tests/test_torch_train_step.py``), the first step's
  gradients within 1e-5 relative Frobenius.  The {context: 2} cases run
  in ``tests/test_torch_fsdp.py``'s 2-rank world.
* ``seq_parallel_spec`` and ``param_shardings`` against JAX's specs over
  a table of mesh shapes, head counts and batch sizes, each JAX
  ``PartitionSpec`` read as placements (a flax kernel's two dims swap,
  ``models/convert.py``): on a stand-in mesh for 8-device shapes and on
  a real ``DeviceMesh`` for 4-rank ones.
* ``batch_sharding``: each rank's ``local_shard`` and its DTensor piece
  equal the JAX addressable shard of the device at the same mesh
  coordinate; ``replicated`` is all ``Replicate``.
* ``_attend``'s errors are JAX's: an unknown impl, ring or Ulysses
  without ``mesh``/``context_axis``; a ``tensor`` axis > 1 on a model
  not built tensor-parallel raises ``ValueError``, an ``expert`` or
  ``stage`` axis ``NotImplementedError``.
"""

import dataclasses
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

import torch_spmd_tasks as tasks  # noqa: E402
from torch_spmd import World  # noqa: E402
from traceml_tpu.models import transformer as jax_tf  # noqa: E402
from traceml_tpu.ops.ring_attention import make_ring_attention  # noqa: E402
from traceml_tpu.ops.ulysses_attention import make_ulysses_attention  # noqa: E402
from traceml_tpu.parallel import mesh as jax_mesh  # noqa: E402
from traceml_tpu_torch.models import transformer as tf  # noqa: E402
from traceml_tpu_torch.models.convert import params_from_jax  # noqa: E402

ATTN_SHAPE = (2, 32, 4, 16)  # (B, S, H, D)
ATTN_BOUND = {"float32": 1e-5, "bfloat16": 1e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TRAIN_BOUND = {"loss": 1e-5, "param": 1e-5, "grad": 1e-5}
BATCH, TOKENS, STEPS = 2, 33, 3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("spmd4"))
    yield w
    w.close()


def rel_fro(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return jax_mesh.make_mesh(shape, devices=jax.devices()[:n])


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(ATTN_SHAPE).astype(np.float32) for _ in range(4)]


def _jax_attention(impl, P, dtype, q, k, v, g):
    fn = (make_ring_attention if impl == "ring" else make_ulysses_attention)(_jmesh({"context": P}), "context")
    cast = [jnp.asarray(x, JDT[dtype]) for x in (q, k, v)]

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * jnp.asarray(g))

    out = fn(*cast)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*cast)
    return [np.asarray(jnp.asarray(t, jnp.float32)) for t in (out, *grads)]


def _port_attention(world, impl, P, dtype, q, k, v, g):
    shape = {"fsdp": 4 // P, "context": P}
    by_shard = {}
    for c, parts in world.run(tasks.attention, impl, shape, dtype, q, k, v, g):
        by_shard.setdefault(c, parts)
    return [np.concatenate([by_shard[c][i] for c in range(P)], axis=1) for i in range(4)]


@pytest.mark.parametrize("impl,P,dtype", list(itertools.product(("ring", "ulysses"), (2, 4),
                                                                  ("float32", "bfloat16"))))
def test_attention_and_its_gradient_match_jax(world, impl, P, dtype):
    q, k, v, g = _inputs()
    want = _jax_attention(impl, P, dtype, q, k, v, g)
    got = _port_attention(world, impl, P, dtype, q, k, v, g)
    errors = {name: rel_fro(a, b) for name, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
    assert all(np.isfinite(x).all() for x in got)
    assert max(errors.values()) <= ATTN_BOUND[dtype], errors


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_dtensor_wrappers_match_jax(world, impl):
    q, k, v, g = _inputs(1)
    want = _jax_attention(impl, 2, "float32", q, k, v, g)
    results = world.run(tasks.attention_dtensor, impl, {"fsdp": 2, "context": 2}, q, k, v, g)
    for got, placements in results:
        assert placements == ["R", "R", "R", "S(1)"]  # data, fsdp, tensor, context
        errors = [rel_fro(a, b) for a, b in zip(got, want)]
        assert max(errors) <= ATTN_BOUND["float32"], errors


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_causality_holds_across_shards(world, impl):
    P = 4
    q, k, v, g = _inputs(2)
    n = ATTN_SHAPE[1] // P
    g[:, n:] = 0.0
    out, dq, dk, dv = _port_attention(world, impl, P, "float32", q, k, v, g)
    assert np.abs(dk[:, :n]).sum() > 0 and np.abs(dv[:, :n]).sum() > 0
    assert not dk[:, n:].any() and not dv[:, n:].any()
    rng = np.random.default_rng(3)
    k2, v2 = k.copy(), v.copy()
    k2[:, n:] = rng.standard_normal(k2[:, n:].shape)
    v2[:, n:] = rng.standard_normal(v2[:, n:].shape)
    out2 = _port_attention(world, impl, P, "float32", q, k2, v2, g)[0]
    assert np.array_equal(out2[:, :n], out[:, :n])
    assert not np.array_equal(out2[:, n:], out[:, n:])


def test_indivisible_heads_raise_the_jax_error(world):
    x = jnp.zeros((1, 4, 3, 8), jnp.float32)
    with pytest.raises(ValueError) as info:
        make_ulysses_attention(_jmesh({"context": 2}), "context")(x, x, x)
    got = world.run(tasks.indivisible_heads, {"fsdp": 2, "context": 2})
    assert got == [str(info.value)] * 4


# -- the sharded train step ---------------------------------------------------------

_JAX_RUNS = {}


def jax_train_run(shape, impl, dtype="float32", overrides=None):
    """The JAX ``init_train_state(mesh=)`` + jit'd ``make_train_step`` on
    the tiny model (its fields replaced by ``overrides``): start params,
    first-step gradients, losses and end params (cached per case)."""
    key = (tuple(sorted(shape.items())), impl, dtype, tuple(sorted((overrides or {}).items())))
    if key not in _JAX_RUNS:
        jmesh = _jmesh(shape)
        dense = dataclasses.replace(jax_tf.ModelConfig.tiny(), dtype=JDT[dtype], **(overrides or {}))
        jcfg = dataclasses.replace(dense, attention_impl=impl, context_axis="context" if impl != "dense" else None,
                                   mesh=jmesh)
        # the params do not depend on attention_impl: initialised through the
        # dense model (flax's eager init through shard_map takes ~15 s)
        _, state, tx = jax_tf.init_train_state(dense, jax.random.PRNGKey(0), mesh=jmesh)
        model = jax_tf.DecoderLM(jcfg)
        rng = np.random.default_rng(7)
        batches = [rng.integers(0, jcfg.vocab_size, (BATCH, TOKENS)).astype(np.int32) for _ in range(STEPS)]
        start = jax.tree_util.tree_map(np.asarray, state["params"])
        grads = jax.jit(jax.grad(jax_tf.loss_fn), static_argnums=1)(state["params"], model.apply,
                                                                    jnp.asarray(batches[0]))
        step = jax.jit(jax_tf.make_train_step(model, tx))
        losses = []
        for tokens in batches:
            state, metrics = step(state, jnp.asarray(tokens))
            losses.append(float(metrics["loss"]))
        _JAX_RUNS[key] = {
            "start": start, "batches": batches, "losses": losses,
            "grads": params_from_jax(jax.tree_util.tree_map(np.asarray, grads)),
            "end": params_from_jax(jax.tree_util.tree_map(np.asarray, state["params"])),
        }
    return _JAX_RUNS[key]


def train_errors(run, result):
    losses, grads, end = result
    return {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(losses, run["losses"])),
        "grad": max(rel_fro(grads[n], run["grads"][n].numpy()) for n in run["grads"]),
        "param": max(rel_fro(end[n], run["end"][n].numpy()) for n in run["end"]),
    }


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sharded_train_step_matches_jax(world, impl):
    shape = {"fsdp": 2, "context": 2}
    run = jax_train_run(shape, impl)
    results = world.run(tasks.train_step, shape, impl, True, run["start"], run["batches"])
    assert all(r[0] == results[0][0] for r in results)  # every rank holds the global loss
    errors = train_errors(run, results[0])
    assert all(errors[k] <= TRAIN_BOUND[k] for k in errors), errors


# -- specs and placements --------------------------------------------------------------

SPEC_SHAPES = [
    {"data": 2, "fsdp": 4}, {"data": 4, "fsdp": 2}, {"fsdp": 8}, {"data": 2, "fsdp": 2, "tensor": 2},
    {"fsdp": 2, "context": 4}, {"data": 2, "tensor": 2, "context": 2}, {"tensor": 2, "context": 4},
    {"context": 8}, {"data": 2, "context": 4}, {"tensor": 4, "context": 2},
]
SPEC_CASES = [(impl, heads, batch) for impl in ("ring", "ulysses") for heads in (4, 6, 8)
              for batch in (None, 1, 2, 4, 6, 8)]


def _as_placements(spec, axes, transposed=False):
    """A JAX PartitionSpec as one placement string per mesh axis."""
    out = []
    for ax in axes:
        where = [j for j, e in enumerate(spec) if e == ax or (isinstance(e, tuple) and ax in e)]
        out.append(f"S({1 - where[0] if transposed else where[0]})" if where else "R")
    return out


def _stand_in(jmesh):
    return types.SimpleNamespace(mesh_dim_names=tuple(jmesh.axis_names),
                                 shape=tuple(jmesh.shape[a] for a in jmesh.axis_names))


def _jax_specs(shape, cases):
    jmesh = _jmesh(shape)
    out = {}
    for impl, heads, batch in cases:
        jcfg = dataclasses.replace(jax_tf.ModelConfig.tiny(), n_heads=heads, attention_impl=impl,
                                   context_axis="context", mesh=jmesh)
        out[(impl, heads, batch)] = _as_placements(jax_tf.seq_parallel_spec(jcfg, batch_size=batch),
                                                   jmesh.axis_names)
    return out


def _jax_param_specs(shape):
    jmesh = _jmesh(shape)
    cfg = jax_tf.ModelConfig.tiny()
    params = jax_tf.DecoderLM(cfg).init(jax.random.PRNGKey(0), jnp.zeros((2, 16), jnp.int32))["params"]
    shardings = jax_tf.param_shardings(params, jmesh)
    names = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    flat = {"/".join(getattr(k, "key", str(k)) for k in path): s.spec
            for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]}
    out = {}
    for name in names:
        path = _flax_path(name)
        out[name] = _as_placements(flat[path], jmesh.axis_names, transposed=path.endswith("kernel"))
    return out


def _flax_path(name):
    """The flax leaf path of a port parameter name (``models/convert.py``'s
    mapping read backwards)."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layer_{parts[1]}"] + parts[2:]
    leaf = {"weight": "embedding" if parts[0] == "embed" else "kernel"}.get(parts[-1], parts[-1])
    return "/".join(parts[:-1] + [leaf])


@pytest.mark.parametrize("shape", SPEC_SHAPES, ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_specs_match_jax_over_mesh_shapes(shape):
    jmesh = _jmesh(shape)
    stand_in = _stand_in(jmesh)
    want = _jax_specs(shape, SPEC_CASES)
    for impl, heads, batch in SPEC_CASES:
        cfg = dataclasses.replace(tf.ModelConfig.tiny(), n_heads=heads, attention_impl=impl, context_axis="context",
                                  mesh=stand_in)
        got = [str(p) for p in tf.seq_parallel_spec(cfg, batch_size=batch)]
        assert got == want[(impl, heads, batch)], (impl, heads, batch)
    model = tf.DecoderLM(tf.ModelConfig.tiny(), device="cpu")
    got = {n: [str(p) for p in s] for n, s in tf.param_shardings(model, stand_in).items()}
    assert got == _jax_param_specs(shape)


@pytest.mark.parametrize("shape", [{"fsdp": 2, "context": 2}, {"data": 2, "context": 2}, {"context": 4},
                                   {"tensor": 2, "context": 2}],
                         ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_specs_on_a_real_device_mesh(world, shape):
    want = _jax_specs(shape, SPEC_CASES)
    got, params = world.run(tasks.specs, shape, SPEC_CASES)[0]
    assert got == want
    assert params == _jax_param_specs(shape)


@pytest.mark.parametrize("shape", [{"data": 2, "fsdp": 2}, {"fsdp": 4}, {"data": 2, "context": 2}],
                         ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_batch_sharding_equals_the_jax_addressable_shards(world, shape):
    tokens = np.arange(8 * 6, dtype=np.int32).reshape(8, 6)
    jmesh = _jmesh(shape)
    placed = jax.device_put(jnp.asarray(tokens), jax_mesh.batch_sharding(jmesh))
    devices = np.asarray(jmesh.devices)
    by_coord = {}
    for shard in placed.addressable_shards:
        coord = tuple(int(i) for i in np.argwhere(devices == shard.device)[0])
        by_coord[coord] = np.asarray(shard.data)
    results = world.run(tasks.batch_shard, shape, tokens)
    assert sorted(r[0] for r in results) == sorted(by_coord)
    for coord, local, piece, placements, repl in results:
        assert np.array_equal(local, by_coord[coord]) and np.array_equal(piece, by_coord[coord]), coord
        assert placements == ["S(0)" if ax in ("data", "fsdp") else "R" for ax in jmesh.axis_names]
        assert repl == ["R"] * len(jmesh.axis_names)


def _port_error(cfg):
    model = tf.DecoderLM(cfg, device="cpu")
    with pytest.raises(ValueError) as info:
        model(torch.zeros((1, 8), dtype=torch.long))
    return str(info.value)


def _jax_error(cfg):
    with pytest.raises(ValueError) as info:
        jax_tf.DecoderLM(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return str(info.value)


@pytest.mark.parametrize("impl,axis", [("ring", None), ("ulysses", None), ("flash", None), ("ring", "context")])
def test_attend_errors_are_the_jax_ones(impl, axis):
    port = _port_error(dataclasses.replace(tf.ModelConfig.tiny(), attention_impl=impl, context_axis=axis))
    jax_text = _jax_error(dataclasses.replace(jax_tf.ModelConfig.tiny(), attention_impl=impl, context_axis=axis))
    assert port == jax_text


def test_a_tensor_axis_raises_not_implemented(world):
    """A ``tensor`` axis > 1 on a model not built over it (``cfg.mesh``
    unset) raises ``ValueError`` naming the fix, on a real mesh and on a
    stand-in; the name dates from when every tensor axis > 1 was refused
    (:func:`test_mesh_axes_the_decoder_takes_and_refuses` has the axes the
    DecoderLM takes)."""
    texts = world.run(tasks.build_raises, {"tensor": 2, "fsdp": 2})
    assert all(t.startswith("ValueError") and "set ModelConfig.mesh" in t for t in texts), texts
    stand_in = types.SimpleNamespace(mesh_dim_names=("data", "fsdp", "tensor", "context"), shape=(1, 1, 2, 1))
    with pytest.raises(ValueError, match="set ModelConfig.mesh"):
        tf.init_train_state(tf.ModelConfig.tiny(), device="cpu", mesh=stand_in)


def test_mesh_axes_the_decoder_takes_and_refuses(world):
    """A ``tensor`` axis > 1 with ``cfg.mesh`` the same mesh builds (the
    model tensor-parallel); an ``expert`` or ``stage`` axis, which the
    DecoderLM does not implement, raises ``NotImplementedError`` naming
    the modules that take them."""
    assert world.run(tasks.build_raises, {"tensor": 2, "fsdp": 2}, True) == ["no error"] * 4
    for shape in ({"expert": 4}, {"stage": 2, "fsdp": 2}):
        texts = world.run(tasks.build_raises, shape)
        assert all(t.startswith("NotImplementedError") and "models/moe.py" in t and "parallel/pipeline.py" in t
                   for t in texts), texts
