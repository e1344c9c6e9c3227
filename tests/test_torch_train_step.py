"""The port's train step and attention gradient against the JAX package's.

* Attention gradient: the port's ``flash_attention`` (on CPU tensors: the
  plain forward, and the plain backward op that recomputes the reference
  attention) against ``jax.grad`` of the JAX
  ``causal_attention_reference`` on the same numpy-seeded (B, 1024, H, D)
  inputs and output gradient, by ‖port − jax‖_F / ‖jax‖_F per gradient:
  f32 ≤ 1e-5 (sum order only; measured 3.5e-7); bf16 ≤ 1e-3 (both sides
  round scores, probabilities and products to bf16 at the same places,
  but XLA and PyTorch accumulate the bf16 products in another order;
  measured 1.0e-4).
  The backward op is also held to torch autograd through the port's own
  reference, and its FLOP formula to the count the jnp path gives XLA.
* Train step: a 2-layer, 128-wide config at S=1024 (1025 tokens per row),
  the JAX ``init_train_state`` params loaded through ``params_from_jax``,
  3 jit'd JAX ``make_train_step`` steps against 3 port steps on the same
  batches.  f32 compute: the loss at each step within 1e-5 relative,
  every parameter after step 3 within 1e-5 relative Frobenius (measured
  1.1e-6).  bf16 compute: the loss within 5e-4 (measured 4e-5), every
  parameter's update (p3 − p0) within 0.2 relative Frobenius (measured
  0.095: AdamW's first steps move each weight by about ±lr whatever the
  gradient's size, so a gradient near zero that bf16 rounding flips
  flips its update).  Parameters stored in bf16, as the port stored them
  before, fail both bounds (measured 4.3e-3 and 0.63): AdamW's updates
  are below half a bf16 ulp of most weights.
* ``estimate_step_flops`` on the same step against the analytic count
  (matmuls and full S×S attention, within 1%) and against XLA's
  ``cost_analysis`` of the JAX train step, which also counts elementwise
  work: the ratio port / XLA must lie in [0.93, 0.99] (measured 0.974 in
  f32 and 0.968 in bf16; jax 0.9.0 on the CPU).
* Remat (``ModelConfig(remat=True)``, each block checkpointed): the
  port's step against the JAX remat step within the bounds above (the
  JAX step runs attention through its plain reference: inside
  ``jax.checkpoint`` the Pallas kernel's failure under differentiation
  escapes its fallback); the port's remat step against its step without
  remat within 1e-6 in f32; ``FlopCounterMode`` counts the recompute as
  XLA does (the analytic count plus each block's forward but its last
  projection, exactly; port / XLA in [0.93, 0.99], measured 0.972); and
  under ``init(mode="auto")`` a remat step records one forward, with and
  without ``traced_model``, though the recompute calls every block again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")  # a checkout without torch still collects
import torch
from torch.utils.flop_counter import FlopCounterMode

from traceml_tpu.models import transformer as jax_tf
from traceml_tpu.ops.attention import causal_attention_reference as jax_reference
from traceml_tpu_torch.models import transformer as tf
from traceml_tpu_torch.models.convert import params_from_jax
from traceml_tpu_torch.ops.attention import attention_reference
from traceml_tpu_torch.ops.flash_attention import flash_attention

NARROW = dict(vocab_size=256, hidden=128, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=1024)
BATCH, TOKENS, STEPS = 1, 1025, 3
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def rel_fro(a, b) -> float:
    a, b = (torch.from_numpy(np.array(x, np.float32)) for x in (a, b))
    return float((a - b).norm() / b.norm())


def _attention_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("name,bound", [("f32", 1e-5), ("bf16", 1e-3)])
def test_attention_gradient_matches_jax_grad(name, bound):
    jdt, tdt = DTYPES[name]
    q, k, v, g = _attention_inputs((2, 1024, 2, 64))

    def jax_loss(q, k, v):
        out = jax_reference(q, k, v).astype(jnp.float32)
        return jnp.sum(out * jnp.asarray(g, jnp.float32))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves), leaves, torch.from_numpy(g).to(tdt))
    for grad, ref in zip(got, want):
        assert grad.dtype == tdt
        assert rel_fro(grad.float().numpy(), np.asarray(ref, np.float32)) <= bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_op_equals_autograd_through_the_reference(dtype):
    """The written-out gradient is the reference's, step for step: equal
    to autograd through ``attention_reference`` but for sum order."""
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in _attention_inputs((2, 256, 2, 64), seed=1))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves), leaves, g)
    want = torch.autograd.grad(attention_reference(*leaves), leaves, g)
    for a, b in zip(got, want):
        assert rel_fro(a.float().detach().numpy(), b.float().numpy()) <= 1e-5


def test_flop_formula_counts_full_square_products():
    B, S, H, D = 1, 256, 2, 64
    leaves = [torch.randn(B, S, H, D, requires_grad=True) for _ in range(3)]
    with FlopCounterMode(display=False) as counter:
        flash_attention(*leaves).sum().backward()
    assert counter.get_total_flops() == 12 * B * H * S * S * D  # 4 forward + 8 backward


@pytest.fixture(scope="module", params=sorted(DTYPES))
def jax_run(request):
    """The JAX train step's params before and after ``STEPS`` steps, its
    losses, its batches and its lowered step's ``cost_analysis`` FLOPs."""
    jdt, tdt = DTYPES[request.param]
    jcfg = jax_tf.ModelConfig(dtype=jdt, **NARROW)
    model, state, tx = jax_tf.init_train_state(jcfg, jax.random.PRNGKey(0))
    train_step = jax.jit(jax_tf.make_train_step(model, tx))
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, NARROW["vocab_size"], (BATCH, TOKENS)).astype(np.int32) for _ in range(STEPS)]
    start = jax.tree_util.tree_map(np.asarray, state["params"])
    xla_flops = train_step.lower(state, jnp.asarray(batches[0])).cost_analysis()["flops"]
    losses = []
    for tokens in batches:
        state, metrics = train_step(state, jnp.asarray(tokens))
        losses.append(float(metrics["loss"]))
    end = params_from_jax(jax.tree_util.tree_map(np.asarray, state["params"]))
    return {"name": request.param, "dtype": tdt, "start": start, "end": end, "losses": losses,
            "batches": batches, "xla_flops": float(xla_flops)}


def _port_run(run, param_dtype):
    cfg = tf.ModelConfig(dtype=run["dtype"], param_dtype=param_dtype, **NARROW)
    model, optimizer = tf.init_train_state(cfg, device="cpu")
    model.load_state_dict(params_from_jax(run["start"]))
    start = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    step = tf.make_train_step(model, optimizer)
    losses = [float(step(torch.from_numpy(t).long())["loss"]) for t in run["batches"]]
    end = {n: p.detach().float() for n, p in model.named_parameters()}
    return losses, start, end


def _errors(run, losses, start, end):
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, run["losses"]))
    param_rel = max(rel_fro(end[n].numpy(), run["end"][n].numpy()) for n in run["end"])
    update_rel = max(rel_fro((end[n] - start[n]).numpy(), (run["end"][n] - start[n]).numpy())
                     for n in run["end"])
    return loss_rel, param_rel, update_rel


BOUNDS = {"f32": {"loss": 1e-5, "param": 1e-5}, "bf16": {"loss": 5e-4, "update": 0.2}}


def _within(name, errors) -> bool:
    loss_rel, param_rel, update_rel = errors
    b = BOUNDS[name]
    return loss_rel <= b["loss"] and param_rel <= b.get("param", np.inf) and update_rel <= b.get("update", np.inf)


def test_train_step_matches_jax(jax_run):
    losses, start, end = _port_run(jax_run, torch.float32)
    assert all(np.isfinite(losses)) and losses[-1] != losses[0]
    errors = _errors(jax_run, losses, start, end)
    assert _within(jax_run["name"], errors), errors


def test_bf16_parameter_storage_fails_the_bound(jax_run):
    """The fault f32 storage repairs: weights kept in bf16 lose AdamW's
    updates and leave the bound the f32 parameters meet."""
    losses, start, end = _port_run(jax_run, torch.bfloat16)
    errors = _errors(jax_run, losses, start, end)
    assert not _within(jax_run["name"], errors), errors


def test_params_from_jax_loads_f32_parameters_unchanged(jax_run):
    model, _ = tf.init_train_state(tf.ModelConfig(**NARROW), device="cpu")
    model.load_state_dict(params_from_jax(jax_run["start"]))
    expected = params_from_jax(jax_run["start"])
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert torch.equal(p.detach(), expected[name]), name


def test_adamw_state_is_made_eagerly():
    model, optimizer = tf.init_train_state(tf.ModelConfig.tiny(), device="cpu")
    for p in model.parameters():
        state = optimizer.state[p]
        assert float(state["step"]) == 0.0
        assert state["exp_avg"].shape == p.shape and not state["exp_avg"].any()
        assert state["exp_avg_sq"].shape == p.shape and not state["exp_avg_sq"].any()
    assert optimizer.defaults["weight_decay"] == 0.01 and optimizer.defaults["lr"] == 3e-4


def analytic_flops(cfg: dict, batch: int, seq: int) -> float:
    hd = cfg["hidden"] // cfg["n_heads"]
    ffn = tf.ModelConfig(**cfg).ffn_hidden
    per_layer = 2 * cfg["hidden"] * cfg["n_heads"] * hd + 2 * cfg["hidden"] * cfg["n_kv_heads"] * hd
    per_layer += 3 * cfg["hidden"] * ffn
    params = cfg["n_layers"] * per_layer + cfg["hidden"] * cfg["vocab_size"]
    return 6.0 * params * batch * seq + 12 * batch * cfg["n_heads"] * seq * seq * hd * cfg["n_layers"]


def test_estimate_step_flops_against_analytic_and_xla(jax_run):
    from traceml_tpu_torch.sdk.flops import estimate_step_flops
    from traceml_tpu_torch.sdk.state import get_state, reset_state_for_tests

    reset_state_for_tests(device="cpu")
    model, optimizer = tf.init_train_state(tf.ModelConfig(dtype=jax_run["dtype"], **NARROW), device="cpu")
    step = tf.make_train_step(model, optimizer)
    flops = estimate_step_flops(step, torch.from_numpy(jax_run["batches"][0]).long())
    st = get_state()
    assert (st.flops_per_step, st.flops_source) == (flops, "flop_counter")
    assert (st.flops_device_kind, st.flops_device_count) == ("cpu", 1)
    analytic = analytic_flops(NARROW, BATCH, TOKENS - 1)
    assert abs(flops - analytic) / analytic <= 0.01
    assert 0.93 <= flops / jax_run["xla_flops"] <= 0.99
    reset_state_for_tests()


# -- remat: each block checkpointed ---------------------------------------


@pytest.fixture(scope="module", params=sorted(DTYPES))
def jax_remat_run(request):
    """The JAX ``ModelConfig(remat=True)`` train step, as ``jax_run``.  Inside
    ``jax.checkpoint`` the Pallas kernel's failure under differentiation
    is raised at lowering, past ``causal_attention``'s fallback, so the
    step runs attention through its plain reference
    (``_PALLAS_MIN_SEQ`` raised for the fixture): the path the non-remat
    JAX step falls back to."""
    from traceml_tpu.ops import attention as jax_attention

    jdt, tdt = DTYPES[request.param]
    saved = jax_attention._PALLAS_MIN_SEQ
    jax_attention._PALLAS_MIN_SEQ = 1 << 30
    try:
        jcfg = jax_tf.ModelConfig(dtype=jdt, remat=True, **NARROW)
        model, state, tx = jax_tf.init_train_state(jcfg, jax.random.PRNGKey(0))
        train_step = jax.jit(jax_tf.make_train_step(model, tx))
        rng = np.random.default_rng(1)
        batches = [rng.integers(0, NARROW["vocab_size"], (BATCH, TOKENS)).astype(np.int32)
                   for _ in range(STEPS)]
        start = jax.tree_util.tree_map(np.asarray, state["params"])
        xla_flops = train_step.lower(state, jnp.asarray(batches[0])).cost_analysis()["flops"]
        losses = []
        for tokens in batches:
            state, metrics = train_step(state, jnp.asarray(tokens))
            losses.append(float(metrics["loss"]))
    finally:
        jax_attention._PALLAS_MIN_SEQ = saved
    end = params_from_jax(jax.tree_util.tree_map(np.asarray, state["params"]))
    return {"name": request.param, "dtype": tdt, "start": start, "end": end, "losses": losses,
            "batches": batches, "xla_flops": float(xla_flops)}


def _port_remat_run(run, remat=True):
    cfg = tf.ModelConfig(dtype=run["dtype"], remat=remat, **NARROW)
    model, optimizer = tf.init_train_state(cfg, device="cpu")
    model.load_state_dict(params_from_jax(run["start"]))
    start = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    step = tf.make_train_step(model, optimizer)
    losses = [float(step(torch.from_numpy(t).long())["loss"]) for t in run["batches"]]
    end = {n: p.detach().float() for n, p in model.named_parameters()}
    return losses, start, end


def test_remat_train_step_matches_jax_remat(jax_remat_run):
    """The port's remat step against the JAX remat step, within the
    non-remat test's bounds (the flax params of ``nn.remat(Block)`` load
    through ``params_from_jax`` unchanged)."""
    losses, start, end = _port_remat_run(jax_remat_run)
    assert all(np.isfinite(losses)) and losses[-1] != losses[0]
    errors = _errors(jax_remat_run, losses, start, end)
    assert _within(jax_remat_run["name"], errors), errors


def test_remat_equals_no_remat_in_f32():
    """Checkpointing recomputes the same forward: in f32 the port's remat
    step and its step without remat, from the same weights on the same
    batches, agree within 1e-6 (loss relative, every parameter after 3
    steps by relative Frobenius)."""
    rng = np.random.default_rng(3)
    batches = [torch.from_numpy(rng.integers(0, NARROW["vocab_size"], (BATCH, TOKENS))).long()
               for _ in range(STEPS)]
    got = {}
    for remat in (True, False):
        model, optimizer = tf.init_train_state(tf.ModelConfig(dtype=torch.float32, remat=remat, **NARROW),
                                               device="cpu", seed=0)
        step = tf.make_train_step(model, optimizer)
        losses = [float(step(t)["loss"]) for t in batches]
        got[remat] = losses, {n: p.detach().clone() for n, p in model.named_parameters()}
    (losses, end), (ref_losses, ref_end) = got[True], got[False]
    assert max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)) <= 1e-6
    assert max(rel_fro(end[n].numpy(), ref_end[n].numpy()) for n in ref_end) <= 1e-6


def analytic_remat_flops(cfg: dict, batch: int, seq: int) -> float:
    """The step's count plus each block's forward again, but for its last
    projection (``w_down``): its output is not saved for the backward, so
    ``torch.utils.checkpoint`` stops the recompute before it."""
    hd = cfg["hidden"] // cfg["n_heads"]
    ffn = tf.ModelConfig(**cfg).ffn_hidden
    per_layer = 2 * cfg["hidden"] * cfg["n_heads"] * hd + 2 * cfg["hidden"] * cfg["n_kv_heads"] * hd
    per_layer += 2 * cfg["hidden"] * ffn  # w_gate, w_up; not w_down
    attention = 4 * batch * cfg["n_heads"] * seq * seq * hd
    return analytic_flops(cfg, batch, seq) + (2.0 * per_layer * batch * seq + attention) * cfg["n_layers"]


def test_remat_flops_against_analytic_and_xla(jax_remat_run):
    """``FlopCounterMode`` counts the recompute, as XLA's cost analysis of
    the lowered remat program does: the port's count is the analytic
    remat count exactly (matmuls and attention are all it counts), and
    the ratio port / XLA lies in the non-remat test's [0.93, 0.99]
    (measured 0.972 in f32)."""
    from traceml_tpu_torch.sdk.flops import estimate_step_flops
    from traceml_tpu_torch.sdk.state import reset_state_for_tests

    reset_state_for_tests(device="cpu")
    try:
        cfg = tf.ModelConfig(dtype=jax_remat_run["dtype"], remat=True, **NARROW)
        model, optimizer = tf.init_train_state(cfg, device="cpu")
        step = tf.make_train_step(model, optimizer)
        flops = estimate_step_flops(step, torch.from_numpy(jax_remat_run["batches"][0]).long())
    finally:
        reset_state_for_tests()
    assert flops == analytic_remat_flops(NARROW, BATCH, TOKENS - 1)
    assert 0.93 <= flops / jax_remat_run["xla_flops"] <= 0.99


@pytest.mark.parametrize("traced_model", [False, True])
def test_recomputed_blocks_record_no_forward(traced_model):
    """Under ``init(mode="auto")`` a remat train step records one forward:
    the blocks that ``torch.utils.checkpoint`` calls again inside the timed
    ``backward()`` are not forwards, with ``traced_model`` (a block is no
    target) and without it (a recomputed block is an outermost call)."""
    from collections import Counter

    from traceml_tpu_torch.sdk.initial import init
    from traceml_tpu_torch.sdk.instrumentation import trace_step
    from traceml_tpu_torch.sdk.state import reset_state_for_tests
    from traceml_tpu_torch.utils import timing as T

    st = reset_state_for_tests(device="cpu")
    try:
        cfg = tf.ModelConfig(**dict(NARROW, max_seq_len=128), remat=True)
        model, optimizer = tf.init_train_state(cfg, device="cpu")
        init(mode="auto", device="cpu", traced_model=model if traced_model else None)
        step = tf.make_train_step(model, optimizer)
        tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 65))).long()
        T.GLOBAL_STEP_QUEUE.drain()
        for _ in range(2):
            with trace_step(st):
                step(tokens)
        per_step = [Counter(e.name for e in batch.events) for batch in T.GLOBAL_STEP_QUEUE.drain()]
    finally:
        reset_state_for_tests()
    assert [c[T.FORWARD_TIME] for c in per_step] == [1, 1]
    assert [c[T.BACKWARD_TIME] for c in per_step] == [1, 1]
