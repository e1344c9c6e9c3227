"""The slice end to end on the CPU, beside the JAX SDK loop.

The tiny DecoderLM's traced forward loop (``init`` → runtime →
``wrap_dataloader`` → ``trace_step`` + ``wrap_step_fn``) with an injected
host input delay must give INPUT_BOUND, as the JAX SDK loop with the same
delay does.  And an entry point given no device on a machine without CUDA
raises instead of running on the CPU.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

STEPS = 60  # the summary policy needs 50 aligned steps
DELAY_S = 0.05  # well above the tiny forward (~2 ms on one CPU thread)
BATCH, SEQ = 2, 16


def _host_batches(vocab, delay_s, to_tensor):
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32) for _ in range(4)]
    for i in range(STEPS):
        time.sleep(delay_s)
        yield to_tensor(batches[i % len(batches)])


def _jax_rows(delay_s):
    from traceml_tpu.instrumentation.dataloader import wrap_dataloader
    from traceml_tpu.models.transformer import DecoderLM, ModelConfig
    from traceml_tpu.samplers.step_time_sampler import TABLE, StepTimeSampler
    from traceml_tpu.sdk.instrumentation import trace_step
    from traceml_tpu.sdk.state import reset_state_for_tests
    from traceml_tpu.sdk.step_fn import wrap_step_fn
    from traceml_tpu.utils.timing import GLOBAL_STEP_QUEUE

    cfg = ModelConfig.tiny()
    model = DecoderLM(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    GLOBAL_STEP_QUEUE.drain()
    st = reset_state_for_tests()
    step = wrap_step_fn(lambda p, t: model.apply({"params": p}, t), estimate_flops=False)
    for tokens in wrap_dataloader(_host_batches(cfg.vocab_size, delay_s, jnp.asarray),
                                  to_device=True, state=st):
        with trace_step(st):
            step(params, tokens)
    sampler = StepTimeSampler()
    sampler.drain()
    return sampler.db.tail(TABLE)


def _port_rows(delay_s):
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.models.transformer import DecoderLM, ModelConfig
    from traceml_tpu_torch.runtime.lifecycle import get_active_runtime
    from traceml_tpu_torch.runtime.runtime import RuntimeSettings
    from traceml_tpu_torch.sdk.state import reset_state_for_tests

    cfg = ModelConfig.tiny()
    torch.manual_seed(0)
    model = DecoderLM(cfg, device="cpu").eval()
    reset_state_for_tests()
    tm.init(mode="auto", device="cpu")
    tm.start_runtime(RuntimeSettings(sampler_interval_sec=0.05))
    rt = get_active_runtime()
    try:
        def forward(tokens):
            with torch.inference_mode():
                return model(tokens)

        step = tm.wrap_step_fn(forward)
        loader = tm.wrap_dataloader(
            _host_batches(cfg.vocab_size, delay_s, lambda a: torch.from_numpy(a).long()),
            to_device=True,
        )
        for tokens in loader:
            with tm.trace_step():
                logits = step(tokens)
        assert logits.shape == (BATCH, SEQ, cfg.vocab_size)
        live = tm.live_metrics()
    finally:
        tm.stop_runtime()
    assert get_active_runtime() is None
    assert live["traceml/live/step"] == STEPS
    return rt.sampler("step_time").db.tail("step_time")


def test_injected_input_delay_is_input_bound_in_both_packages():
    from traceml_tpu.diagnostics.step_time.api import diagnose_rank_rows as jax_diagnose
    from traceml_tpu_torch.diagnostics.step_time.api import diagnose_rank_rows

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # keep the tiny forward small beside the delay
    try:
        rows = _port_rows(DELAY_S)
    finally:
        torch.set_num_threads(threads)
    assert len(rows) == STEPS
    assert {r["clock"] for r in rows} == {"host"}
    ours = diagnose_rank_rows({0: rows}).diagnosis
    theirs = jax_diagnose({0: _jax_rows(DELAY_S)}).diagnosis
    assert (ours.kind, theirs.kind) == ("INPUT_BOUND", "INPUT_BOUND")
    assert ours.severity == theirs.severity == "critical"


def _entry_points():
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.models.transformer import DecoderLM, ModelConfig

    return {
        "init": lambda: tm.init(),
        "wrap_step_fn": lambda: tm.wrap_step_fn(lambda: None),
        "wrap_dataloader": lambda: tm.wrap_dataloader([], to_device=True),
        "wrap_h2d": lambda: tm.wrap_h2d(torch.zeros(2)),
        "trace_step": lambda: tm.trace_step().__enter__(),
        "DecoderLM": lambda: DecoderLM(ModelConfig.tiny()),
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_entry_point_without_cuda_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from traceml_tpu_torch.sdk.state import get_state, reset_state_for_tests
    from traceml_tpu_torch.utils.device import DeviceUnavailableError

    reset_state_for_tests()
    with pytest.raises(DeviceUnavailableError):
        _entry_points()[entry]()
    assert get_state().current_step == 0 and not get_state().tls.in_step
