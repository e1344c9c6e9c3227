"""Step-time rows: the port against the JAX package.

The same synthetic timelines (numpy-made host spans and readiness edges)
go through both packages' ``_aggregate_step`` and must give equal rows.
Then the port's ``trace_step`` / ``wrap_step_fn`` / ``wrap_dataloader``
run on the CPU beside the JAX SDK loop, and the rows must share the JAX
schema, with ``clock: "host"`` on the port's side (no CUDA markers).
``wrap_step_fn``'s FLOPs: the same decisions as the JAX wrapper's
cost-analysis estimate (first in-step call only, a manual value wins, an
out-of-step call publishes nothing), the flash op counted under
``torch.inference_mode()``, the switch that turns it off, and the
counter's one-off set-up paid when the wrapper is built, not in a step.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
pytest.importorskip("torch")  # a checkout without torch still collects
import torch

from traceml_tpu.samplers import step_time_sampler as jax_sampler
from traceml_tpu.utils import timing as jax_timing
from traceml_tpu_torch.samplers import step_time_sampler as torch_sampler
from traceml_tpu_torch.utils import timing as torch_timing

PHASES = ("DATALOADER_NEXT", "H2D_TIME", "COMPUTE_TIME", "FORWARD_TIME", "COLLECTIVE_TIME")


class _Ready:
    def is_ready(self):
        return True


def _timeline(rng, n_steps):
    """Per step: [(phase, cpu_start, cpu_end, ready_at | None, late)]; the
    envelope first, phases in host order, sometimes shuffled."""
    t = 0.0
    steps = []
    for _ in range(n_steps):
        start = t
        events = []
        cursor = start
        for name in rng.choice(PHASES, size=rng.integers(1, 5), replace=True):
            s = cursor + rng.uniform(0.0, 2e-3)
            e = s + rng.uniform(1e-4, 5e-3)
            ready = None if rng.random() < 0.3 else e + rng.uniform(0.0, 2e-2)
            late = bool(ready is not None and rng.random() < 0.1)
            events.append((str(name), s, e, ready, late))
            cursor = e
        t = cursor + rng.uniform(0.0, 1e-3)
        env_ready = None if rng.random() < 0.3 else t + rng.uniform(0.0, 2e-2)
        env = ("STEP_TIME", start, t, env_ready, False)
        if rng.random() < 0.2:
            rng.shuffle(events)
        steps.append([env] + events)
    return steps


def _events(mod, spec, step):
    out = []
    for name, s, e, ready, late in spec:
        ev = mod.TimeEvent(getattr(mod, name), step)
        ev.cpu_start, ev.cpu_end = s, e
        if ready is not None:
            ev.marker = mod.DeviceMarker([_Ready()], dispatched_at=s)
            ev.marker.ready_at = ready
            ev.marker.late_stamp = late
        out.append(ev)
    return out


@pytest.mark.parametrize("seed", range(12))
def test_aggregate_step_rows_equal_jax(seed):
    steps = _timeline(np.random.default_rng(seed), 8)
    jax_last = torch_last = None
    for i, spec in enumerate(steps):
        jrow, jax_last = jax_sampler._aggregate_step(_events(jax_timing, spec, i), jax_last)
        trow, torch_last = torch_sampler._aggregate_step(_events(torch_timing, spec, i), torch_last)
        assert trow == jrow
        assert torch_last == jax_last


def test_phase_vocabulary_is_jax_s():
    assert torch_timing.ALL_PHASES == jax_timing.ALL_PHASES


def test_cuda_marker_stamps_device_time_not_observation_time():
    """A handle with a device timestamp stamps ``ready_at`` with it, even
    when a late poller observes it; a plain handle stamps observation time."""

    class _Stamped(_Ready):
        def ready_time(self):
            return 123.25

    marker = torch_timing.DeviceMarker([_Stamped()], dispatched_at=1.0)
    assert marker.poll(now=500.0, late=True)
    assert marker.ready_at == 123.25 and not marker.late_stamp
    plain = torch_timing.DeviceMarker([_Ready()], dispatched_at=1.0)
    assert plain.poll(now=500.0, late=True)
    assert plain.ready_at == 500.0 and plain.late_stamp


def _event_schema(rows):
    return {name: set(ev) for row in rows for name, ev in row["events"].items()}


def test_sdk_rows_have_the_jax_schema_with_host_clock():
    import jax
    import jax.numpy as jnp

    import traceml_tpu.sdk.state as jax_state
    from traceml_tpu.instrumentation.dataloader import wrap_dataloader as jax_wrap_dataloader
    from traceml_tpu.sdk.instrumentation import trace_step as jax_trace_step
    from traceml_tpu.sdk.step_fn import wrap_step_fn as jax_wrap_step_fn

    import traceml_tpu_torch.sdk.state as torch_state
    from traceml_tpu_torch.instrumentation.dataloader import wrap_dataloader
    from traceml_tpu_torch.sdk.instrumentation import trace_step
    from traceml_tpu_torch.sdk.step_fn import wrap_step_fn

    batches = [np.full((2, 4), i, np.float32) for i in range(4)]

    jax_timing.GLOBAL_STEP_QUEUE.drain()
    jst = jax_state.reset_state_for_tests()
    jstep = jax_wrap_step_fn(lambda x: (x * 2.0).sum(), estimate_flops=False)
    for batch in jax_wrap_dataloader(batches, to_device=True, state=jst):
        with jax_trace_step(jst):
            jstep(batch)
    jax.block_until_ready(jnp.zeros(()))
    jsampler = jax_sampler.StepTimeSampler()
    jsampler.drain()
    jrows = jsampler.db.tail(jax_sampler.TABLE)

    tst = torch_state.reset_state_for_tests(device="cpu")
    tstep = wrap_step_fn(lambda x: (x * 2.0).sum(), state=tst)
    for batch in wrap_dataloader([torch.from_numpy(b) for b in batches], to_device=True, state=tst):
        with trace_step(tst):
            tstep(batch)
    tsampler = torch_sampler.StepTimeSampler()
    tsampler.drain()
    trows = tsampler.db.tail(torch_sampler.TABLE)

    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == [1, 2, 3, 4]
    assert all(set(t) == set(j) for t, j in zip(trows, jrows))
    # the JAX loop also carries compile_time events from its compile
    # tracker; every event the port emits has the JAX event's keys
    tschema, jschema = _event_schema(trows), _event_schema(jrows)
    assert set(tschema) <= set(jschema)
    assert all(tschema[name] == jschema[name] for name in tschema)
    assert set(tschema) == {
        torch_timing.STEP_TIME, torch_timing.DATALOADER_NEXT,
        torch_timing.H2D_TIME, torch_timing.COMPUTE_TIME,
    }
    assert {r["clock"] for r in trows} == {"host"}
    for row in trows:
        assert all(ev["device_ms"] is None and ev["cpu_ms"] >= 0 for ev in row["events"].values())
        assert row["events"][torch_timing.COMPUTE_TIME]["count"] == 1


@pytest.mark.parametrize("seed", range(4))
def test_overhead_governor_decisions_equal_jax(seed):
    from traceml_tpu.utils.overhead_governor import OverheadGovernor as JaxGovernor
    from traceml_tpu_torch.utils.overhead_governor import OverheadGovernor

    rng = np.random.default_rng(seed)
    ours, theirs = OverheadGovernor(budget=0.01), JaxGovernor(budget=0.01)
    for _ in range(200):
        probe = float(rng.choice([2e-6, 3e-4, 5e-2]))
        step = float(rng.choice([1e-3, 1.2e-2, 0.2]))
        for gov in (ours, theirs):
            gov.observe_probe(probe, 1)
            gov.observe_step(step)
            gov.observe_marker_lifetime(step * 0.9)
        assert ours.begin_step() == theirs.begin_step()
        assert ours.marker_stride == theirs.marker_stride
        assert ours.allow_inline_sweep() == theirs.allow_inline_sweep()
        assert ours.resolver_min_delay() == theirs.resolver_min_delay()


def test_marker_resolver_stamps_pending_markers_and_stops():
    import time

    from traceml_tpu_torch.utils.marker_resolver import MarkerResolver

    class _Later:
        def __init__(self, at):
            self.at = at

        def is_ready(self):
            return time.perf_counter() >= self.at

        def ready_time(self):
            return self.at

    resolver = MarkerResolver()
    at = time.perf_counter() + 0.02
    marker = torch_timing.DeviceMarker([_Later(at)])
    resolver.submit(marker)
    deadline = time.monotonic() + 5.0
    while not marker.resolved and time.monotonic() < deadline:
        time.sleep(0.005)
    thread = resolver._thread
    resolver.stop()
    assert marker.ready_at == at and not marker.late_stamp
    assert thread is not None and not thread.is_alive()


@pytest.mark.parametrize("slow_every", [50, 1])
def test_probe_cost_is_a_windowed_minimum(slow_every):
    """Poll batches of one marker each, as in a loop with one marker
    pending: a rare 5 ms poll among 30 µs ones (a poller that lost the
    GIL) leaves a 20 ms step fully sampled; a runtime whose every poll
    takes 5 ms backs the stride off."""
    from traceml_tpu_torch.utils import marker_resolver
    from traceml_tpu_torch.utils.overhead_governor import get_governor, reset_governor_for_tests

    clock = [0.0]
    polls = [0]

    class _Probe:
        def is_ready(self):
            polls[0] += 1
            clock[0] += 5e-3 if polls[0] % slow_every == 0 else 30e-6
            return False

    reset_governor_for_tests(budget=0.01)
    try:
        gov = get_governor()
        marker = torch_timing.DeviceMarker([_Probe()])
        with mock.patch.object(marker_resolver.time, "perf_counter", lambda: clock[0]):
            strides = []
            for i in range(400):
                marker_resolver._poll_batch([marker])
                if i % 5 == 4:  # five poll batches a step
                    gov.observe_step(0.02)
                    strides.append(gov.marker_stride)
        if slow_every > 1:
            assert max(strides) == 1 and gov.probe_cost_ema < 50e-6
        else:
            assert strides[-1] > 1 and gov.probe_cost_ema > 1e-3
    finally:
        reset_governor_for_tests()


# -- wrap_step_fn's FLOPs, against the JAX wrapper's cost-analysis estimate --


def _flops_decisions(pkg):
    """After each call of the sequence (out of a step, in a step, in a
    step), whether FLOPs are declared and by what source; then the same
    with a manual value declared first.  ``pkg`` is "jax" or "port"."""
    if pkg == "jax":
        import jax.numpy as jnp

        import traceml_tpu.sdk.state as state
        from traceml_tpu.api import set_step_flops
        from traceml_tpu.sdk.instrumentation import trace_step
        from traceml_tpu.sdk.step_fn import wrap_step_fn

        def make():
            return wrap_step_fn(lambda x: x @ x)

        def reset():
            return state.reset_state_for_tests()

        x = jnp.ones((8, 8))
    else:
        import traceml_tpu_torch.sdk.state as state
        from traceml_tpu_torch.sdk.flops import set_step_flops
        from traceml_tpu_torch.sdk.instrumentation import trace_step
        from traceml_tpu_torch.sdk.step_fn import wrap_step_fn

        def make():
            return wrap_step_fn(lambda x: x @ x)

        def reset():
            return state.reset_state_for_tests(device="cpu")

        x = torch.ones(8, 8)
    out = []
    for manual in (False, True):
        st = reset()
        if manual:
            set_step_flops(5.0e9, device_kind="cpu", device_count=1)
        step = make()
        seen = []
        step(x)  # an eval call, out of a step
        seen.append((st.flops_per_step, st.flops_source))
        for _ in range(2):
            with trace_step(st):
                step(x)
            seen.append((st.flops_per_step, st.flops_source))
        out.append(seen)
    reset()
    return out


def test_wrap_step_fn_declares_flops_as_the_jax_wrapper():
    """Both wrappers: an out-of-step call publishes nothing; the first
    in-step call declares the count once (the JAX one by XLA's cost
    analysis, the port by ``FlopCounterMode`` on that call); a manual
    value declared before wins."""
    sources = {"cost_analysis": "counted", "flop_counter": "counted", "manual": "manual", None: None}

    def normalize(runs):
        return [[(flops is not None, sources[src]) for flops, src in seen] for seen in runs]

    theirs, ours = _flops_decisions("jax"), _flops_decisions("port")
    assert normalize(ours) == normalize(theirs) == [
        [(False, None), (True, "counted"), (True, "counted")],
        [(True, "manual")] * 3,
    ]
    assert ours[0][1][0] == 2 * 8 ** 3  # one 8x8 matmul
    assert [f for f, _ in ours[1]] == [5.0e9] * 3


def test_wrap_step_fn_counts_the_flash_op_under_inference_mode():
    """The forward of ``forward_script.py`` runs under
    ``torch.inference_mode()``; at S=1024 its attention is the flash custom
    op (the plain version on CPU tensors), whose FLOP formula must still
    count: 2 x the matmul parameters x the tokens plus 4·B·H·S²·D a layer."""
    import traceml_tpu_torch.sdk.state as state
    from traceml_tpu_torch.models.transformer import DecoderLM, ModelConfig
    from traceml_tpu_torch.sdk.instrumentation import trace_step
    from traceml_tpu_torch.sdk.step_fn import wrap_step_fn

    cfg = ModelConfig(vocab_size=256, hidden=128, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=1024,
                      dtype=torch.float32)
    st = state.reset_state_for_tests(device="cpu")
    try:
        model = DecoderLM(cfg, device="cpu")

        def forward(tokens):
            with torch.inference_mode():
                return model(tokens)

        step = wrap_step_fn(forward)
        tokens = torch.zeros(1, 1024, dtype=torch.long)
        with trace_step(st):
            step(tokens)
        flops, source = st.flops_per_step, st.flops_source
    finally:
        state.reset_state_for_tests()
    hd = cfg.head_dim
    per_layer = 2 * cfg.hidden * cfg.n_heads * hd + 2 * cfg.hidden * cfg.n_kv_heads * hd + 3 * cfg.hidden * cfg.ffn_hidden
    matmul = cfg.n_layers * per_layer + cfg.hidden * cfg.vocab_size
    assert source == "flop_counter"
    assert flops == 2 * matmul * 1024 + 4 * cfg.n_heads * 1024 * 1024 * hd * cfg.n_layers


def test_wrap_step_fn_estimate_can_be_turned_off():
    import traceml_tpu_torch.sdk.state as state
    from traceml_tpu_torch.sdk.instrumentation import trace_step
    from traceml_tpu_torch.sdk.step_fn import wrap_step_fn

    st = state.reset_state_for_tests(device="cpu")
    try:
        step = wrap_step_fn(lambda x: x @ x, estimate_flops=False)
        with trace_step(st):
            step(torch.ones(4, 4))
        assert st.flops_per_step is None
    finally:
        state.reset_state_for_tests()


def test_wrap_step_fn_pays_the_counter_set_up_outside_the_step():
    """``FlopCounterMode``'s first op imports DTensor, dynamo and sympy
    (seconds): built in a fresh process, ``wrap_step_fn`` pays that before
    any step, so the counted step imports nothing and stays short."""
    code = textwrap.dedent("""
        import sys, torch
        import traceml_tpu_torch.sdk.state as state
        from traceml_tpu_torch.sdk.instrumentation import trace_step
        from traceml_tpu_torch.sdk.step_fn import wrap_step_fn

        st = state.reset_state_for_tests(device="cpu")
        x = torch.ones(8, 8)
        with trace_step(st):  # the trace's own first-use imports
            wrap_step_fn(lambda a: a @ a, estimate_flops=False)(x)
        step = wrap_step_fn(lambda a: a @ a)
        before = set(sys.modules)
        with trace_step(st):
            step(x)
        print(st.flops_source, st.flops_per_step, sorted(set(sys.modules) - before))
    """)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120, cwd=str(root))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["flop_counter", "1024.0", "[]"]
