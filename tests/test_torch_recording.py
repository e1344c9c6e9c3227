"""The port's recording lifecycle (``--trace-max-steps``) against the JAX
package's.

* ``RecordingState``: the JAX cases (RECORDING → DRAINING at the cap →
  COMPLETE when drained; no cap records forever), on both classes.
* The runtime, each package's against a bare ``TCPServer``: the same
  ``trace_step`` sequence (10 steps, a cap of 3, one manual tick after
  every step, then ``stop()``) goes through the JAX ``TraceMLRuntime``
  and the port's, each with a scripted memory backend and no memory
  throttle.  Both ship the same (sampler, step) sets, ``rank_finished``
  exactly once, steps 1-3 of step_time and step_memory before it and
  steps 4-10 after it, in the final drain: the reference keeps tracing
  past the cap (``sdk/state.py`` never reads the recording state) and its
  final drain ships every step flushed since, which the port copies.
  Both ship system and process rows live and in the final drain, and
  none while the rank is quiet.  Exact comparison (sets of integers).
"""

import time

import pytest

from traceml_tpu.runtime import state as jax_rstate
from traceml_tpu_torch.runtime import state as port_rstate
from traceml_tpu_torch.telemetry.control import control_kind
from traceml_tpu_torch.telemetry.envelope import normalize_telemetry_envelope

CAP, STEPS = 3, 10
MEM = [[{"device_id": 0, "device_kind": "fake", "current_bytes": 50, "peak_bytes": 60, "limit_bytes": 100}]]


@pytest.mark.parametrize("mod", [jax_rstate, port_rstate], ids=["jax", "port"])
def test_recording_state_lifecycle(mod):
    rs = mod.RecordingState(max_steps=3)
    assert rs.phase == mod.RECORDING
    rs.on_step_flushed(1)
    rs.on_step_flushed(2)
    assert rs.recording
    rs.mark_drained()  # not draining yet: no effect
    assert rs.phase == mod.RECORDING
    rs.on_step_flushed(3)
    assert rs.phase == mod.DRAINING and not rs.recording
    rs.on_step_flushed(4)
    assert rs.phase == mod.DRAINING
    rs.mark_drained()
    assert rs.phase == mod.COMPLETE


@pytest.mark.parametrize("mod", [jax_rstate, port_rstate], ids=["jax", "port"])
def test_recording_state_unbounded(mod):
    rs = mod.RecordingState(None)
    rs.on_step_flushed(10000)
    assert rs.recording
    rs.mark_drained()  # never draining: no effect
    assert rs.phase == mod.RECORDING


def _drive(rt, trace_step, server):
    """Steps with a tick after each, then stop; every payload the server
    got, in arrival order."""
    rt.start()
    try:
        for _ in range(STEPS):
            with trace_step():
                time.sleep(0.002)
            time.sleep(0.02)  # let the step's markers resolve before the tick
            rt._tick()
    finally:
        rt.stop()
    got = []
    deadline, quiet_since = time.monotonic() + 5, time.monotonic()
    while time.monotonic() < deadline and time.monotonic() - quiet_since < 0.5:
        server.wait_for_data(0.05)
        new = server.decode_tagged(server.drain_tagged())
        if new:
            got.extend(new)
            quiet_since = time.monotonic()
    server.stop()
    return got


def _run_jax(tmp_path):
    from traceml_tpu.runtime.identity import RuntimeIdentity
    from traceml_tpu.runtime.runtime import TraceMLRuntime
    from traceml_tpu.runtime.settings import AggregatorEndpoint, TraceMLSettings
    from traceml_tpu.sdk import state
    from traceml_tpu.sdk.instrumentation import trace_step
    from traceml_tpu.transport import TCPServer
    from traceml_tpu.utils.step_memory import FakeMemoryBackend, StepMemoryTracker
    from traceml_tpu.utils.timing import GLOBAL_STEP_QUEUE, drain_step_memory_rows

    st = state.reset_state_for_tests()
    st.mem_tracker = StepMemoryTracker(FakeMemoryBackend(MEM), min_sample_interval_s=0.0)
    GLOBAL_STEP_QUEUE.drain()
    drain_step_memory_rows()
    server = TCPServer()
    server.start()
    settings = TraceMLSettings(
        session_id="rec", logs_dir=tmp_path / "jax", mode="summary",
        aggregator=AggregatorEndpoint(port=server.port), sampler_interval_sec=3600.0,
        trace_max_steps=CAP, transport="tcp",
    )
    try:
        return _drive(TraceMLRuntime(settings, RuntimeIdentity(global_rank=0)), trace_step, server)
    finally:
        state.reset_state_for_tests()
        GLOBAL_STEP_QUEUE.drain()
        drain_step_memory_rows()


def _run_port(tmp_path):
    from traceml_tpu_torch.runtime.runtime import TraceMLRuntime
    from traceml_tpu_torch.runtime.settings import AggregatorEndpoint, TraceMLSettings
    from traceml_tpu_torch.sdk import state
    from traceml_tpu_torch.sdk.instrumentation import trace_step
    from traceml_tpu_torch.transport.tcp_transport import TCPServer
    from traceml_tpu_torch.utils.step_memory import FakeMemoryBackend, StepMemoryTracker

    st = state.reset_state_for_tests(device="cpu")
    st.mem_tracker = StepMemoryTracker(FakeMemoryBackend(MEM), min_sample_interval_s=0.0)
    server = TCPServer()
    server.start()
    settings = TraceMLSettings(
        session_id="rec", logs_dir=tmp_path / "port", mode="summary",
        aggregator=AggregatorEndpoint(port=server.port), sampler_interval_sec=3600.0,
        trace_max_steps=CAP, transport="tcp",
    )
    try:
        return _drive(TraceMLRuntime(settings), trace_step, server)
    finally:
        state.reset_state_for_tests()


def _split(payloads):
    """(sampler, step) pairs of the step tables and the samplers with rows,
    before and after the one ``rank_finished``; the count of
    ``rank_finished`` markers."""
    finished = [i for i, p in enumerate(payloads) if control_kind(p) == "rank_finished"]
    cut = finished[0] if finished else len(payloads)
    halves = []
    for part in (payloads[:cut], payloads[cut + 1:]):
        pairs, samplers = set(), set()
        for env in filter(None, map(normalize_telemetry_envelope, part)):
            tables = env.tables
            for table in ("step_time", "step_memory"):
                pairs |= {(env.sampler, int(r["step"])) for r in tables.get(table, [])}
            if any(tables.values()):
                samplers.add(env.sampler)
        halves.append((pairs, samplers))
    return len(finished), halves


def test_runtime_ships_the_reference_rows_past_the_cap(tmp_path):
    jax_n, (jax_live, jax_final) = _split(_run_jax(tmp_path))
    port_n, (port_live, port_final) = _split(_run_port(tmp_path))
    assert jax_n == port_n == 1
    live = {(s, k) for s in ("step_time", "step_memory") for k in range(1, CAP + 1)}
    drained = {(s, k) for s in ("step_time", "step_memory") for k in range(CAP + 1, STEPS + 1)}
    assert jax_live[0] == port_live[0] == live
    assert jax_final[0] == port_final[0] == drained  # the post-cap steps, in the final drain
    for samplers in (jax_live[1], port_live[1], jax_final[1], port_final[1]):
        assert {"system", "process", "step_time", "step_memory"} <= samplers
    assert jax_final[1] == port_final[1]


def test_runtime_goes_quiet_after_the_cap(tmp_path):
    """From COMPLETE to the final drain the port's rank samples and sends
    nothing (the JAX contract), and its ``stop()`` sends no second
    ``rank_finished``."""
    from traceml_tpu_torch.runtime.runtime import TraceMLRuntime
    from traceml_tpu_torch.runtime.settings import TraceMLSettings
    from traceml_tpu_torch.sdk import state
    from traceml_tpu_torch.sdk.instrumentation import trace_step

    state.reset_state_for_tests(device="cpu")
    rt = TraceMLRuntime(TraceMLSettings(session_id="q", logs_dir=tmp_path, sampler_interval_sec=3600.0,
                                        trace_max_steps=1))
    rt.start()
    try:
        with trace_step():
            pass
        rt._tick()
        assert rt.recording.phase == port_rstate.COMPLETE and rt._finished_sent
        counts = {s.name: s.db.appended_total() for s in rt.samplers}
        for _ in range(3):
            with trace_step():
                pass
            rt._tick()
        assert {s.name: s.db.appended_total() for s in rt.samplers} == counts
        assert rt._take_rank_finished() is None
    finally:
        rt.stop()
        state.reset_state_for_tests()
    assert sum(s.db.appended_total() for s in rt.samplers) > sum(counts.values())  # the final drain
