"""The ``torch_h2d`` auto-patch against the JAX package's ``jax_h2d`` patch.

* Gate decisions: the same cases go through the JAX patch
  (``jax.device_put`` under the JAX ``trace_step``) and the port's patched
  ``Tensor.to`` / ``Tensor.cuda`` (under the port's ``trace_step``); each
  case must time a copy on both sides or on neither.  The CUDA
  destinations are ``torch.device("cuda")`` objects, which need no CUDA:
  the copy itself is stubbed (the stub returns a clone where the card
  would), and a tensor "already on a device" is a meta tensor.
* Rows: a timed copy's event and the step-time row it makes carry the
  JAX row's fields.
* Outermost only: the copy inside ``timed_to_device`` (``wrap_h2d``,
  ``wrap_dataloader(to_device=True)``) is timed once.
* FakeTensors and dynamo pass straight through: no event, no graph break.
* Lifecycle: ``init(mode="auto")`` installs the patch as ``torch_h2d``,
  ``init(patch_h2d=False)`` leaves ``Tensor.to`` untouched, and
  ``reset_state_for_tests`` and ``shutdown_patches`` restore it.
"""

import jax
import numpy as np
import pytest
pytest.importorskip("torch")  # a checkout without torch still collects
import torch

from traceml_tpu.instrumentation.patches import jax_h2d_patch
from traceml_tpu.sdk.instrumentation import trace_step as jax_trace_step
from traceml_tpu.sdk.state import reset_state_for_tests as jax_reset
from traceml_tpu.utils.timing import GLOBAL_STEP_QUEUE as JAX_QUEUE
from traceml_tpu_torch.instrumentation.patches import torch_h2d_patch
from traceml_tpu_torch.sdk import initial
from traceml_tpu_torch.sdk.instrumentation import trace_step
from traceml_tpu_torch.sdk.state import get_state, reset_state_for_tests
from traceml_tpu_torch.utils import timing as T

CUDA = torch.device("cuda")
REAL_TO = torch.Tensor.to
REAL_CUDA = torch.Tensor.cuda


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


@pytest.fixture
def stubbed_copy():
    """``Tensor.to``/``.cuda`` whose copies to a CUDA device return a clone
    (no card needed), under the port's patch; restored afterwards."""
    copies = []

    def fake_to(self, *args, **kwargs):
        dst = torch._C._nn._parse_to(*args, **kwargs)[0]
        if _is_cuda(dst):
            copies.append(dst)
            return self.clone()
        return REAL_TO(self, *args, **kwargs)

    def fake_cuda(self, *args, **kwargs):
        copies.append(CUDA)
        return self.clone()

    reset_state_for_tests(device="cpu")
    torch.Tensor.to, torch.Tensor.cuda = fake_to, fake_cuda
    try:
        assert torch_h2d_patch.patch_torch_h2d()
        yield copies
    finally:
        reset_state_for_tests()  # unpatches: the fakes are back
        del torch.Tensor.to, torch.Tensor.cuda
    assert torch.Tensor.to is REAL_TO and torch.Tensor.cuda is REAL_CUDA


def _h2d_events(batches):
    return sum(1 for batch in batches for ev in batch.events if ev.name == T.H2D_TIME)


def _jax_case(case):
    """H2D events the JAX patch records for ``case``."""
    host = np.ones((4, 4), np.float32)
    on_device = jax.device_put(host)
    actions = {
        "host_to_device": lambda: jax.device_put(host),
        "out_of_step": lambda: jax.device_put(host),
        "nested_in_wrap_h2d": lambda: jax.device_put(host),
        "already_on_destination": lambda: jax.device_put(on_device),
        "dtype_only_cast": lambda: host.astype(np.float16),  # a cast is no copy
        "d2d": lambda: jax.device_put(on_device, jax.devices()[-1]),
    }
    JAX_QUEUE.drain()
    st = jax_reset()
    assert jax_h2d_patch.patch_jax_h2d()
    try:
        if case == "out_of_step":
            actions[case]()
            return _h2d_events(JAX_QUEUE.drain())
        with jax_trace_step(st):
            if case == "nested_in_wrap_h2d":
                st.tls.h2d_depth += 1
            actions[case]()
            st.tls.h2d_depth = 0
        return _h2d_events(JAX_QUEUE.drain())
    finally:
        jax_h2d_patch.unpatch_jax_h2d()
        jax_reset()


def _port_case(case, copies):
    host = torch.ones(4, 4)
    on_device = torch.ones(4, 4, device="meta")
    actions = {
        "host_to_device": lambda: host.to(CUDA, non_blocking=True),
        "out_of_step": lambda: host.to("cuda"),
        "nested_in_wrap_h2d": lambda: host.cuda(),
        "already_on_destination": lambda: on_device.to(CUDA),
        "dtype_only_cast": lambda: host.to(torch.float16),
        "d2d": lambda: on_device.to("cuda:1"),
    }
    st = get_state()
    T.GLOBAL_STEP_QUEUE.drain()
    if case == "out_of_step":
        actions[case]()
        return _h2d_events(T.GLOBAL_STEP_QUEUE.drain())
    with trace_step(st):
        if case == "nested_in_wrap_h2d":
            st.tls.h2d_depth += 1
        actions[case]()
        st.tls.h2d_depth = 0
    return _h2d_events(T.GLOBAL_STEP_QUEUE.drain())


CASES = ("host_to_device", "out_of_step", "nested_in_wrap_h2d", "already_on_destination",
         "dtype_only_cast", "d2d")


@pytest.mark.parametrize("case", CASES)
def test_gate_decisions_equal_the_jax_patch(case, stubbed_copy):
    theirs = _jax_case(case)
    ours = _port_case(case, stubbed_copy)
    assert ours == theirs == (1 if case == "host_to_device" else 0)


def test_cuda_method_is_timed_like_to(stubbed_copy):
    st = get_state()
    T.GLOBAL_STEP_QUEUE.drain()
    with trace_step(st):
        out = torch.arange(6).cuda(non_blocking=True)
    assert torch.equal(out, torch.arange(6)) and stubbed_copy == [CUDA]
    assert _h2d_events(T.GLOBAL_STEP_QUEUE.drain()) == 1


def test_timed_copy_row_has_the_jax_fields(stubbed_copy):
    """The event and the step-time row of one timed copy, against the JAX
    patch's on the same step."""
    from traceml_tpu.samplers.step_time_sampler import _aggregate_step as jax_aggregate
    from traceml_tpu_torch.samplers.step_time_sampler import _aggregate_step

    JAX_QUEUE.drain()
    jst = jax_reset()
    jax_h2d_patch.patch_jax_h2d()
    try:
        with jax_trace_step(jst):
            jax.device_put(np.ones((8, 1025), np.int64)).block_until_ready()
        (jax_batch,) = JAX_QUEUE.drain()
    finally:
        jax_h2d_patch.unpatch_jax_h2d()
        jax_reset()
    T.GLOBAL_STEP_QUEUE.drain()
    with trace_step(get_state()):
        torch.ones(8, 1025, dtype=torch.int64).to(CUDA, non_blocking=True)
    (batch,) = T.GLOBAL_STEP_QUEUE.drain()

    def h2d(events):
        (ev,) = [e for e in events if e.name == T.H2D_TIME]
        return ev

    ours, theirs = h2d(batch.events), h2d(jax_batch.events)
    assert ours.name == theirs.name and ours.step == theirs.step == 1
    assert ours.cpu_ms > 0 and theirs.cpu_ms > 0
    jax_batch.force_resolve()
    batch.force_resolve()
    row, _ = _aggregate_step(batch.events, None)
    jax_row, _ = jax_aggregate(jax_batch.events, None)
    assert set(row) <= set(jax_row) | {"late_markers"}
    assert set(row["events"]) == set(jax_row["events"]) == {T.STEP_TIME, T.H2D_TIME}
    assert set(row["events"][T.H2D_TIME]) == set(jax_row["events"][T.H2D_TIME])
    assert row["events"][T.H2D_TIME]["count"] == jax_row["events"][T.H2D_TIME]["count"] == 1
    assert row["clock"] == "host"  # the stubbed copy left no CUDA tensor to mark


def test_timed_to_device_is_timed_once(stubbed_copy, monkeypatch):
    """``wrap_h2d`` and ``wrap_dataloader(to_device=True)`` time their copy
    in ``timed_to_device``; the patch inside it stays silent."""
    from traceml_tpu_torch.sdk import wrappers

    monkeypatch.setattr(wrappers, "cuda_marker", lambda device: None)
    st = get_state()
    T.GLOBAL_STEP_QUEUE.drain()
    with trace_step(st):
        out = wrappers.timed_to_device({"x": torch.ones(3), "y": [torch.zeros(2)]}, CUDA, st)
        assert st.tls.h2d_depth == 0
    assert len(stubbed_copy) == 2 and set(out) == {"x", "y"}
    assert _h2d_events(T.GLOBAL_STEP_QUEUE.drain()) == 1


def test_fake_tensors_pass_through(stubbed_copy):
    from torch._subclasses.fake_tensor import FakeTensorMode

    st = get_state()
    T.GLOBAL_STEP_QUEUE.drain()
    with trace_step(st):
        with FakeTensorMode() as mode:
            fake = mode.from_tensor(torch.ones(4))
            fake.to(CUDA)
            torch.ones(4).to(CUDA)  # a real tensor under the fake mode
    assert _h2d_events(T.GLOBAL_STEP_QUEUE.drain()) == 0


def test_dynamo_traces_through_without_a_break():
    """The installed patch over the real ``Tensor.to``: in a step, a
    compiled function's casts of CPU tensors make one graph and no event."""
    import torch._dynamo as dynamo

    reset_state_for_tests(device="cpu")
    initial.init(mode="auto", device="cpu")

    graphs = []

    def backend(gm, example_inputs):
        graphs.append(gm)
        return gm.forward

    def fn(x):
        return (x.to(torch.float64) * 2).to(torch.float32) + 1

    dynamo.reset()
    compiled = torch.compile(fn, backend=backend)
    st = get_state()
    T.GLOBAL_STEP_QUEUE.drain()
    x = torch.arange(4.0)
    try:
        with trace_step(st):
            out = compiled(x)
    finally:
        dynamo.reset()
        reset_state_for_tests()
    assert torch.equal(out, fn(x)) and len(graphs) == 1
    assert _h2d_events(T.GLOBAL_STEP_QUEUE.drain()) == 0


def test_init_installs_and_reset_restores():
    reset_state_for_tests(device="cpu")
    try:
        initial.init(mode="auto", device="cpu", patch_h2d=False)
        assert "torch_h2d" not in get_state().patches
        assert torch.Tensor.to is REAL_TO and "to" not in torch.Tensor.__dict__
        reset_state_for_tests(device="cpu")
        initial.init(mode="auto", device="cpu")
        assert get_state().patches[0] == "torch_h2d"
        assert torch.Tensor.to is not REAL_TO and torch.Tensor.cuda is not REAL_CUDA
        initial.shutdown_patches()
        assert torch.Tensor.to is REAL_TO and torch.Tensor.cuda is REAL_CUDA
        assert "to" not in torch.Tensor.__dict__ and "cuda" not in torch.Tensor.__dict__
        initial.init(mode="auto", device="cpu")
        reset_state_for_tests()
        assert torch.Tensor.to is REAL_TO and get_state().patches == []
    finally:
        reset_state_for_tests()


def test_patched_casts_keep_their_results():
    """On the CPU every call passes through: the model's casts, a copy to
    the CPU, a cast with a memory format."""
    reset_state_for_tests(device="cpu")
    try:
        initial.init(mode="auto", device="cpu")
        x = torch.randn(2, 3, 4, 5)
        with trace_step(get_state()):
            assert x.to(torch.bfloat16).dtype == torch.bfloat16
            assert x.to("cpu") is x
            assert x.to(torch.float64, copy=True).dtype == torch.float64
            y = x.to(memory_format=torch.channels_last)
            assert y.is_contiguous(memory_format=torch.channels_last)
            assert x.to(torch.ones(1, dtype=torch.float16)).dtype == torch.float16
    finally:
        reset_state_for_tests()
