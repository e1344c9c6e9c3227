"""The port's auto-patches against the JAX package's torch patches.

* Parity: the same small torch training loop (a module calling a
  submodule, ``loss.backward()``, ``torch.autograd.backward``,
  ``optimizer.step()``) runs once under the JAX package's patches and
  ``trace_step``, then, after its ``unpatch_all_torch``, under the port's;
  every step gives the same event names with the same counts.
* The outermost-only and target-model filters (with a DDP-style
  ``.module`` wrapper), the duplicate guards (``wrap_forward`` under the
  forward patch, ``wrap_optimizer`` under the hooks) and the port's own
  guard: nothing is recorded inside ``wrap_step_fn``'s compute region.
* ``unpatch_all_torch`` restores ``nn.Module.__call__``,
  ``Tensor.backward`` and ``torch.autograd.backward`` and removes the
  hooks; ``init`` records what it installed (the ``torch_h2d`` patch
  first, ``tests/test_torch_h2d.py``) and honours ``patch_*``.
* Under ``init(mode="auto")`` the forward loop of ``forward_script.py``
  gives exactly the phases it gave before the patches existed: input,
  h2d, compute and the envelope, no forward.
"""

from collections import Counter

import pytest
pytest.importorskip("torch")  # a checkout without torch still collects
import torch
from torch import nn

from traceml_tpu_torch.instrumentation.patches import torch_patches as port_patches
from traceml_tpu_torch.sdk import initial
from traceml_tpu_torch.sdk.state import reset_state_for_tests
from traceml_tpu_torch.utils import timing as T

STEPS = 3


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.inner = nn.Linear(8, 8)
        self.head = nn.Linear(8, 1)

    def forward(self, x):
        return self.head(torch.relu(self.inner(x)))


class Wrapper(nn.Module):
    """A DDP-style wrapper: the traced model is its ``.module``."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def forward(self, x):
        return self.module(x)


@pytest.fixture(autouse=True)
def clean_patches():
    reset_state_for_tests(device="cpu")
    yield
    reset_state_for_tests()


def _loop(trace_step, state, steps=STEPS, model=None, body=None):
    torch.manual_seed(0)
    model = model or Net()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    x = torch.randn(4, 8)
    for i in range(steps):
        with trace_step(state):
            if body is not None:
                body(model, opt, x)
                continue
            loss = model(x).pow(2).mean()
            if i % 2:
                torch.autograd.backward(loss)
            else:
                loss.backward()
            opt.step()
            opt.zero_grad()


def _names_per_step(queue):
    return [Counter(e.name for e in batch.events) for batch in queue.drain()]


def _port_events(**loop_kwargs):
    from traceml_tpu_torch.sdk.instrumentation import trace_step

    st = reset_state_for_tests(device="cpu")
    initial.init(mode="auto", device="cpu")
    _loop(trace_step, st, **loop_kwargs)
    return _names_per_step(T.GLOBAL_STEP_QUEUE)


def test_same_events_per_step_as_the_jax_patches():
    from traceml_tpu.instrumentation.patches import torch_patches as jax_patches
    from traceml_tpu.sdk.instrumentation import trace_step as jax_trace_step
    from traceml_tpu.sdk.state import reset_state_for_tests as jax_reset
    from traceml_tpu.utils.timing import GLOBAL_STEP_QUEUE as JAX_QUEUE

    reset_state_for_tests()  # no port patch under the JAX run
    JAX_QUEUE.drain()
    jst = jax_reset()
    assert jax_patches.patch_torch_forward() and jax_patches.patch_torch_backward()
    assert jax_patches.install_torch_optimizer_hooks()
    try:
        _loop(jax_trace_step, jst)
    finally:
        jax_patches.unpatch_all_torch()
    theirs = _names_per_step(JAX_QUEUE)
    ours = _port_events()
    assert len(ours) == len(theirs) == STEPS
    assert ours == theirs
    assert ours[0] == Counter({T.STEP_TIME: 1, T.FORWARD_TIME: 1, T.BACKWARD_TIME: 1, T.OPTIMIZER_STEP: 1})


def test_outermost_only_and_target_filter():
    model = Net()
    # submodule calls inside the outer call are not recorded again
    assert _port_events(model=model)[0][T.FORWARD_TIME] == 1

    wrapped, other = Wrapper(Net()), Net()

    def body(model, opt, x):
        other(x)  # not the traced model: untimed
        model(x)

    st = reset_state_for_tests(device="cpu")
    from traceml_tpu_torch.sdk.instrumentation import trace_step

    initial.init(mode="auto", device="cpu", traced_model=wrapped)
    _loop(trace_step, st, model=wrapped, body=body)
    per_step = _names_per_step(T.GLOBAL_STEP_QUEUE)
    assert [c[T.FORWARD_TIME] for c in per_step] == [1] * STEPS
    # the wrapper's .module is a target too: calling it directly is timed
    _loop(trace_step, st, model=wrapped, body=lambda m, o, x: m.module(x))
    assert [c[T.FORWARD_TIME] for c in _names_per_step(T.GLOBAL_STEP_QUEUE)] == [1] * STEPS


def test_wrappers_and_compute_region_are_not_counted_twice():
    from traceml_tpu_torch.sdk.step_fn import wrap_step_fn
    from traceml_tpu_torch.sdk.wrappers import wrap_backward, wrap_forward, wrap_optimizer

    def manual(model, opt, x):
        wrap_optimizer(opt)
        loss = wrap_forward(model)(x).pow(2).mean()
        wrap_backward(loss.backward)()
        opt.step()

    per_step = _port_events(body=manual)
    assert all(c[k] == 1 for c in per_step for k in (T.FORWARD_TIME, T.BACKWARD_TIME, T.OPTIMIZER_STEP))

    def step_fn(model, opt, x):
        loss = model(x).pow(2).mean()
        loss.backward()
        opt.step()

    per_step = _port_events(body=lambda m, o, x: wrap_step_fn(step_fn, device="cpu")(m, o, x))
    assert per_step == [Counter({T.STEP_TIME: 1, T.COMPUTE_TIME: 1})] * STEPS


def test_nothing_is_recorded_out_of_a_step():
    initial.init(mode="auto", device="cpu")
    model = Net()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    model(torch.randn(2, 8)).sum().backward()
    opt.step()
    assert T.GLOBAL_STEP_QUEUE.drain() == []


def test_unpatch_restores_originals_and_removes_hooks():
    call, t_bwd, a_bwd = nn.Module.__call__, torch.Tensor.backward, torch.autograd.backward
    cfg = initial.init(mode="auto", device="cpu")
    assert cfg.mode == "auto"
    from traceml_tpu_torch.sdk.state import get_state

    assert get_state().patches == [
        "torch_h2d", "torch_dataloader", "torch_forward", "torch_backward", "torch_optimizer"]
    assert nn.Module.__call__ is not call and torch.Tensor.backward is not t_bwd
    assert torch.autograd.backward is not a_bwd
    port_patches.unpatch_all_torch()
    assert (nn.Module.__call__, torch.Tensor.backward, torch.autograd.backward) == (call, t_bwd, a_bwd)
    from traceml_tpu_torch.sdk.instrumentation import trace_step

    _loop(trace_step, get_state())
    assert _names_per_step(T.GLOBAL_STEP_QUEUE) == [Counter({T.STEP_TIME: 1})] * STEPS


def test_init_modes_install_what_they_say():
    from traceml_tpu_torch.sdk.state import get_state

    call = nn.Module.__call__
    initial.init(mode="manual", device="cpu")
    assert get_state().patches == [] and nn.Module.__call__ is call
    reset_state_for_tests(device="cpu")
    initial.init(mode="auto", device="cpu", patch_forward=False, patch_dataloader=False)
    assert get_state().patches == ["torch_h2d", "torch_backward", "torch_optimizer"]


def test_dataloader_patch_times_each_batch():
    from torch.utils.data import DataLoader

    from traceml_tpu_torch.sdk.instrumentation import trace_step

    st = reset_state_for_tests(device="cpu")
    initial.init(mode="auto", device="cpu")
    for batch in DataLoader(list(range(6)), batch_size=2):
        with trace_step(st):
            pass
    per_step = _names_per_step(T.GLOBAL_STEP_QUEUE)
    assert sum(c[T.DATALOADER_NEXT] for c in per_step) == 3


def test_forward_script_loop_keeps_its_phases(capsys):
    """The forward loop under auto mode: the forward patch is installed,
    yet inside wrap_step_fn's compute region it records nothing."""
    from traceml_tpu_torch.dev import forward_script

    assert forward_script.main(["--device", "cpu", "--tiny", "--steps", "4"]) == 0
    from traceml_tpu_torch.sdk.state import get_state

    assert "torch_forward" in get_state().patches
    per_step = _names_per_step(T.GLOBAL_STEP_QUEUE)
    assert per_step == [Counter({T.STEP_TIME: 1, T.DATALOADER_NEXT: 1, T.H2D_TIME: 1, T.COMPUTE_TIME: 1})] * 4
