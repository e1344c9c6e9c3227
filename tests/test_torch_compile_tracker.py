"""The compile tracker: dynamo's compiles as ``compile_time`` events.

Counterpart of the JAX package's compile-listener tests, on dynamo's
compile callbacks (``instrumentation/compile_tracker.py``).  Compiles
use ``backend="aot_eager"``, fast on the CPU.  Held here: a compiled
function inside ``trace_step`` adds ``compile_time`` events to the open
step (meta: ms, compile id, trigger) and bumps ``compile_count``; a fixed
shape under the auto-patches compiles once, into one graph (the patched
``nn.Module.__call__`` steps aside inside the compiled frame), and a new
shape compiles again; ``wrap_step_fn``'s FLOP-counted first call leaves
the compiled model compiling at the next; a compile under
``MIN_COMPILE_MS`` adds nothing; the install is idempotent, survives
``torch._dynamo.reset()`` by re-registering, waits for dynamo's first
import when dynamo is not loaded, and a failing callback never raises.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
pytest.importorskip("torch")  # a checkout without torch still collects
import torch
from torch import nn

from traceml_tpu_torch.instrumentation import compile_tracker as ct
from traceml_tpu_torch.sdk import initial
from traceml_tpu_torch.sdk.instrumentation import trace_step
from traceml_tpu_torch.sdk.state import get_state, reset_state_for_tests
from traceml_tpu_torch.sdk.step_fn import wrap_step_fn
from traceml_tpu_torch.utils import timing as T

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def fresh_state():
    import torch._dynamo

    torch._dynamo.reset()
    st = reset_state_for_tests(device="cpu")
    T.GLOBAL_STEP_QUEUE.drain()
    yield st
    reset_state_for_tests(device="cpu")
    T.GLOBAL_STEP_QUEUE.drain()
    torch._dynamo.reset()


def _net():
    torch.manual_seed(0)
    return nn.Sequential(nn.Linear(16, 32), nn.Tanh(), nn.Linear(32, 4))


def _compile_events():
    """(step, meta) of every compile_time event flushed so far."""
    return [(b.step, e.meta) for b in T.GLOBAL_STEP_QUEUE.drain() for e in b.events if e.name == T.COMPILE_TIME]


def test_compiled_function_in_step_emits_compile_time(fresh_state):
    initial.init(mode="manual", device="cpu")
    assert get_state().patches == ["compile_tracker"] and ct.compile_tracker_installed()

    @torch.compile(backend="aot_eager")
    def f(x):
        return torch.tanh(x) * 2 + 1

    step = wrap_step_fn(lambda x: f(x), estimate_flops=False)
    with trace_step():
        step(torch.randn(8, 8))
    with trace_step():
        step(torch.randn(8, 8))
    events = _compile_events()
    assert [s for s, _ in events] == [1]
    meta = events[0][1]
    assert meta["compile_ms"] >= ct.MIN_COMPILE_MS and meta["trigger"] == "dynamo"
    assert meta["compile_id"].startswith("0/")
    assert step.compile_count == 1 == fresh_state.compile_events_seen


def test_fixed_shape_under_auto_patches_compiles_once(fresh_state):
    import torch._dynamo.utils as dynamo_utils

    initial.init(mode="auto", device="cpu")
    model = torch.compile(_net(), backend="aot_eager", dynamic=False)
    dynamo_utils.counters.clear()
    for _ in range(3):
        with trace_step():
            model(torch.randn(4, 16))
    batches = T.GLOBAL_STEP_QUEUE.drain()
    compiles = [(b.step, e.meta["trigger"]) for b in batches for e in b.events if e.name == T.COMPILE_TIME]
    assert compiles == [(1, "dynamo")]
    assert dynamo_utils.counters["stats"]["unique_graphs"] == 1  # no graph break at the patch
    # the outermost call, made from eager code, stays timed: one forward a step
    assert [sum(e.name == T.FORWARD_TIME for e in b.events) for b in batches] == [1, 1, 1]
    with trace_step():
        model(torch.randn(5, 16))  # a new shape compiles again
    assert [(s, m["trigger"]) for s, m in _compile_events()] == [(4, "dynamo")]
    assert fresh_state.compile_events_seen == 2


def test_flop_counted_first_call_leaves_the_model_compiling(fresh_state):
    """``FlopCounterMode`` is a dispatch mode: dynamo would skip a frame
    asked to compile under it and mark its code skipped for good.  The
    counted call runs forced eager, so the model compiles at the next."""
    initial.init(mode="auto", device="cpu")
    net = _net()
    model = torch.compile(net, backend="aot_eager", dynamic=False)
    opt = torch.optim.SGD(net.parameters(), lr=0.1)

    def train(x):
        loss = model(x).square().mean()
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss.detach()

    step = wrap_step_fn(train)
    for _ in range(3):
        with trace_step():
            step(torch.randn(4, 16))
    assert fresh_state.flops_per_step and fresh_state.flops_source == "flop_counter"
    triggers = [(s, m["trigger"]) for s, m in _compile_events()]
    assert triggers == [(2, "dynamo"), (2, "lazy_backward")]
    assert step.compile_count == 2


def test_short_compile_adds_nothing(fresh_state, monkeypatch):
    from torch._dynamo.callback import CallbackArgs, CallbackTrigger

    clock = iter([10.0, 10.0 + 0.0015, 20.0, 20.0 + 0.0025])
    monkeypatch.setattr(ct, "_now", lambda: next(clock))
    with trace_step():
        for cid in ("3/0", "3/1"):
            args = CallbackArgs(CallbackTrigger.DYNAMO, cid)
            ct._on_compile_start(args)
            ct._on_compile_end(args)
    events = _compile_events()
    assert [m["compile_id"] for _, m in events] == ["3/1"]
    assert events[0][1]["compile_ms"] == pytest.approx(2.5)
    assert fresh_state.compile_events_seen == 1


def test_install_is_idempotent_and_survives_reset(fresh_state):
    import torch._dynamo
    from torch._dynamo.callback import callback_handler

    assert ct.install_compile_tracker() == "patched"
    assert ct.install_compile_tracker() == "patched"
    assert callback_handler.end_callbacks.count(ct._on_compile_end) == 1
    assert callback_handler.start_callbacks.count(ct._on_compile_start) == 1
    torch._dynamo.reset()  # clears every callback
    assert not ct.compile_tracker_installed()
    ct.install_compile_tracker()
    assert ct.compile_tracker_installed()
    ct.uninstall_compile_tracker()
    assert ct._on_compile_end not in callback_handler.end_callbacks


def test_callbacks_fail_open(fresh_state, monkeypatch):
    from torch._dynamo.callback import CallbackArgs, CallbackTrigger

    def boom():
        raise RuntimeError("state unavailable")

    monkeypatch.setattr(ct, "get_state", boom)
    args = CallbackArgs(CallbackTrigger.DYNAMO, "9/0")
    ct._on_compile_start(args)
    ct._starts["9/0"] -= 1.0  # a 1 s compile
    ct._on_compile_end(args)  # logs, does not raise
    ct._on_compile_end(None)  # not a CallbackArgs: logs, does not raise
    assert fresh_state.compile_events_seen == 0


def test_deferred_until_dynamo_is_imported():
    """``init`` in a process that has not imported dynamo does not import
    it (seconds of import), and registers at its first import."""
    code = (
        "import sys, torch\n"
        "from traceml_tpu_torch.sdk import initial\n"
        "from traceml_tpu_torch.sdk.state import get_state\n"
        "initial.init(mode='manual', device='cpu')\n"
        "from traceml_tpu_torch.instrumentation import compile_tracker as ct\n"
        "print('before', 'torch._dynamo' in sys.modules, get_state().patches)\n"
        "import torch._dynamo\n"
        "print('after', ct.compile_tracker_installed())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "before False ['compile_tracker']" in out.stdout and "after True" in out.stdout
