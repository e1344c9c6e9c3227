"""The Lightning callback, against stand-ins for Lightning.

The JAX package's cases (the Lightning half of
``tests/integrations/test_lightning_ray_ast.py`` with a stub
``pytorch_lightning`` base, and ``test_lightning_dual_base.py`` with the
fake packages of ``tests/fakes``, whose Trainer drives a real torch model
through Lightning's automatic-optimization hook order, the sanity pass
included), on the port's callback.  Added for the port: the same hook
sequences give the same region sequence from the JAX callback and the
port's; while the callback owns a step the auto-patches time nothing;
``setup`` initialises in manual mode on the module's device.
"""

import sys
import types
from pathlib import Path

import pytest
pytest.importorskip("torch")  # a checkout without torch still collects

from traceml_tpu_torch.sdk import state as state_mod
from traceml_tpu_torch.utils import timing as T
from traceml_tpu_torch.utils.step_memory import FakeMemoryBackend, StepMemoryTracker

FAKES = Path(__file__).resolve().parent / "fakes"


@pytest.fixture(autouse=True)
def fresh_state():
    st = state_mod.reset_state_for_tests(device="cpu")
    st.mem_tracker = StepMemoryTracker(FakeMemoryBackend([[]]))
    T.GLOBAL_STEP_QUEUE.drain()
    T.drain_step_memory_rows()
    yield st
    state_mod.reset_state_for_tests(device="cpu")
    T.GLOBAL_STEP_QUEUE.drain()
    T.drain_step_memory_rows()


@pytest.fixture()
def stub_lightning(monkeypatch):
    import traceml_tpu_torch.integrations.lightning as L

    pl = types.ModuleType("pytorch_lightning")

    class Callback:
        pass

    pl.Callback = Callback
    monkeypatch.setitem(sys.modules, "pytorch_lightning", pl)
    monkeypatch.setattr(L, "_cached_callback_cls", None)
    yield L


class _Trainer:
    sanity_checking = False


class _Loss:
    """A loss stand-in (no CUDA tensor: the CPU rows are host-clock)."""

    size = 1

    def is_ready(self):
        return True


def _drive_one_batch(cb, trainer, loss=None):
    """Lightning's automatic-optimization hook order: batch_start →
    training_step → before_zero_grad → zero_grad → before_backward →
    backward → after_backward → before_optimizer_step → step →
    batch_end."""
    cb.on_train_batch_start(trainer, None, batch=None, batch_idx=0)
    cb.on_before_zero_grad(trainer, None, optimizer=None)  # BEFORE backward
    cb.on_before_backward(trainer, None, loss=loss if loss is not None else _Loss())
    cb.on_after_backward(trainer, None)
    cb.on_before_optimizer_step(trainer, None, optimizer=None)
    cb.on_train_batch_end(trainer, None, outputs=None, batch=None, batch_idx=0)


def _drive_manual(cb, trainer):
    """Manual optimization: zero_grad AFTER step."""
    cb.on_train_batch_start(trainer, None, batch=None, batch_idx=0)
    cb.on_before_backward(trainer, None, loss=_Loss())
    cb.on_after_backward(trainer, None)
    cb.on_before_optimizer_step(trainer, None, optimizer=None)
    cb.on_before_zero_grad(trainer, None, optimizer=None)  # closes the optimizer
    cb.on_train_batch_end(trainer, None, outputs=None, batch=None, batch_idx=0)


def test_lightning_callback_owns_phase_timing(stub_lightning, fresh_state):
    cb = stub_lightning.TraceMLCallback(auto_init=False)
    captured = []
    fresh_state.on_batch_flushed.append(captured.append)
    trainer = _Trainer()
    try:
        _drive_one_batch(cb, trainer)
        events = captured[-1].events
        names = [e.name for e in events]
        for name in (T.FORWARD_TIME, T.BACKWARD_TIME, T.OPTIMIZER_STEP, T.STEP_TIME):
            assert names.count(name) == 1
        # the early zero_grad did not close the forward: it ends at
        # before_backward, before the backward begins
        fwd = next(e for e in events if e.name == T.FORWARD_TIME)
        bwd = next(e for e in events if e.name == T.BACKWARD_TIME)
        assert fwd.cpu_end <= bwd.cpu_start
        # the gates are back down after the batch
        for gate in ("forward_depth", "backward_depth", "compute_depth"):
            assert getattr(fresh_state.tls, gate) == 0
    finally:
        fresh_state.on_batch_flushed.remove(captured.append)
        cb.teardown(trainer, None)


def test_lightning_manual_optimization_order(stub_lightning, fresh_state):
    cb = stub_lightning.TraceMLCallback(auto_init=False)
    captured = []
    fresh_state.on_batch_flushed.append(captured.append)
    trainer = _Trainer()
    try:
        _drive_manual(cb, trainer)
        opt = next(e for e in captured[-1].events if e.name == T.OPTIMIZER_STEP)
        assert opt.cpu_end is not None
    finally:
        fresh_state.on_batch_flushed.remove(captured.append)
        cb.teardown(trainer, None)


def test_lightning_sanity_check_not_timed(stub_lightning, fresh_state):
    cb = stub_lightning.TraceMLCallback(auto_init=False)
    captured = []
    fresh_state.on_batch_flushed.append(captured.append)
    try:
        trainer = _Trainer()
        trainer.sanity_checking = True
        _drive_one_batch(cb, trainer)
        assert captured == []
        assert fresh_state.current_step == 0
    finally:
        fresh_state.on_batch_flushed.remove(captured.append)


def test_lightning_survives_out_of_order_hooks(stub_lightning):
    cb = stub_lightning.TraceMLCallback(auto_init=False)
    trainer = _Trainer()
    # end without start, backward without a step: no-ops, no raise
    cb.on_train_batch_end(trainer, None, outputs=None, batch=None, batch_idx=0)
    cb.on_before_backward(trainer, None, loss=None)
    cb.on_after_backward(trainer, None)
    cb.on_train_end(trainer, None)


def _region_sequence(batches):
    return [[(e.name, e.step) for e in sorted(b.events, key=lambda e: e.cpu_start)] for b in batches]


@pytest.mark.parametrize("order", ["automatic", "manual"])
def test_region_sequence_matches_jax_callback(stub_lightning, fresh_state, order):
    """The same hook sequence, three batches, through the JAX callback
    and the port's: the same regions in the same order, step by step."""
    import traceml_tpu.integrations.lightning as JL
    from traceml_tpu.sdk import state as jax_state

    drive = _drive_one_batch if order == "automatic" else _drive_manual
    JL._cached_callback_cls = None
    try:
        jst = jax_state.reset_state_for_tests()
        jax_got, port_got = [], []
        jst.on_batch_flushed.append(jax_got.append)
        fresh_state.on_batch_flushed.append(port_got.append)
        jcb = JL.TraceMLCallback(auto_init=False)
        pcb = stub_lightning.TraceMLCallback(auto_init=False)
        trainer = _Trainer()
        for _ in range(3):
            drive(jcb, trainer)
            drive(pcb, trainer)
        jcb.on_train_end(trainer, None)
        pcb.on_train_end(trainer, None)
        assert len(port_got) == 3
        assert _region_sequence(port_got) == _region_sequence(jax_got)
    finally:
        JL._cached_callback_cls = None
        jax_state.reset_state_for_tests()


def test_auto_patches_stand_aside_while_the_callback_owns_the_step(stub_lightning, fresh_state):
    """Under ``init(mode="auto")`` the forward, backward and optimizer
    patches would time the same work again; inside the callback's step
    each phase is timed once."""
    import torch

    import traceml_tpu_torch as tm

    tm.init(mode="auto", device="cpu")
    model = torch.nn.Linear(8, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    cb = stub_lightning.TraceMLCallback(auto_init=False)
    captured = []
    fresh_state.on_batch_flushed.append(captured.append)
    trainer = _Trainer()
    try:
        cb.on_train_batch_start(trainer, model, batch=None, batch_idx=0)
        loss = model(torch.ones(4, 8)).pow(2).mean()
        cb.on_before_zero_grad(trainer, model, optimizer=opt)
        opt.zero_grad()
        cb.on_before_backward(trainer, model, loss=loss)
        loss.backward()
        cb.on_after_backward(trainer, model)
        cb.on_before_optimizer_step(trainer, model, optimizer=opt)
        opt.step()
        cb.on_train_batch_end(trainer, model, outputs=loss.detach(), batch=None, batch_idx=0)
        names = [e.name for e in captured[-1].events]
        for name in (T.FORWARD_TIME, T.BACKWARD_TIME, T.OPTIMIZER_STEP):
            assert names.count(name) == 1, names
    finally:
        fresh_state.on_batch_flushed.remove(captured.append)


def test_setup_inits_manual_on_the_modules_device(stub_lightning, fresh_state):
    import torch

    cb = stub_lightning.TraceMLCallback()
    cb.setup(_Trainer(), torch.nn.Linear(2, 2), stage="fit")
    assert fresh_state.initialized and fresh_state.patch_mode == "manual"
    assert fresh_state.device.type == "cpu"
    assert "torch_forward" not in fresh_state.patches


# -- the fake packages, both layouts -------------------------------------------------


@pytest.fixture()
def fake_lightning_path(monkeypatch):
    import traceml_tpu_torch.integrations.lightning as L

    monkeypatch.syspath_prepend(str(FAKES))
    monkeypatch.setattr(L, "_cached_callback_cls", None)
    yield L
    for name in [m for m in sys.modules
                 if m == "_fake_lightning_impl" or m.startswith(("lightning", "pytorch_lightning"))]:
        del sys.modules[name]


def _fit_and_capture(L, trainer_cls, st, steps=6):
    import numpy as np
    import torch

    model = torch.nn.Linear(16, 1)
    cb = L.TraceMLCallback(auto_init=False)
    captured = []
    st.on_batch_flushed.append(captured.append)
    try:
        rng = np.random.default_rng(0)
        batches = [torch.tensor(rng.normal(size=(8, 16)).astype("float32"))
                   for _ in range(steps + 2)]  # +2 sanity batches
        trainer = trainer_cls(callbacks=[cb], max_steps=steps)
        trainer.fit(model, batches)
    finally:
        st.on_batch_flushed.remove(captured.append)
    return cb, captured


def test_new_layout_full_fit(fake_lightning_path, fresh_state):
    """``lightning.pytorch``: a real fit gives one timed batch a training
    step with forward, backward and optimizer, none for the sanity pass."""
    import lightning.pytorch as lp

    cb, captured = _fit_and_capture(fake_lightning_path, lp.Trainer, fresh_state, steps=6)
    assert isinstance(cb, lp.Callback)
    assert len(captured) == 6
    for batch in captured:
        names = [e.name for e in batch.events]
        for name in (T.FORWARD_TIME, T.BACKWARD_TIME, T.OPTIMIZER_STEP, T.STEP_TIME):
            assert name in names
        fwd = next(e for e in batch.events if e.name == T.FORWARD_TIME)
        bwd = next(e for e in batch.events if e.name == T.BACKWARD_TIME)
        assert fwd.cpu_end is not None and fwd.cpu_end <= bwd.cpu_start


def test_legacy_layout_full_fit(fake_lightning_path, fresh_state, monkeypatch):
    """Only ``pytorch_lightning`` importable: the same on the legacy base."""
    import importlib

    real_import = importlib.import_module

    def no_new_layout(name, *a, **kw):
        if name == "lightning.pytorch":
            raise ImportError("hidden by test")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(importlib, "import_module", no_new_layout)
    import pytorch_lightning as pl

    cb, captured = _fit_and_capture(fake_lightning_path, pl.Trainer, fresh_state, steps=4)
    assert isinstance(cb, pl.Callback)
    assert type(cb).__mro__[1:3] != (object,)
    assert len(captured) == 4


def test_dual_base_when_both_installed(fake_lightning_path, fresh_state):
    """Both layouts importable: one class subclassing both bases, usable
    with either flavour's Trainer."""
    import lightning.pytorch as lp
    import pytorch_lightning as pl

    cls = fake_lightning_path.make_traceml_callback()
    assert issubclass(cls, lp.Callback) and issubclass(cls, pl.Callback)
    cb, captured = _fit_and_capture(fake_lightning_path, pl.Trainer, fresh_state, steps=3)
    assert isinstance(cb, lp.Callback) and isinstance(cb, pl.Callback)
    assert len(captured) == 3


def test_no_lightning_raises_import_error(monkeypatch):
    import traceml_tpu_torch.integrations.lightning as L

    monkeypatch.setattr(L, "_cached_callback_cls", None)
    monkeypatch.setattr(L, "_callback_bases", lambda: ())
    with pytest.raises(ImportError):
        L.make_traceml_callback()
