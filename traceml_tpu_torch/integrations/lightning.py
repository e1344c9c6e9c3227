"""PyTorch Lightning integration.

Counterpart of ``traceml_tpu/integrations/lightning.py``: a Callback that
OWNS the forward, backward and optimizer timing, because Lightning owns
the loop.  Neither ``lightning`` nor ``pytorch_lightning`` is a
dependency: the callback class is built at first use against whichever
of their ``Callback`` bases is importable (both, when both are).

Phase mapping (Lightning hooks → TraceML regions), the JAX file's.
Region transitions are PHASE-AWARE, not positional, because Lightning's
automatic-optimization hook order fires zero_grad BEFORE backward
(batch_start → training_step → before_zero_grad → zero_grad →
before_backward → backward → after_backward → before_optimizer_step →
step → batch_end), while manual optimization fires them in other orders:

* ``on_train_batch_start``      → close the previous step, open
  ``trace_step`` and the ``forward`` region (Lightning has no pre-forward
  hook, so the forward runs from batch start to just before backward)
* ``on_before_backward``        → close ``forward`` with the loss as its
  device probe, open ``backward``
* ``on_after_backward``         → close ``backward``
* ``on_before_optimizer_step``  → open ``optimizer``
* ``on_before_zero_grad``       → close ``optimizer`` ONLY if it is the
  open region (under automatic optimization this hook fires while
  ``forward`` is open, and must not close it)
* ``on_train_batch_end``        → close any open region and the step
* sanity-check batches are never timed.

Each region closes with a CUDA event marker, as the auto-patches'
regions do (``utils/timing.py``): the forward's on the loss, the
backward's and the optimizer's on the trace's device, so every row is on
the device clock.  While the callback owns a step, the generic
auto-patches (``instrumentation/patches/torch_patches.py``) and the
manual wrappers stand aside: the forward and backward gates and the
compute gate (which the optimizer hooks also read) are raised from batch
start to batch end, so each phase is timed once.  ``setup`` calls
``init(mode="manual")`` on the module's device.  No hook raises into the
loop: a failure is logged to the error log.
"""

from __future__ import annotations

from typing import Any, Optional

from traceml_tpu_torch.sdk.initial import init as traceml_init
from traceml_tpu_torch.sdk.instrumentation import trace_step
from traceml_tpu_torch.sdk.state import get_state
from traceml_tpu_torch.sdk.wrappers import publish_region_marker
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.timing import (
    BACKWARD_TIME,
    FORWARD_TIME,
    OPTIMIZER_STEP,
    timed_region,
)

#: the TLS gates the callback raises while it owns a step
_GATES = ("forward_depth", "backward_depth", "compute_depth")


def _callback_bases():
    bases = []
    for mod in ("lightning.pytorch", "pytorch_lightning"):
        try:
            import importlib

            m = importlib.import_module(mod)
            bases.append(m.Callback)
        except Exception:
            continue
    return tuple(dict.fromkeys(bases))


_cached_callback_cls = None


def _module_device(pl_module: Any) -> Any:
    """The device of the module's first parameter, or None (CUDA)."""
    try:
        return next(pl_module.parameters()).device
    except Exception:
        return None


def make_traceml_callback() -> Any:
    """Build the callback class against the available Lightning base(s);
    raises ImportError when no Lightning flavor is installed."""
    global _cached_callback_cls
    if _cached_callback_cls is not None:
        return _cached_callback_cls
    bases = _callback_bases()
    if not bases:
        raise ImportError("neither `lightning` nor `pytorch_lightning` is installed")

    class TraceMLCallback(*bases):  # type: ignore[misc]
        """Owns the per-phase timing of the Lightning training loop."""

        def __init__(self, auto_init: bool = True) -> None:
            super().__init__()
            self._step_ctx: Optional[trace_step] = None
            self._region: Optional[timed_region] = None
            self._region_phase: Optional[str] = None
            self._auto_init = auto_init
            self._own_gates = False

        # -- lifecycle --------------------------------------------------
        def setup(self, trainer: Any, pl_module: Any, stage: Optional[str] = None) -> None:
            if self._auto_init:
                try:
                    # manual mode: this callback owns forward, backward and
                    # optimizer; the auto-patches would time them twice
                    traceml_init(mode="manual", device=_module_device(pl_module))
                except Exception as exc:
                    get_error_log().warning("lightning init failed", exc)

        def teardown(self, trainer: Any, pl_module: Any, stage: Optional[str] = None) -> None:
            self._close_all()

        # -- region plumbing (never raises into the loop) ----------------
        def _timing_active(self, trainer: Any) -> bool:
            return not bool(getattr(trainer, "sanity_checking", False))

        def _open(self, phase: str) -> None:
            try:
                self._close_region()
                st = get_state()
                self._region = timed_region(phase, st.current_step, sink=st.buffer.add)
                self._region.__enter__()
                self._region_phase = phase
            except Exception as exc:
                get_error_log().warning("lightning region open failed", exc)
                self._region = None
                self._region_phase = None

        def _close_region(self, mark: Any = None, only_phase: Optional[str] = None) -> None:
            region = self._region
            if region is None:
                return
            if only_phase is not None and self._region_phase != only_phase:
                return  # a different phase is open: not ours to close
            self._region = None
            self._region_phase = None
            try:
                st = get_state()
                if st.markers_enabled():
                    region.mark(mark, st.marker_device)
                region.__exit__(None, None, None)
                publish_region_marker(region.event, st)
            except Exception as exc:
                get_error_log().warning("lightning region close failed", exc)

        def _close_all(self) -> None:
            self._close_region()
            if self._step_ctx is not None:
                try:
                    self._step_ctx.__exit__(None, None, None)
                except Exception as exc:
                    get_error_log().warning("lightning step close failed", exc)
                self._step_ctx = None
            if self._own_gates:
                tls = get_state().tls
                for gate in _GATES:
                    setattr(tls, gate, max(0, getattr(tls, gate) - 1))
                self._own_gates = False

        # -- training hooks ----------------------------------------------
        def on_train_batch_start(self, trainer: Any, pl_module: Any, batch: Any, batch_idx: int) -> None:
            if not self._timing_active(trainer):
                return
            try:
                self._close_all()
                self._step_ctx = trace_step()
                self._step_ctx.__enter__()
                # the auto-patches and manual wrappers inside the step
                # defer to this callback
                tls = get_state().tls
                for gate in _GATES:
                    setattr(tls, gate, getattr(tls, gate) + 1)
                self._own_gates = True
                self._open(FORWARD_TIME)
            except Exception as exc:
                get_error_log().warning("lightning batch_start failed", exc)
                self._step_ctx = None

        def on_before_backward(self, trainer: Any, pl_module: Any, loss: Any) -> None:
            if self._step_ctx is None:
                return
            # the forward ends here, whatever hooks fired in between; the
            # loss is its device probe
            self._close_region(mark=loss, only_phase=FORWARD_TIME)
            self._close_region()  # any other leftover region
            self._open(BACKWARD_TIME)

        def on_after_backward(self, trainer: Any, pl_module: Any) -> None:
            if self._step_ctx is None:
                return
            self._close_region(only_phase=BACKWARD_TIME)

        def on_before_optimizer_step(self, trainer: Any, pl_module: Any, optimizer: Any) -> None:
            if self._step_ctx is None:
                return
            self._open(OPTIMIZER_STEP)

        def on_before_zero_grad(self, trainer: Any, pl_module: Any, optimizer: Any) -> None:
            if self._step_ctx is None:
                return
            # under automatic optimization this fires BEFORE backward, with
            # the forward open: close only the optimizer (manual orders)
            self._close_region(only_phase=OPTIMIZER_STEP)

        def on_train_batch_end(self, trainer: Any, pl_module: Any, outputs: Any, batch: Any,
                               batch_idx: int) -> None:
            if self._step_ctx is None:
                return
            try:
                if outputs is not None:
                    self._step_ctx.mark(outputs)
            except Exception:
                pass
            self._close_all()

        def on_train_end(self, trainer: Any, pl_module: Any) -> None:
            self._close_all()

    _cached_callback_cls = TraceMLCallback
    return TraceMLCallback


def TraceMLCallback(*args: Any, **kwargs: Any) -> Any:
    """Instantiate the Lightning callback (convenience factory)."""
    return make_traceml_callback()(*args, **kwargs)
