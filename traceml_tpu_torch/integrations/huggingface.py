"""Hugging Face ``Trainer`` integration.

Counterpart of ``traceml_tpu/integrations/huggingface.py``.
``TraceMLTrainerCallback`` is a pure bracket: ``on_step_begin`` opens a
``trace_step``, ``on_step_end`` closes it.  Gradient-accumulation
micro-batches fold into ONE traced step, because the Trainer fires step
begin and end once per optimizer step.  Self-healing: a context leaked
by an exception between the callbacks is closed before the next opens.
The auto-patches time the forward, backward and optimizer inside it.

``on_train_begin`` calls ``init(mode="auto")`` on the Trainer's device
(``TrainingArguments.device``: CUDA, or the CPU under ``use_cpu=True``).  ``transformers`` is imported
lazily, by ``TraceMLTrainer`` alone (its import costs seconds): the
callback does not subclass ``TrainerCallback`` but answers every other
``on_*`` event the Trainer fires with a no-op, as that base class does.
"""

from __future__ import annotations

from typing import Any, Optional

from traceml_tpu_torch.sdk.initial import init as traceml_init
from traceml_tpu_torch.sdk.instrumentation import trace_step
from traceml_tpu_torch.utils.error_log import get_error_log


def _no_op(args: Any = None, state: Any = None, control: Any = None, **kw: Any) -> None:
    return None


class TraceMLTrainerCallback:
    """Attach to ``Trainer(callbacks=[TraceMLTrainerCallback()])``."""

    def __init__(self, auto_init: bool = True) -> None:
        self._ctx: Optional[trace_step] = None
        self._auto_init = auto_init

    def __getattr__(self, name: str) -> Any:
        # the Trainer's other events (on_init_end, on_log, on_save, ...)
        if name.startswith("on_"):
            return _no_op
        raise AttributeError(name)

    # -- hooks ---------------------------------------------------------
    def on_train_begin(self, args: Any = None, state: Any = None, control: Any = None, **kw: Any):
        if self._auto_init:
            try:
                traceml_init(mode="auto", device=getattr(args, "device", None))
            except Exception as exc:
                get_error_log().warning("hf callback init failed", exc)
        return control

    def on_step_begin(self, args: Any = None, state: Any = None, control: Any = None, **kw: Any):
        try:
            if self._ctx is not None:
                # self-heal a leaked context
                self._ctx.__exit__(None, None, None)
            self._ctx = trace_step()
            self._ctx.__enter__()
        except Exception as exc:
            get_error_log().warning("hf on_step_begin failed", exc)
            self._ctx = None
        return control

    def on_step_end(self, args: Any = None, state: Any = None, control: Any = None, **kw: Any):
        self._close("on_step_end")
        return control

    def on_train_end(self, args: Any = None, state: Any = None, control: Any = None, **kw: Any):
        self._close("on_train_end")
        return control

    def _close(self, hook: str) -> None:
        try:
            if self._ctx is not None:
                self._ctx.__exit__(None, None, None)
                self._ctx = None
        except Exception as exc:
            get_error_log().warning(f"hf {hook} failed", exc)


def TraceMLTrainer(*args: Any, **kwargs: Any):
    """A ``Trainer`` with the callback installed; ``ImportError`` without
    ``transformers``."""
    from transformers import Trainer

    class _TraceMLTrainer(Trainer):
        def __init__(self, *a: Any, **kw: Any) -> None:
            callbacks = list(kw.pop("callbacks", None) or [])
            if not any(isinstance(c, TraceMLTrainerCallback) for c in callbacks):
                callbacks.append(TraceMLTrainerCallback())
            super().__init__(*a, callbacks=callbacks, **kw)

    return _TraceMLTrainer(*args, **kwargs)
