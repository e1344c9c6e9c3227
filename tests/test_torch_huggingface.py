"""The Hugging Face ``Trainer`` callback.

The JAX package's cases (``tests/integrations/test_hf_and_flax.py``, with
stubbed Trainer calls): the callback brackets each optimizer step in one
``trace_step`` and heals a context leaked by an exception between the
hooks.  Added for the port: the Trainer's other ``on_*`` events are
no-ops (the callback does not subclass ``TrainerCallback``: importing
``transformers`` costs seconds), ``on_train_begin`` initialises on the
Trainer's device, and ``TraceMLTrainer`` installs the callback once.
"""

import pytest
pytest.importorskip("torch")  # a checkout without torch still collects

from traceml_tpu_torch.integrations.huggingface import TraceMLTrainer, TraceMLTrainerCallback
from traceml_tpu_torch.sdk import state as state_mod
from traceml_tpu_torch.utils.step_memory import FakeMemoryBackend, StepMemoryTracker
from traceml_tpu_torch.utils.timing import (
    BACKWARD_TIME,
    FORWARD_TIME,
    GLOBAL_STEP_QUEUE,
    STEP_TIME,
    drain_step_memory_rows,
)


@pytest.fixture(autouse=True)
def fresh_state():
    st = state_mod.reset_state_for_tests(device="cpu")
    st.mem_tracker = StepMemoryTracker(FakeMemoryBackend([[]]))
    GLOBAL_STEP_QUEUE.drain()
    drain_step_memory_rows()
    yield st
    state_mod.reset_state_for_tests(device="cpu")
    GLOBAL_STEP_QUEUE.drain()
    drain_step_memory_rows()


def test_hf_callback_brackets_steps(fresh_state):
    cb = TraceMLTrainerCallback(auto_init=False)
    for _ in range(3):
        cb.on_step_begin()
        # ... the trainer's forward, backward, optimizer (grad-accum folds in here) ...
        cb.on_step_end()
    cb.on_train_end()
    assert fresh_state.current_step == 3
    batches = GLOBAL_STEP_QUEUE.drain()
    assert len(batches) == 3
    assert all(any(e.name == STEP_TIME for e in b.events) for b in batches)


def test_hf_callback_self_heals_leaked_context(fresh_state):
    cb = TraceMLTrainerCallback(auto_init=False)
    cb.on_step_begin()
    # an exception in user code: on_step_end never fires; the next begin heals
    cb.on_step_begin()
    cb.on_step_end()
    cb.on_train_end()
    assert fresh_state.current_step == 2
    assert not fresh_state.tls.in_step


def test_other_events_are_no_ops_and_init_takes_the_trainers_device(fresh_state):
    class Args:
        device = "cpu"

    cb = TraceMLTrainerCallback()
    control = object()
    assert cb.on_log(Args(), None, control) is None and cb.on_substep_end() is None
    with pytest.raises(AttributeError):
        cb.not_an_event  # noqa: B018
    assert cb.on_train_begin(Args(), None, control) is control
    assert fresh_state.initialized and fresh_state.device.type == "cpu"
    assert "torch_forward" in fresh_state.patches


def test_trainer_installs_the_callback_once(tmp_path):
    transformers = pytest.importorskip("transformers")
    import torch

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 2)

        def forward(self, x, labels=None):
            logits = self.lin(x)
            loss = torch.nn.functional.cross_entropy(logits, labels)
            return {"loss": loss, "logits": logits}

    data = [{"x": torch.randn(4), "labels": torch.tensor(i % 2)} for i in range(8)]
    args = transformers.TrainingArguments(output_dir=str(tmp_path), max_steps=3, per_device_train_batch_size=2,
                                          report_to=[], use_cpu=True, save_strategy="no", disable_tqdm=True)
    cb = TraceMLTrainerCallback()
    trainer = TraceMLTrainer(model=Tiny(), args=args, train_dataset=data, callbacks=[cb])
    assert [c for c in trainer.callback_handler.callbacks if isinstance(c, TraceMLTrainerCallback)] == [cb]
    trainer.train()
    batches = GLOBAL_STEP_QUEUE.drain()
    assert [b.step for b in batches] == [1, 2, 3]
    names = {e.name for b in batches for e in b.events}
    assert {FORWARD_TIME, BACKWARD_TIME} <= names
