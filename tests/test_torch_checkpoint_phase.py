"""The ``checkpoint`` phase: ``wrap_checkpoint`` and the checkpoint auto-patch.

Counterpart of the JAX package's ``wrap_checkpoint`` and orbax-patch
tests.  Held here: ``wrap_checkpoint`` and the auto-patched
``torch.save`` each add one ``checkpoint_time`` event, host-timed (no
device marker), to the open step; nested savers (a wrapped saver calling
the patched ``torch.save``, a DCP save calling ``torch.save`` underneath)
are timed once; ``torch.distributed.checkpoint.save`` is patched now when
DCP is imported and after its first import otherwise; ``unpatch``
restores ``torch.save`` and DCP's ``save``; ``init`` applies the patch
under ``patch_checkpoint`` only.
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import pytest
pytest.importorskip("torch")  # a checkout without torch still collects
import torch

import traceml_tpu_torch
from traceml_tpu_torch.instrumentation import checkpoint_patch as cp
from traceml_tpu_torch.sdk import initial
from traceml_tpu_torch.sdk.instrumentation import trace_step
from traceml_tpu_torch.sdk.state import reset_state_for_tests
from traceml_tpu_torch.sdk.wrappers import wrap_checkpoint
from traceml_tpu_torch.utils import timing as T

REPO = Path(__file__).resolve().parent.parent
REAL_SAVE = torch.save


@pytest.fixture(autouse=True)
def fresh_state():
    st = reset_state_for_tests(device="cpu")
    T.GLOBAL_STEP_QUEUE.drain()
    yield st
    reset_state_for_tests(device="cpu")
    T.GLOBAL_STEP_QUEUE.drain()
    assert torch.save is REAL_SAVE


def _checkpoint_events():
    return [e for b in T.GLOBAL_STEP_QUEUE.drain() for e in b.events if e.name == T.CHECKPOINT_TIME]


def test_wrap_checkpoint_times_one_phase():
    saved = []
    save = wrap_checkpoint(lambda obj: saved.append(obj) or "ok")
    assert traceml_tpu_torch.wrap_checkpoint is wrap_checkpoint
    with trace_step():
        assert save({"w": 1}) == "ok"
    (ev,) = _checkpoint_events()
    assert ev.step == 1 and ev.cpu_ms is not None and ev.cpu_ms >= 0 and ev.marker is None
    assert saved == [{"w": 1}]


def test_patched_torch_save_emits_once_and_unpatches():
    initial.init(mode="auto", device="cpu")
    assert "torch_save" in traceml_tpu_torch.sdk.state.get_state().patches
    assert torch.save is not REAL_SAVE
    buf = io.BytesIO()
    with trace_step():
        torch.save({"w": torch.ones(4)}, buf)
    (ev,) = _checkpoint_events()
    assert ev.step == 1 and ev.marker is None
    assert torch.load(io.BytesIO(buf.getvalue()))["w"].sum() == 4
    cp.unpatch_checkpoint()
    assert torch.save is REAL_SAVE


def test_nested_savers_are_timed_once():
    initial.init(mode="auto", device="cpu")

    def my_saver(obj):
        torch.save(obj, io.BytesIO())  # the patched torch.save, nested
        torch.save(obj, io.BytesIO())

    save = wrap_checkpoint(my_saver)
    with trace_step():
        save({"w": torch.zeros(2)})
    assert len(_checkpoint_events()) == 1


def test_patch_checkpoint_false_leaves_torch_save():
    initial.init(mode="auto", device="cpu", patch_checkpoint=False)
    assert torch.save is REAL_SAVE
    assert not any(p.startswith("torch_") and ("save" in p or "dcp" in p)
                   for p in traceml_tpu_torch.sdk.state.get_state().patches)


def test_dcp_save_patched_now_and_timed_once(tmp_path):
    import torch.distributed.checkpoint as dcp

    real_dcp_save = dcp.save
    assert cp.install_checkpoint_patch() == "patched"
    assert dcp.save is not real_dcp_save and getattr(dcp.save, "_traceml_wrapped", False)
    with trace_step():
        # one process, no process group: DCP saves without collectives
        dcp.save({"w": torch.arange(6.0)}, checkpoint_id=str(tmp_path / "ckpt"))
    assert len(_checkpoint_events()) == 1
    cp.unpatch_checkpoint()
    assert dcp.save is real_dcp_save and torch.save is REAL_SAVE


def test_dcp_patched_at_first_import():
    """In a process that has not imported DCP, ``init`` arms a hook that
    patches it right after the import, and does not import it itself."""
    code = (
        "import sys, torch\n"
        "from traceml_tpu_torch.sdk import initial\n"
        "from traceml_tpu_torch.sdk.state import get_state\n"
        "initial.init(mode='auto', device='cpu')\n"
        "print('before', 'torch.distributed.checkpoint' in sys.modules, get_state().patches)\n"
        "import torch.distributed.checkpoint as dcp\n"
        "print('after', getattr(dcp.save, '_traceml_wrapped', False))\n"
        "initial.shutdown_patches()\n"
        "print('restored', not getattr(dcp.save, '_traceml_wrapped', False))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "before False" in out.stdout and "'torch_save', 'torch_dcp[deferred]'" in out.stdout
    assert "after True" in out.stdout and "restored True" in out.stdout
