"""Checkpoint auto-timer: ``torch.save`` and ``torch.distributed.checkpoint.save``.

Counterpart of ``traceml_tpu/instrumentation/orbax_patch.py``, which
wraps orbax's save entry points.  A blocking save gates every
synchronous step, and without a phase its time lands in ``residual``.
Both savers are wrapped in the first-class ``checkpoint`` phase, timed
on the host clock, through the ``checkpoint_depth`` gate that
``wrap_checkpoint`` shares: a DCP save that calls ``torch.save``
underneath is timed once, as the outer save.  ``torch.save`` is patched
at once (the port has imported torch); DCP is patched now when
``torch.distributed.checkpoint`` is imported already, else right after
its first import (``post_import.arm``), so that tracing started before
the script's imports still sees it.  ``init(mode="auto")`` applies this
under ``patch_checkpoint``; ``unpatch_checkpoint`` restores both.
"""

from __future__ import annotations

import functools
from typing import Any, List, Optional, Tuple

from traceml_tpu_torch.instrumentation.post_import import PostImportHook, arm
from traceml_tpu_torch.sdk.state import get_state
from traceml_tpu_torch.sdk.wrappers import host_timed_call
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.timing import CHECKPOINT_TIME

DCP = "torch.distributed.checkpoint"

_patched: List[Tuple[Any, str, Any]] = []  # (owner, attribute, original) for unpatch
_hook: Optional[PostImportHook] = None


def _wrap(owner: Any, attr: str) -> bool:
    save = getattr(owner, attr, None)
    if save is None or getattr(save, "_traceml_wrapped", False):
        return False

    @functools.wraps(save)
    def timed_save(*args: Any, **kwargs: Any):
        # the state is read at each call: a test may have replaced it
        return host_timed_call(CHECKPOINT_TIME, "checkpoint_depth", save, get_state(), *args, **kwargs)

    timed_save._traceml_wrapped = True  # type: ignore[attr-defined]
    setattr(owner, attr, timed_save)
    _patched.append((owner, attr, save))
    return True


def patch_torch_save() -> bool:
    """Wrap ``torch.save``.  Idempotent."""
    import torch

    _wrap(torch, "save")
    return True


def patch_dcp() -> bool:
    """Wrap ``torch.distributed.checkpoint.save``; False when DCP is not
    imported.  Idempotent."""
    import sys

    module = sys.modules.get(DCP)
    if module is None:
        return False
    try:
        _wrap(module, "save")
        return True
    except Exception as exc:  # never break checkpointing
        get_error_log().warning("torch.distributed.checkpoint patch failed", exc)
        return False


def _dcp_importable() -> bool:
    import torch.distributed as dist

    return dist.is_available()


def install_checkpoint_patch() -> str:
    """Patch ``torch.save``, and DCP now or after its first import.
    Returns DCP's outcome: "patched" | "deferred" | "noop"."""
    global _hook
    patch_torch_save()
    outcome, _hook = arm(DCP, patch_dcp, _hook, _dcp_importable)
    return outcome


def unpatch_checkpoint() -> None:
    """Restore every wrapped saver and remove a pending hook."""
    global _hook
    while _patched:
        owner, attr, save = _patched.pop()
        try:
            setattr(owner, attr, save)
        except Exception:
            pass
    if _hook is not None:
        _hook.remove()
        _hook = None
