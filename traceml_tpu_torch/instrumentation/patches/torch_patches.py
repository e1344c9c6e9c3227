"""Forward, backward and optimizer auto-timers.

Counterpart of ``traceml_tpu/instrumentation/patches/torch_patches.py``:
``nn.Module.__call__`` (outermost call only, in a step only, optionally
only for the traced model and its DDP ``.module`` / FSDP
``_fsdp_wrapped_module``) is timed as ``forward_time``;
``Tensor.backward`` and ``torch.autograd.backward`` as ``backward_time``;
every ``Optimizer.step`` (global pre/post hooks) as ``optimizer_step``.

Two things differ from the JAX package, whose timers are host-clock:

* each region closes with a CUDA event marker, on the output's device or,
  for ``backward()`` and ``step()`` which return no tensor, on the
  trace's device, and hands it to the step envelope and the resolver, so
  the rows carry device time per phase;
* a patched region that opens while ``wrap_step_fn``'s compute region
  (``tls.compute_depth``) or ``wrap_forward`` / ``wrap_backward`` /
  ``wrap_optimizer`` is timing is not recorded: the work is in that
  region already, and recording it twice would count it twice in the
  step's accounted phases.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from traceml_tpu_torch.sdk.state import TraceState, get_state
from traceml_tpu_torch.sdk.wrappers import publish_region_marker, timed_call
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.timing import (
    BACKWARD_TIME,
    FORWARD_TIME,
    OPTIMIZER_STEP,
    timed_region,
)

_lock = threading.Lock()
_originals: dict = {}
_traced_model_ids: set = set()


def set_traced_model(model: Any) -> None:
    """Restrict forward timing to ``model`` (and the module a DDP or FSDP
    wrapper holds)."""
    ids = {id(model)}
    for attr in ("module", "_fsdp_wrapped_module"):
        inner = getattr(model, attr, None)
        if inner is not None:
            ids.add(id(inner))
    _traced_model_ids.update(ids)


def clear_traced_models() -> None:
    _traced_model_ids.clear()


def _is_target(module: Any) -> bool:
    return not _traced_model_ids or id(module) in _traced_model_ids


def _records(st: TraceState, depth_attr: Optional[str] = None) -> bool:
    """A patched region is recorded in a step, when no compute region and
    no wrapper of the same phase (``depth_attr``) is timing already."""
    tls = st.tls
    if not tls.in_step or tls.compute_depth:
        return False
    return depth_attr is None or not getattr(tls, depth_attr)


def patch_torch_forward() -> bool:
    import torch.nn as nn

    with _lock:
        if "forward" in _originals:
            return True
        original = nn.Module.__call__

        def patched_call(self, *args, **kwargs):  # noqa: ANN001
            st = get_state()
            if not _records(st, "forward_depth") or not _is_target(self):
                return original(self, *args, **kwargs)
            return timed_call(FORWARD_TIME, "forward_depth", original, st, self, *args, **kwargs)

        nn.Module.__call__ = patched_call
        _originals["forward"] = original
    return True


def patch_torch_backward() -> bool:
    import torch

    with _lock:
        if "backward" in _originals:
            return True
        orig_tensor_bwd = torch.Tensor.backward
        orig_autograd_bwd = torch.autograd.backward

        def _timed(fn: Callable, *args, **kwargs):  # noqa: ANN001
            st = get_state()
            if not _records(st, "backward_depth"):
                return fn(*args, **kwargs)
            return timed_call(BACKWARD_TIME, "backward_depth", fn, st, *args, **kwargs)

        def patched_tensor_backward(self, *args, **kwargs):  # noqa: ANN001
            return _timed(orig_tensor_bwd, self, *args, **kwargs)

        def patched_autograd_backward(*args, **kwargs):  # noqa: ANN001
            return _timed(orig_autograd_bwd, *args, **kwargs)

        torch.Tensor.backward = patched_tensor_backward
        torch.autograd.backward = patched_autograd_backward
        _originals["backward"] = (orig_tensor_bwd, orig_autograd_bwd)
    return True


def install_torch_optimizer_hooks() -> bool:
    """Global pre/post ``Optimizer.step`` hooks emitting
    ``optimizer_step``.  Idempotent."""
    from torch.optim.optimizer import (
        register_optimizer_step_post_hook,
        register_optimizer_step_pre_hook,
    )

    with _lock:
        if "optimizer" in _originals:
            return True
        open_regions: dict = {}

        def pre_hook(optimizer, args, kwargs):  # noqa: ANN001
            try:
                st = get_state()
                # an optimizer under wrap_optimizer is timed by it
                if not _records(st) or getattr(optimizer, "_traceml_wrapped", False):
                    return
                region = timed_region(OPTIMIZER_STEP, st.current_step, sink=st.buffer.add)
                region.__enter__()
                open_regions[id(optimizer)] = (region, st)
            except Exception as exc:
                get_error_log().warning("optimizer pre-hook failed", exc)

        def post_hook(optimizer, args, kwargs):  # noqa: ANN001
            try:
                opened = open_regions.pop(id(optimizer), None)
                if opened is None:
                    return
                region, st = opened
                if st.markers_enabled():
                    region.mark(None, st.marker_device)
                region.__exit__(None, None, None)
                publish_region_marker(region.event, st)
            except Exception as exc:
                get_error_log().warning("optimizer post-hook failed", exc)

        h1 = register_optimizer_step_pre_hook(pre_hook)
        h2 = register_optimizer_step_post_hook(post_hook)
        _originals["optimizer"] = (h1, h2)
    return True


def unpatch_all_torch() -> None:
    """Restore ``nn.Module.__call__``, ``Tensor.backward`` and
    ``torch.autograd.backward``, remove the optimizer hooks and the model
    filter."""
    import torch
    import torch.nn as nn

    with _lock:
        if "forward" in _originals:
            nn.Module.__call__ = _originals.pop("forward")
        if "backward" in _originals:
            torch.Tensor.backward, torch.autograd.backward = _originals.pop("backward")
        if "optimizer" in _originals:
            for handle in _originals.pop("optimizer"):
                handle.remove()
    clear_traced_models()
