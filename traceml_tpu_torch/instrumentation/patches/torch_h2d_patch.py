"""Host→device copy auto-timer: ``Tensor.to`` and ``Tensor.cuda``.

Counterpart of ``traceml_tpu/instrumentation/patches/jax_h2d_patch.py``,
which patches ``jax.device_put`` and names the reference's ``Tensor.to``
patch as its model.  A copy is timed as an ``h2d`` phase when every gate
holds; the wrapper reads them in this order, because it sits on every
``.to`` of the model (about 220 casts a forward step, 440 a train step
with ``remat``) and almost all of them fail the first two:

* inside a ``trace_step`` (``tls.in_step``),
* outermost only (``tls.h2d_depth``, shared with ``wrap_h2d`` and
  ``wrap_dataloader(to_device=True)``, which raise it around their own
  timed copy),
* the source is not on a CUDA device: a cast of a CUDA tensor or a D2D
  copy passes through,
* not while dynamo traces, nor under a FakeTensor mode (dynamo breaks
  its graph on a read of ``is_cpu``, so this check comes before it),
* the source is a plain tensor on the CPU: a FakeTensor, another tensor
  subclass or a meta tensor passes through,
* the destination is a CUDA device: a dtype-only cast, a no-op ``.to``
  or a copy to the CPU passes through.

The timed copy closes with a CUDA event on the output's device, handed to
the step envelope and the resolver by ``publish_region_marker``, as the
other patches do.  A copy from pinned memory with ``non_blocking=True``
is enqueued on the current stream, so the event marks its end on the
device.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from traceml_tpu_torch.sdk import state as _state_mod
from traceml_tpu_torch.sdk.wrappers import publish_region_marker
from traceml_tpu_torch.utils.timing import H2D_TIME, timed_region

_lock = threading.Lock()
_originals: dict = {}


def _tracing() -> bool:
    """Dynamo is tracing, or a FakeTensor mode is active."""
    import torch

    if torch.compiler.is_compiling():
        return True
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


def _destination(args: tuple, kwargs: dict) -> Optional[Any]:
    """The device a ``Tensor.to`` call names, or None."""
    import torch

    try:
        return torch._C._nn._parse_to(*args, **kwargs)[0]
    except Exception:  # let the original raise on arguments it refuses
        return None


def _timed_copy(original: Callable, tensor: Any, args: tuple, kwargs: dict, st: Any) -> Any:
    tls = st.tls
    tls.h2d_depth += 1
    try:
        region = timed_region(H2D_TIME, st.current_step, sink=st.buffer.add)
        with region as tr:
            out = original(tensor, *args, **kwargs)
            if st.markers_enabled():
                tr.mark(out)
        publish_region_marker(region.event, st)
        return out
    finally:
        tls.h2d_depth -= 1


def patch_torch_h2d() -> bool:
    """Replace ``torch.Tensor.to`` and ``torch.Tensor.cuda`` with timing
    wrappers.  Idempotent."""
    import torch

    with _lock:
        if "h2d" in _originals:
            return True
        orig_to, orig_cuda = torch.Tensor.to, torch.Tensor.cuda
        plain = torch.Tensor

        def patched_to(self, *args, **kwargs):  # noqa: ANN001
            st = _state_mod._state
            tls = st.tls
            if not tls.in_step or tls.h2d_depth or self.is_cuda or _tracing() or not self.is_cpu \
                    or type(self) is not plain:
                return orig_to(self, *args, **kwargs)
            dst = _destination(args, kwargs)
            if dst is None or dst.type != "cuda":
                return orig_to(self, *args, **kwargs)
            return _timed_copy(orig_to, self, args, kwargs, st)

        def patched_cuda(self, *args, **kwargs):  # noqa: ANN001
            st = _state_mod._state
            tls = st.tls
            if not tls.in_step or tls.h2d_depth or self.is_cuda or _tracing() or not self.is_cpu \
                    or type(self) is not plain:
                return orig_cuda(self, *args, **kwargs)
            return _timed_copy(orig_cuda, self, args, kwargs, st)

        # the methods live on TensorBase; unpatching deletes the
        # overrides unless torch.Tensor defined its own
        own = {name: torch.Tensor.__dict__.get(name) for name in ("to", "cuda")}
        torch.Tensor.to = patched_to
        torch.Tensor.cuda = patched_cuda
        _originals["h2d"] = own
    return True


def unpatch_torch_h2d() -> None:
    """Restore ``torch.Tensor.to`` and ``torch.Tensor.cuda``."""
    import torch

    with _lock:
        if "h2d" not in _originals:
            return
        for name, own in _originals.pop("h2d").items():
            if own is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, own)
