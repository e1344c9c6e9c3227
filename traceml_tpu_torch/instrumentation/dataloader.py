"""Input-pipeline (dataloader) timing.

Counterpart of ``traceml_tpu/instrumentation/dataloader.py``: each
``next()`` of the wrapped iterable is timed as ``dataloader_next`` — the
input-wait phase behind the INPUT_BOUND and INPUT_STRAGGLER diagnoses.
With ``to_device=True`` each batch is also moved with a timed, marked
``.to(device, non_blocking=True)`` (the ``h2d`` phase).  The auto-patch
(``patch_torch_dataloader``, installed by ``init(mode="auto")``) times
``torch.utils.data.DataLoader``'s iterator the same way.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional

from traceml_tpu_torch.sdk.state import TraceState, get_state
from traceml_tpu_torch.sdk.wrappers import timed_to_device
from traceml_tpu_torch.utils.device import resolve_device
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.timing import DATALOADER_NEXT, timed_region

# not the JAX package's flag name, so the two packages' patches never
# take each other's for their own
_PATCHED_FLAG = "_traceml_tpu_torch_patched"


def _timed_batches(it: Iterator[Any], st: TraceState) -> Iterator[Any]:
    """Yield ``it``'s batches, each ``next()`` timed as ``dataloader_next``
    unless an outer wrapper is already timing it."""
    while True:
        if st.tls.dataloader_depth > 0:
            try:
                batch = next(it)
            except StopIteration:
                return
        else:
            st.tls.dataloader_depth += 1
            region = timed_region(DATALOADER_NEXT, st.current_step, sink=None)
            try:
                with region:
                    batch = next(it)
            except StopIteration:
                return
            finally:
                st.tls.dataloader_depth -= 1
            # only real batches are recorded, not the StopIteration probe
            try:
                st.buffer.add(region.event)
            except Exception as exc:
                get_error_log().warning("dataloader event add failed", exc)
        yield batch


class wrap_dataloader:
    """Iterate a dataloader with per-``next()`` input-wait timing.

    Wrapping an already-wrapped iterable returns it unchanged.  With
    ``to_device=True`` the device defaults to the trace's (CUDA); it is
    resolved here, so a missing CUDA raises at wrap time.
    """

    def __new__(cls, iterable: Iterable, *args: Any, **kwargs: Any):
        if isinstance(iterable, wrap_dataloader):
            return iterable
        return super().__new__(cls)

    def __init__(
        self,
        iterable: Iterable,
        *,
        to_device: bool = False,
        device: Any = None,
        state: Optional[TraceState] = None,
    ) -> None:
        if getattr(self, "_init_done", False):
            return
        self._init_done = True
        self._iterable = iterable
        self._state = state or get_state()
        self._device = None
        if to_device:
            self._device = (
                self._state.device if device is None else resolve_device(device)
            )

    def __iter__(self) -> Iterator[Any]:
        st = self._state
        for batch in _timed_batches(iter(self._iterable), st):
            if self._device is not None:
                batch = timed_to_device(batch, self._device, st)
            yield batch

    def __len__(self) -> int:
        return len(self._iterable)  # type: ignore[arg-type]


def patch_torch_dataloader() -> bool:
    """Replace ``torch.utils.data.DataLoader.__iter__`` with a timing
    generator over the original iterator.  Idempotent."""
    from torch.utils.data import DataLoader

    if getattr(DataLoader, _PATCHED_FLAG, False):
        return True
    original_iter = DataLoader.__iter__

    def patched_iter(self):  # noqa: ANN001
        return _timed_batches(original_iter(self), get_state())

    patched_iter._traceml_original = original_iter  # type: ignore[attr-defined]
    DataLoader.__iter__ = patched_iter
    setattr(DataLoader, _PATCHED_FLAG, True)
    return True


def unpatch_torch_dataloader() -> None:
    from torch.utils.data import DataLoader

    if getattr(DataLoader, _PATCHED_FLAG, False):
        DataLoader.__iter__ = DataLoader.__iter__._traceml_original
        setattr(DataLoader, _PATCHED_FLAG, False)
