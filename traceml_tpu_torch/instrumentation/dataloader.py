"""Input-pipeline (dataloader) timing.

Counterpart of ``traceml_tpu/instrumentation/dataloader.py``: each
``next()`` of the wrapped iterable is timed as ``dataloader_next`` — the
input-wait phase behind the INPUT_BOUND and INPUT_STRAGGLER diagnoses.
With ``to_device=True`` each batch is also moved with a timed, marked
``.to(device, non_blocking=True)`` (the ``h2d`` phase).
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional

from traceml_tpu_torch.sdk.state import TraceState, get_state
from traceml_tpu_torch.sdk.wrappers import timed_to_device
from traceml_tpu_torch.utils.device import resolve_device
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.timing import DATALOADER_NEXT, timed_region


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
        it = iter(self._iterable)
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
            if self._device is not None:
                batch = timed_to_device(batch, self._device, st)
            yield batch

    def __len__(self) -> int:
        return len(self._iterable)  # type: ignore[arg-type]
