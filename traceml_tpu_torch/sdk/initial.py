"""``init``/``start`` — patch policy and the trace's device.

Counterpart of ``traceml_tpu/sdk/initial.py``.  Modes:

* ``auto``      — apply every applicable patch,
* ``manual``    — none; the user calls the wrappers,
* ``selective`` — explicit per-patch booleans.

This slice has no auto-patches yet (the torch forward, backward,
optimizer and dataloader patches come later), so every mode records
``patches=[]``.  ``device`` sets the trace's device: CUDA by default,
raising without CUDA; ``device="cpu"`` runs on the CPU.

Idempotent; a re-``init`` with a *conflicting* mode raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from traceml_tpu_torch.sdk.state import get_state
from traceml_tpu_torch.utils.error_log import get_error_log

VALID_MODES = ("auto", "manual", "selective")


@dataclasses.dataclass(frozen=True)
class TraceMLInitConfig:
    mode: str = "auto"
    patch_dataloader: bool = True
    patch_forward: bool = True
    patch_backward: bool = True
    patch_optimizer: bool = True
    patch_h2d: bool = True
    patch_checkpoint: bool = True


class TraceMLInitError(RuntimeError):
    pass


def init(mode: str = "auto", device: Any = None, **kwargs) -> TraceMLInitConfig:
    """Apply the requested patch policy on the given device.  Safe to
    call more than once with the same mode; a conflicting re-init raises."""
    if mode not in VALID_MODES:
        raise TraceMLInitError(f"mode must be one of {VALID_MODES}, got {mode!r}")
    st = get_state()
    if st.initialized:
        if st.patch_mode != mode:
            raise TraceMLInitError(
                f"traceml already initialized with mode={st.patch_mode!r}; "
                f"re-init with mode={mode!r} conflicts"
            )
        return TraceMLInitConfig(mode=mode, **kwargs)
    cfg = TraceMLInitConfig(mode=mode, **kwargs)
    st.set_device(device)
    st.patches = []
    st.initialized = True
    st.patch_mode = mode
    get_error_log().info(f"traceml init mode={mode} device={st.device} patches={st.patches}")
    return cfg


# alias (the reference exposes both init and start)
start = init
