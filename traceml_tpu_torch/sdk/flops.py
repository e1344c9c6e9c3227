"""Model FLOPs of a training step: the MFU numerator.

Counterpart of ``traceml_tpu/api.py:set_step_flops`` and of
``wrap_step_fn``'s cost-analysis estimate
(``traceml_tpu/sdk/step_fn.py:estimate_flops``).  PyTorch has no lowered
program to ask, so :func:`estimate_step_flops` runs the step once under
``torch.utils.flop_counter.FlopCounterMode`` and declares what it counted:
matmuls, convolutions, and the flash-attention op through the formula it
registers (``ops/flash_attention.py``).  Elementwise work is not counted,
where XLA's cost analysis counts some.  The count runs a real step, so a
script spends a warm-up step on it.

The declaration goes into the trace state; the step-time sampler ships it
as one ``model_stats`` row per change, and the final report divides it by
the step time and by the device's peak (``utils/chip_specs.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from traceml_tpu_torch.sdk.state import TraceState, get_state


def _device_kind(st: TraceState) -> str:
    dev = st.device
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def set_step_flops(flops: float, device_kind: Optional[str] = None,
                   device_count: Optional[int] = None, *, source: str = "manual") -> None:
    """Declare the model FLOPs of ONE training step (forward, backward and
    optimizer) of this process.  ``device_kind`` names the device whose
    peak is the MFU denominator (default: the trace's device,
    ``torch.cuda.get_device_name``); ``device_count`` is how many devices
    the declared work runs on (default 1: a rank drives one card).
    ``source`` says where the count came from."""
    st = get_state()
    st.flops_per_step = float(flops)
    st.flops_source = source
    if device_kind is not None:
        st.flops_device_kind = str(device_kind)
    elif st.flops_device_kind is None:
        st.flops_device_kind = _device_kind(st)
    if device_count is not None:
        st.flops_device_count = int(device_count)
    elif st.flops_device_count is None:
        st.flops_device_count = 1


def estimate_step_flops(fn: Callable, *args: Any, **kwargs: Any) -> float:
    """Run ``fn(*args, **kwargs)`` once (a real step: it updates the
    model) under ``FlopCounterMode``, declare the count with
    :func:`set_step_flops` and return it."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    set_step_flops(flops, source="flop_counter")
    return flops
