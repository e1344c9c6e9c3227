"""Device resolution shared by every entry point that touches a device.

The port runs on CUDA unless the caller asks for the CPU.  With no CUDA and
no explicit CPU request it raises; it never silently uses the CPU.
"""

from __future__ import annotations

from typing import Any, Optional

import torch


class DeviceUnavailableError(RuntimeError):
    pass


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """``None`` means CUDA.  Returns a ``torch.device`` of type cuda or cpu."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
