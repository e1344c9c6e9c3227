"""Peak FLOP/s per device, the MFU denominator.

Counterpart of ``traceml_tpu/utils/chip_specs.py``, for NVIDIA cards.
The figures are dense bf16 tensor-core rates without the 2× sparsity
figure, from NVIDIA's "NVIDIA H100 Tensor Core GPU" datasheet: H100 SXM
989.4 TFLOP/s, H100 PCIe 756 TFLOP/s.  A card held below its full power
limit runs below them; the ratio is still taken against the published
peak.
"""

from __future__ import annotations

from typing import Optional

# substring match against torch.cuda.get_device_name (e.g. "NVIDIA H100
# 80GB HBM3" on the SXM part, "NVIDIA H100 PCIe"); more specific first
_PEAK_BF16_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),
)


def peak_flops_for(device_kind: Optional[str]) -> Optional[float]:
    """Peak dense-bf16 FLOP/s of a device, or None when unknown (the CPU,
    unrecognised names): callers then report achieved FLOP/s without an
    MFU ratio rather than invent a denominator."""
    if not device_kind:
        return None
    kind = device_kind.lower()
    for needle, peak in _PEAK_BF16_FLOPS:
        if needle in kind:
            return peak
    return None
