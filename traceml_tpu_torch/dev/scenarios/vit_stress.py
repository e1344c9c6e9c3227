"""ViT training stress scenario.

Counterpart of ``traceml_tpu/dev/scenarios/vit_stress.py``, at its
config: 32×32×3 images, patch 8, hidden 128, 3 layers, 4 heads, 10
classes, bf16 compute, batches of 16, AdamW (``make_vit_train_step``),
under ``init(mode="auto")``, ``wrap_step_fn``, ``wrap_dataloader`` and
``trace_step``::

    python -m traceml_tpu_torch.dev.scenarios.vit_stress [steps] [fault] [--device cpu]
    python -m traceml_tpu_torch run traceml_tpu_torch/dev/scenarios/vit_stress.py -- 60 input_bound

faults: ``none`` | ``input_bound`` (a 50 ms sleep before each batch) |
``memory_creep`` (a (128, 1024) f32 tensor on the device kept per step).
The device is CUDA unless ``--device`` asks for another.  At the end it
prints the loss and ``flash_attention.launches N`` (0: the ViT's
attention is the einsum reference, as in JAX).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

FAULTS = ("none", "input_bound", "memory_creep")


def main(steps: int = 60, fault: str = "none", device=None) -> None:
    import torch

    import traceml_tpu_torch
    from traceml_tpu_torch.models.vit import ViT, ViTConfig, make_vit_train_step
    from traceml_tpu_torch.ops import flash_attention
    from traceml_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    traceml_tpu_torch.init(mode="auto", device=dev)
    cfg = ViTConfig(image_size=32, patch_size=8, hidden=128, n_layers=3, n_heads=4, n_classes=10)
    model = ViT(cfg, device=dev)
    init, train_step = make_vit_train_step(model)
    init(0)
    rng = np.random.default_rng(0)
    step = traceml_tpu_torch.wrap_step_fn(train_step, device=dev)
    flash_attention.launches = 0

    def batches():
        for _ in range(steps):
            if fault == "input_bound":
                time.sleep(0.05)
            images = rng.normal(size=(16, cfg.image_size, cfg.image_size, 3))
            labels = rng.integers(0, cfg.n_classes, (16,))
            yield images.astype(np.float32), labels.astype(np.int64)

    leak = []
    metrics = {"loss": float("nan")}
    for images, labels in traceml_tpu_torch.wrap_dataloader(batches()):
        with traceml_tpu_torch.trace_step():
            images = torch.from_numpy(images).to(dev)
            labels = torch.from_numpy(labels).to(dev)
            metrics = step(images, labels)
            if fault == "memory_creep":
                leak.append(torch.ones((128, 1024), device=dev))
    print(f"vit stress done ({fault}), loss={float(metrics['loss']):.4f}", flush=True)
    print(f"flash_attention.launches {flash_attention.launches}", flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("steps", nargs="?", type=int, default=60)
    parser.add_argument("fault", nargs="?", default="none", choices=FAULTS)
    parser.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: CUDA)")
    args = parser.parse_args()
    main(steps=args.steps, fault=args.fault, device=args.device)
