"""A user training script for ``python -m traceml_tpu_torch run``.

The DecoderLM train step of the main path (next-token loss, backward,
AdamW with lr 3e-4 and weight decay 0.01), written the way a user writes
one, with the public API only: ``init(mode="auto")`` times the forward,
the backward and the optimizer step by its patches, ``wrap_dataloader``
times the input and the copy to the device, ``trace_step`` brackets each
step, and one warm-up step is counted by ``estimate_step_flops`` for the
report's MFU.  By default it trains the full-width DecoderLM
(``dev/workload.py:full_width_config``: vocab 16384, hidden 1024, 12
layers, 16 heads over 8 kv heads, bf16 compute, f32 parameters; random
weights from a numpy seed) on (8, 1025) token batches, so the model sees
S=1024 and every layer's attention goes through the CUDA flash kernel.

    python -m traceml_tpu_torch run --mode summary traceml_tpu_torch/dev/train_script.py \\
        [-- --delay-ms 200]                     # on the card
    python -m traceml_tpu_torch run --mode summary traceml_tpu_torch/dev/train_script.py \\
        -- --device cpu --tiny --delay-ms 30    # the 2-layer model on the CPU

``--delay-ms`` sleeps on the host before each batch (an input pipeline
that cannot keep up).  At the end it prints the loss of the first and the
last traced step and the flash kernel's launches in the traced loop,
``flash_attention.launches N``.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

import traceml_tpu_torch as tm
from traceml_tpu_torch.dev.workload import BATCH, TRAIN_TOKENS, build_train_state, full_width_config, host_batches
from traceml_tpu_torch.models.transformer import ModelConfig, make_train_step
from traceml_tpu_torch.ops.flash_attention import flash_attention

TINY_BATCH, TINY_TOKENS = 2, 65
SEED = 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--delay-ms", type=float, default=0.0, help="host sleep before each batch")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="the 2-layer, 128-wide model on (2, 65) tokens")
    args = p.parse_args(argv)

    on_cuda = torch.device(args.device).type == "cuda"
    if args.tiny:
        cfg, batch, n_tokens = ModelConfig.tiny(), TINY_BATCH, TINY_TOKENS
    else:
        cfg, batch, n_tokens = full_width_config(), BATCH, TRAIN_TOKENS
    model, optimizer = build_train_state(cfg, SEED, device=args.device)
    tm.init(mode="auto", device=args.device, traced_model=model)
    train_step = make_train_step(model, optimizer)
    host = host_batches(cfg, SEED + 1, batch=batch, seq=n_tokens, pin=on_cuda)

    # the warm-up step, outside the trace, counts the step's model FLOPs
    flops = tm.estimate_step_flops(train_step, host[0].to(args.device))
    if on_cuda:
        torch.cuda.synchronize()
    print(f"train_script: {flops:.6e} model FLOPs per step (FlopCounterMode)", flush=True)

    def batches():
        for i in range(args.steps):
            if args.delay_ms:
                time.sleep(args.delay_ms / 1000.0)
            yield host[i % len(host)]

    flash_attention.launches = 0
    losses = []
    t0 = time.perf_counter()
    for tokens in tm.wrap_dataloader(batches(), to_device=True):
        with tm.trace_step():
            losses.append(train_step(tokens)["loss"])
    if on_cuda:
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    first, last = float(losses[0]), float(losses[-1])
    finite = all(bool(torch.isfinite(loss)) for loss in losses)
    print(f"train_script: {args.steps} steps in {wall_s:.4f} s wall; loss first {first:.6f} "
          f"last {last:.6f} finite={finite}", flush=True)
    print(f"flash_attention.launches {flash_attention.launches}", flush=True)
    return 0 if finite else 1


if __name__ == "__main__":
    raise SystemExit(main())
