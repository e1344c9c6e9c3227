"""A user training script for ``python -m traceml_tpu_torch run``.

The traced forward loop of the main path, written the way a user writes
one, with the public API only: ``init``, ``wrap_step_fn``,
``wrap_dataloader`` and ``trace_step``.  By default it runs the
full-width DecoderLM (``dev/workload.py:full_width_config``: vocab 16384,
hidden 1024, 12 layers, 16 heads over 8 kv heads, bf16; random weights
from a numpy seed, loaded through ``params_from_jax``) at B=8, S=1024 on
the card, so every layer's attention goes through the CUDA flash kernel.

    python -m traceml_tpu_torch run --mode summary traceml_tpu_torch/dev/forward_script.py \\
        [-- --delay-ms 60]                      # on the card
    python -m traceml_tpu_torch run --mode summary traceml_tpu_torch/dev/forward_script.py \\
        -- --device cpu --tiny --delay-ms 30    # the 2-layer model on the CPU

``--delay-ms`` sleeps on the host before each batch (an input pipeline
that cannot keep up).  At the end it prints the flash kernel's launches
in the traced loop, ``flash_attention.launches N``.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

import traceml_tpu_torch as tm
from traceml_tpu_torch.dev.workload import BATCH, SEQ, build_model, full_width_config
from traceml_tpu_torch.models.transformer import ModelConfig
from traceml_tpu_torch.ops.flash_attention import flash_attention

TINY_BATCH, TINY_SEQ = 2, 64
WARMUP_STEPS = 3
SEED = 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--delay-ms", type=float, default=0.0, help="host sleep before each batch")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="the 2-layer, 128-wide model at B=2, S=64")
    args = p.parse_args(argv)

    tm.init(mode="auto", device=args.device)
    on_cuda = torch.device(args.device).type == "cuda"
    if args.tiny:
        cfg, batch, seq = ModelConfig.tiny(), TINY_BATCH, TINY_SEQ
    else:
        cfg, batch, seq = full_width_config(), BATCH, SEQ
    model = build_model(cfg, SEED, device=args.device)
    rng = np.random.default_rng(SEED + 1)
    host = []
    for _ in range(4):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int64))
        host.append(tokens.pin_memory() if on_cuda else tokens)

    def forward(tokens):
        with torch.inference_mode():
            return model(tokens)

    for tokens in host[:WARMUP_STEPS]:  # warm-up outside the trace
        forward(tokens.to(args.device))
    if on_cuda:
        torch.cuda.synchronize()

    def batches():
        for i in range(args.steps):
            if args.delay_ms:
                time.sleep(args.delay_ms / 1000.0)
            yield host[i % len(host)]

    step = tm.wrap_step_fn(forward)
    flash_attention.launches = 0
    t0 = time.perf_counter()
    for tokens in tm.wrap_dataloader(batches(), to_device=True):
        with tm.trace_step():
            logits = step(tokens)
    if on_cuda:
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    print(f"forward_script: {args.steps} steps in {wall_s:.4f} s wall; logits "
          f"{tuple(logits.shape)} finite={finite}", flush=True)
    print(f"flash_attention.launches {flash_attention.launches}", flush=True)
    return 0 if finite else 1


if __name__ == "__main__":
    raise SystemExit(main())
