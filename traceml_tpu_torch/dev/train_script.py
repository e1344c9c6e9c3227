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
that cannot keep up); ``--delay-x K`` sleeps K times the median host time
of the last 8 steps (the warm-up step's before the first), so the delay
follows the step's own speed on a loaded host; ``--delay-rank R`` puts
either delay on rank R alone (a straggling input pipeline).  Before the
traced loop it collects the set-up's garbage and freezes what survives
(``gc.freeze``), so no full collection stalls the host inside a traced
step.  At the end it prints the loss of the first and the last traced
step, the full (generation 2) collections the loop still ran, and the
flash kernel's launches in the traced loop, ``flash_attention.launches
N``.  Test scaffolding, not features:

* ``--remat`` checkpoints each block (``ModelConfig.remat``);
* ``--h2d to`` copies each batch inside the step with
  ``batch.to(device, non_blocking=True)`` from pinned memory, timed by
  the ``torch_h2d`` auto-patch (the default, ``--h2d dataloader``, copies
  through ``wrap_dataloader(to_device=True)``);
* ``--tokens`` declares the step's tokens, ``set_step_tokens(B * S)``;
* ``--final-summary`` calls ``final_summary()`` after the loop and prints
  ``final_summary {"kind": ..., "n_steps": ...}``;
* ``--kill-after N`` sends the process SIGKILL after N steps, on the rank
  ``--kill-rank`` names (default 0);
* ``--stderr-marker`` prints one line to stderr when the loop has ended,
  ``train_script: stderr marker, loop ended at <unix time>`` (what
  ``--no-capture-stderr`` must keep out of the live display);
* ``--mesh`` joins the default process group (NCCL on CUDA, gloo on the
  CPU; ``MASTER_ADDR`` and ``MASTER_PORT`` from the caller's environment,
  ``RANK`` and ``WORLD_SIZE`` from the launcher's), torn down at exit,
  and builds ``make_mesh()``, whose placement the rank ships once;
* ``--grad-sync all_reduce`` syncs the gradients after each backward
  through ``dev/workload.gradient_sync`` (one ``dist.all_reduce`` of the
  flat f32 gradients, recorded by ``instrument_collective``), ``local``
  times the same sync without the all-reduce; ``--sync-sleep-ms MS``
  slows the sync by MS on the host (every rank, or ``--sync-sleep-rank``
  alone): a fully exposed, slow link;
* ``--mesh-shape fsdp=1,context=1`` builds ``make_mesh`` of that shape
  (implies ``--mesh``); a ``tensor`` axis in it (``tensor=2``, or
  ``tensor=1``, which builds the same layers and skips their
  collectives) makes the model tensor-parallel, each rank holding its
  slices of the weights; ``--attention-impl ring|ulysses`` shards
  attention by sequence over its ``context`` axis (each rank trains on its
  shard of the global batch); ``--fsdp`` shards the parameters and AdamW's
  state with FSDP2 (``init_train_state(mesh=...)``); ``--ici-stats N``
  all-gathers each rank's step stats over the mesh every N steps
  (``enable_ici_stats``) and prints, after the loop, ``stat_gather`` and a
  JSON object: the gathers, the matrix's shape, each gathered row's
  ``[rank, step, step_ms]``, the host ms each gather waited for the
  step's device work and the ms of the collective with its copy to the
  host.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import json
import os
import sys
import time
from typing import List, Optional

import torch
from torch.optim import adamw

import traceml_tpu_torch as tm
from traceml_tpu_torch.dev.workload import (
    BATCH,
    TRAIN_TOKENS,
    build_train_state,
    full_width_config,
    gradient_sync,
    host_batches,
    kill_after,
    paced_batches,
)
from traceml_tpu_torch.models.transformer import ModelConfig, make_train_step
from traceml_tpu_torch.ops.flash_attention import flash_attention
from traceml_tpu_torch.utils.timing import STEP_TIME

TINY_BATCH, TINY_TOKENS = 2, 65
SEED = 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--delay-ms", type=float, default=0.0, help="host sleep before each batch")
    p.add_argument("--delay-rank", type=int, default=-1, help="the rank the delays slow (-1: every rank)")
    p.add_argument("--delay-x", type=float, default=0.0,
                   help="host sleep before each batch, as a multiple of the median of the last 8 steps")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="the 2-layer, 128-wide model on (2, 65) tokens")
    p.add_argument("--remat", action="store_true", help="checkpoint each block")
    p.add_argument("--h2d", choices=("dataloader", "to"), default="dataloader",
                   help="copy batches by wrap_dataloader(to_device=True) or by batch.to() in the step")
    p.add_argument("--tokens", action="store_true", help="declare the step's tokens")
    p.add_argument("--final-summary", action="store_true", help="call final_summary() after the loop")
    p.add_argument("--kill-after", type=int, default=0, help="SIGKILL this process after N steps")
    p.add_argument("--kill-rank", type=int, default=0, help="the rank --kill-after kills")
    p.add_argument("--stderr-marker", action="store_true", help="print one line to stderr after the loop")
    p.add_argument("--mesh", action="store_true", help="join the process group and build make_mesh()")
    p.add_argument("--grad-sync", choices=("none", "all_reduce", "local"), default="none",
                   help="sync the gradients after each backward (an all-reduce, or local only)")
    p.add_argument("--sync-sleep-ms", type=float, default=0.0, help="host sleep inside the gradient sync")
    p.add_argument("--sync-sleep-rank", type=int, default=-1,
                   help="the rank --sync-sleep-ms slows (-1: every rank)")
    p.add_argument("--mesh-shape", default="",
                   help="make_mesh's shape, e.g. fsdp=1,context=1 or tensor=2 (implies --mesh)")
    p.add_argument("--attention-impl", choices=("dense", "ring", "ulysses"), default="dense",
                   help="ring or ulysses shard attention by sequence over the mesh's context axis")
    p.add_argument("--fsdp", action="store_true", help="shard parameters and optimizer state with FSDP2")
    p.add_argument("--ici-stats", type=int, default=0, metavar="N",
                   help="all-gather each rank's step stats over the mesh every N steps")
    args = p.parse_args(argv)
    shape = {k: int(v) for k, v in (kv.split("=") for kv in args.mesh_shape.split(",") if kv)}
    args.mesh = args.mesh or bool(shape) or args.fsdp or args.ici_stats > 0 or args.attention_impl != "dense"

    on_cuda = torch.device(args.device).type == "cuda"
    if args.tiny:
        cfg, batch, n_tokens = ModelConfig.tiny(), TINY_BATCH, TINY_TOKENS
    else:
        cfg, batch, n_tokens = full_width_config(), BATCH, TRAIN_TOKENS
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    rank = int(os.environ.get("RANK", 0))
    distributed = args.mesh or args.grad_sync == "all_reduce"
    if distributed:
        import torch.distributed as dist

        if on_cuda:
            torch.cuda.set_device(torch.device(args.device).index or int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if on_cuda else "gloo", init_method="env://",
                                rank=rank, world_size=int(os.environ.get("WORLD_SIZE", 1)))
        # torn down at exit, after `run` has stopped this rank's runtime: a
        # NCCL shutdown waits up to a second on its watchdog thread, and the
        # idle card the samplers would read meanwhile is not the training's
        atexit.register(dist.destroy_process_group)
        # the first collective sets the communicator up: outside the trace
        dist.all_reduce(torch.zeros(1, device=args.device))
    mesh = None
    if args.mesh:
        mesh = tm.make_mesh(shape or None, device_type=torch.device(args.device).type)
        print(f"train_script: mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
              f"coords {mesh.get_coordinate()}", flush=True)
    # each rank trains on its shard of the global batch; a tensor axis
    # builds the model tensor-parallel, each rank with its slices
    if args.attention_impl != "dense" or args.fsdp or "tensor" in shape:
        cfg = dataclasses.replace(cfg, attention_impl=args.attention_impl, mesh=mesh,
                                  context_axis="context" if args.attention_impl != "dense" else None)
    model, optimizer = build_train_state(cfg, SEED, device=args.device, mesh=mesh if args.fsdp else None)
    # AdamW named through its module: the code manifest's optimizer hints match lowercase names
    assert isinstance(optimizer, adamw.AdamW)
    tm.init(mode="auto", device=args.device, traced_model=model)
    grad_sync = None
    if args.grad_sync != "none":
        slow = args.sync_sleep_rank in (-1, rank)
        grad_sync = gradient_sync(model, args.grad_sync, args.sync_sleep_ms if slow else 0.0)
    train_step = make_train_step(model, optimizer, grad_sync=grad_sync)
    host = host_batches(cfg, SEED + 1, batch=batch, seq=n_tokens, pin=on_cuda)

    # the warm-up step, outside the trace and without the gradient sync,
    # counts the step's model FLOPs
    t0 = time.perf_counter()
    flops = tm.estimate_step_flops(make_train_step(model, optimizer), host[0].to(args.device))
    if on_cuda:
        torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    print(f"train_script: {flops:.6e} model FLOPs per step (FlopCounterMode)", flush=True)
    if args.tokens:
        tm.set_step_tokens(batch * (n_tokens - 1))

    hook = tm.enable_ici_stats(mesh, every_n_steps=args.ici_stats) if args.ici_stats > 0 else None
    flash_attention.launches = 0
    losses = []
    copy_in_step = args.h2d == "to"
    print("train_script: batches copied by "
          + ("Tensor.to in the step" if copy_in_step else "wrap_dataloader(to_device=True)"), flush=True)
    delayed = args.delay_rank in (-1, rank)
    batches = paced_batches(host, args.steps, args.delay_ms if delayed else 0.0,
                            args.delay_x if delayed else 0.0, [warmup_s])
    # collect what the set-up left and freeze the survivors: a full
    # collection over them, falling into the traced loop, would stall the
    # host inside a step, most visibly the first, whose forward the host
    # paces from an idle card
    gc.collect()
    gc.freeze()
    full_collections = gc.get_stats()[2]["collections"]
    t0 = time.perf_counter()
    for i, tokens in enumerate(tm.wrap_dataloader(batches, to_device=not copy_in_step)):
        with tm.trace_step():
            if copy_in_step:
                tokens = tokens.to(args.device, non_blocking=True)
            losses.append(train_step(tokens)["loss"])
        kill_after(i + 1, args.kill_after, args.kill_rank)
    if on_cuda:
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    full_collections = gc.get_stats()[2]["collections"] - full_collections
    if args.stderr_marker:
        print(f"train_script: stderr marker, loop ended at {time.time():.6f}", file=sys.stderr, flush=True)
    first, last = float(losses[0]), float(losses[-1])
    finite = all(bool(torch.isfinite(loss)) for loss in losses)
    print(f"train_script: {args.steps} steps in {wall_s:.4f} s wall; loss first {first:.6f} "
          f"last {last:.6f} finite={finite}; gen-2 collections in the loop {full_collections}", flush=True)
    print(f"flash_attention.launches {flash_attention.launches}", flush=True)
    if hook is not None:
        hook.uninstall()
        rows = [[r, row["step"], row["events"][STEP_TIME]["device_ms"]]
                for r, rank_rows in sorted(hook.rank_rows().items()) for row in rank_rows]
        print("stat_gather " + json.dumps({
            "gathers": hook.gather_count, "shape": list(hook.last_matrix.shape), "rows": rows,
            "wait_ms": hook.wait_ms, "gather_ms": hook.gather_ms,
            "diagnosis": [i.kind for i in hook.diagnose(mode="summary").issues],
        }), flush=True)
    if args.final_summary:
        got = tm.final_summary(timeout=120.0) or {}
        step_time = (got.get("sections") or {}).get("step_time") or {}
        print("final_summary " + json.dumps({
            "kind": (got.get("primary_diagnosis") or {}).get("kind"),
            "n_steps": (step_time.get("global") or {}).get("n_steps"),
        }), flush=True)
    return 0 if finite else 1


if __name__ == "__main__":
    raise SystemExit(main())
