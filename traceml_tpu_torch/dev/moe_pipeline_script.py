"""Expert-parallel MoE and pipeline-parallel training, traced: a user
script for ``python -m traceml_tpu_torch run``.

The port's counterpart of ``examples/distributed/moe_pipeline.py``.  The
rank joins the default process group (NCCL on CUDA, gloo on the CPU;
``MASTER_ADDR`` and ``MASTER_PORT`` from the caller's environment,
``RANK`` and ``WORLD_SIZE`` from the launcher's) and trains, one after
the other, each step under ``trace_step`` through ``wrap_step_fn``:

* the MoE block (``models/moe.py``) on ``make_mesh({"expert": world})``,
  ``make_moe_train_step`` (Adam, lr 1e-3, MSE + 0.01 · aux) on x and
  y = x rolled by one on the hidden dim.  By default at the full-width
  DecoderLM's widths (hidden 1024, ffn 2816) with 8 experts, x (8, 1024,
  1024) f32; ``--tiny``: 4 experts, hidden 32, ffn 64, x (8, 16, 32);
* the pipeline (``parallel/pipeline.py``) on ``make_mesh({"stage":
  world})``, one ``linear_stage_apply`` stage a rank,
  ``make_pipeline_train_step`` (SGD, lr 0.05) on 4 microbatches with
  y = 0.5 x: width 1024, microbatches (8, 1024); ``--tiny``: width 16,
  microbatches (8, 16).

Weights and data come from numpy seeds.  ``--steps`` steps each (the
MoE's are steps 1 to N, the pipeline's N + 1 to 2N); ``--delay-ms``
sleeps on the host before each step.  Both workloads share the run's
session, and a session's report holds one model FLOP count a step, so
neither wrapper counts FLOPs (``estimate_flops=False``): the report has
no MFU rather than the MoE's FLOPs over the pipeline's steps.  It prints
each workload's loop and set-up seconds and first and last loss, and
the flash kernel's launches, ``flash_attention.launches N`` (0: no
kernel of the port's is on these paths).

    python -m traceml_tpu_torch run --mode summary traceml_tpu_torch/dev/moe_pipeline_script.py
    python -m traceml_tpu_torch run --mode summary --nprocs 2 traceml_tpu_torch/dev/moe_pipeline_script.py \\
        -- --device cpu --tiny
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

import traceml_tpu_torch as tm
from traceml_tpu_torch.models.moe import init_expert_parallel, make_moe_train_step
from traceml_tpu_torch.ops.flash_attention import flash_attention
from traceml_tpu_torch.parallel.pipeline import (
    init_linear_stages,
    linear_stage_apply,
    make_pipeline_train_step,
    shard_stage_params,
    stack_stage_params,
)

SEED = 0
N_MICRO = 4
#: (n_experts, hidden, ffn_hidden, x shape), (stage width, microbatch shape)
FULL = {"moe": (8, 1024, 2816, (8, 1024, 1024)), "pipeline": (1024, (N_MICRO, 8, 1024))}
TINY = {"moe": (4, 32, 64, (8, 16, 32)), "pipeline": (16, (N_MICRO, 8, 16))}


def _loop(step: Callable[[], dict], steps: int, delay_ms: float) -> Tuple[List[float], float]:
    """``steps`` traced steps of ``step`` (wrapped by ``wrap_step_fn``):
    the losses, read after the loop, and the loop's wall seconds."""
    wrapped = tm.wrap_step_fn(step, estimate_flops=False)
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        if delay_ms > 0:
            time.sleep(delay_ms / 1e3)
        with tm.trace_step():
            losses.append(wrapped()["loss"])
    losses = [float(loss) for loss in losses]
    return losses, time.perf_counter() - t0


def run_moe(device: str, sizes, steps: int, delay_ms: float) -> Tuple[List[float], float]:
    mesh = tm.make_mesh({"expert": int(os.environ.get("WORLD_SIZE", 1))}, device_type=torch.device(device).type)
    n_experts, hidden, ffn_hidden, x_shape = sizes
    block = init_expert_parallel(n_experts, hidden, ffn_hidden, mesh, device=device, seed=SEED)["model"]
    _, train_step = make_moe_train_step(block)
    rng = np.random.default_rng(SEED + 1)
    x = torch.from_numpy(rng.standard_normal(x_shape, dtype=np.float32)).to(device)
    y = torch.roll(x, 1, dims=-1)
    return _loop(lambda: train_step(x, y), steps, delay_ms)


def run_pipeline(device: str, sizes, steps: int, delay_ms: float) -> Tuple[List[float], float]:
    n_stages = int(os.environ.get("WORLD_SIZE", 1))
    mesh = tm.make_mesh({"stage": n_stages}, device_type=torch.device(device).type)
    width, micro_shape = sizes
    stacked = shard_stage_params(stack_stage_params(init_linear_stages(n_stages, width, SEED, device=device)), mesh)
    init, train_step = make_pipeline_train_step(linear_stage_apply, mesh, N_MICRO, learning_rate=0.05)
    optimizer = init(stacked)
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.standard_normal(micro_shape, dtype=np.float32)).to(device)
    y = 0.5 * x
    return _loop(lambda: train_step(stacked, optimizer, x, y), steps, delay_ms)


def _say(line: str) -> None:
    """``line`` and its newline in one write: the ranks share the
    launcher's stdout, and an unbuffered ``print`` writes the two apart,
    so two ranks' lines could land on one."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30, help="steps of each workload")
    p.add_argument("--delay-ms", type=float, default=0.0, help="host sleep before each step")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="small widths, for the CPU")
    args = p.parse_args(argv)

    import torch.distributed as dist

    on_cuda = torch.device(args.device).type == "cuda"
    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    if on_cuda:
        torch.cuda.set_device(torch.device(args.device).index or int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if on_cuda else "gloo", init_method="env://", rank=rank, world_size=world)
    # the first collective sets the communicator up: outside the trace
    dist.all_reduce(torch.zeros(1, device=args.device))
    tm.init(mode="auto", device=args.device)
    sizes = TINY if args.tiny else FULL
    flash_attention.launches = 0
    ok = True
    for name, run in (("moe", run_moe), ("pipeline", run_pipeline)):
        t0 = time.perf_counter()
        losses, loop_s = run(args.device, sizes[name], args.steps, args.delay_ms)
        finite = all(np.isfinite(losses))
        ok = ok and finite
        _say(f"moe_pipeline_script: {name} over {world} rank(s): {args.steps} steps in {loop_s:.4f} s wall "
             f"(set-up {time.perf_counter() - t0 - loop_s:.4f} s); loss first {losses[0]:.6f} "
             f"last {losses[-1]:.6f} finite={finite}")
    _say(f"flash_attention.launches {flash_attention.launches}")
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
