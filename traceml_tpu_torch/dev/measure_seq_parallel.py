"""Host and device cost of the sharded train step's routes on one card.

    python3 -m traceml_tpu_torch.dev.measure_seq_parallel   # on the card

In one process, over a one-rank NCCL group with ``make_mesh({fsdp: 1,
context: 1})``, the full-width AdamW step (``dev/workload.py``) through
each route: dense (the flash kernel), Ulysses attention (which skips its
all-to-alls on a one-rank group), FSDP2 (``init_train_state(mesh=)``),
and Ulysses with FSDP2 (the route of ``chip_smoke.py``'s sharded run).
For each: the step's time (``cuda_ms``: 8 steps after 3 warm-ups, so a
step the host cannot enqueue as fast as the card runs it reads the
host's time) and, under ``torch.profiler`` (CPU only) over 2 steps, the
host's self CPU ms a step and the five ops that take the most of it.
Then what the skipped Ulysses exchanges would cost through NCCL
(:func:`ulysses_exchange_cost`, which ``chip_smoke.py`` reports too),
and the collectives ``patch_dist_collectives`` records in one FSDP2 step
(:func:`fsdp_collectives_seen`).  Prints one ``[seq_parallel]`` line a route, the card's ``nvidia-smi``
line and a JSON object of all numbers last.  Needs CUDA; exits 2
without it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict

import torch


def _nccl_group() -> None:
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)


def ulysses_exchange_cost(mesh, iters: int = 20) -> Dict[str, Any]:
    """What the Ulysses path skips on a one-rank group: ``seq_to_heads``
    then ``heads_to_seq`` of one (8, 1024, 16, 64) bf16 activation through
    NCCL's ``all_to_all_single`` on the context group, and their
    gradients (four all-to-alls, each with its permute copy).  Host ms
    of the calls' enqueue (no sync inside the loop) and device ms
    (``cuda_ms``), each per all-to-all; a full-width step would run 96
    (q, k, v and the output, forward and backward, 12 layers)."""
    from traceml_tpu_torch.dev.workload import BATCH, SEQ, cuda_ms
    from traceml_tpu_torch.ops.ulysses_attention import heads_to_seq, seq_to_heads

    group = mesh.get_group("context")
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((BATCH, SEQ, 16, 64), generator=gen, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    g = torch.randn_like(x)

    def exchange() -> None:
        heads_to_seq(seq_to_heads(x, group, 1), group, 1).backward(g)

    exchange()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        exchange()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters / 4
    torch.cuda.synchronize()
    return {"host_ms_per_all_to_all": host_ms, "device_ms_per_all_to_all": cuda_ms(exchange, iters) / 4,
            "all_to_alls_per_step": 96}


def fsdp_collectives_seen(cfg, mesh, tokens) -> Dict[str, int]:
    """The collectives ``patch_dist_collectives`` records in one FSDP2
    train step, by op (it wraps the eager ``torch.distributed`` entry
    points by name; whether FSDP2 calls those depends on the torch
    version).  Installs the patch for the rest of the process: run last."""
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.dev.workload import build_train_state
    from traceml_tpu_torch.instrumentation.collectives import GLOBAL_COLLECTIVES_QUEUE
    from traceml_tpu_torch.models.transformer import make_train_step

    tm.patch_dist_collectives()
    model, optimizer = build_train_state(cfg, 0, mesh=mesh)
    step = make_train_step(model, optimizer)
    GLOBAL_COLLECTIVES_QUEUE.drain()
    step(tokens)
    torch.cuda.synchronize()
    ops: Dict[str, int] = {}
    for rec in GLOBAL_COLLECTIVES_QUEUE.drain():
        ops[rec["op"]] = ops.get(rec["op"], 0) + 1
    del model, optimizer, step
    torch.cuda.empty_cache()
    return ops


def measure_route(cfg, mesh, tokens) -> Dict[str, Any]:
    from torch.profiler import ProfilerActivity, profile

    from traceml_tpu_torch.dev.workload import build_train_state, cuda_ms
    from traceml_tpu_torch.models.transformer import make_train_step

    model, optimizer = build_train_state(cfg, 0, mesh=mesh)
    step = make_train_step(model, optimizer)
    step_ms = cuda_ms(lambda: step(tokens), 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step(tokens)
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    out = {"step_ms": step_ms,
           "profiled_self_cpu_ms_per_step": sum(e.self_cpu_time_total for e in events) / 2e3,
           "top_self_cpu_ms_per_step": [[e.key, e.self_cpu_time_total / 2e3] for e in events[:5]]}
    del model, optimizer, step
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("measure_seq_parallel: CUDA is not available", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from traceml_tpu_torch.dev.workload import TRAIN_TOKENS, full_width_config, host_batches
    from traceml_tpu_torch.parallel.mesh import make_mesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = full_width_config()
    tokens = host_batches(cfg, 1, seq=TRAIN_TOKENS)[0].cuda()
    _nccl_group()
    try:
        mesh = make_mesh({"fsdp": 1, "context": 1}, device_type="cuda")
        ulysses = dataclasses.replace(cfg, attention_impl="ulysses", context_axis="context", mesh=mesh)
        results = {}
        for name, route_cfg, route_mesh in (("dense", cfg, None), ("ulysses", ulysses, None),
                                            ("fsdp", cfg, mesh), ("ulysses_fsdp", ulysses, mesh)):
            results[name] = measure_route(route_cfg, route_mesh, tokens)
            print(f"[seq_parallel] {name}: " + json.dumps(results[name]), flush=True)
        results["ulysses_exchange"] = ulysses_exchange_cost(mesh)
        results["fsdp_collectives_seen_by_patch"] = fsdp_collectives_seen(cfg, mesh, tokens)
        print("[seq_parallel] " + json.dumps({k: results[k] for k in ("ulysses_exchange",
                                                                       "fsdp_collectives_seen_by_patch")}), flush=True)
    finally:
        dist.destroy_process_group()
    print(smi, flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": smi, **results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
