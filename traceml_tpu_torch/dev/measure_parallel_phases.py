"""What ``chip_smoke.py``'s in-process parallel phases leave in the process,
and what the pipeline's train step costs, on one card.

    python3 -m traceml_tpu_torch.dev.measure_parallel_phases [--variant NAME=PATH ...] [--no-gate]

Run from the root of a checkout (it imports ``chip_smoke``).

1. The pipeline's SGD step on ``make_mesh({stage: 1})`` in a one-rank
   NCCL group, at ``chip_smoke.py``'s size (one ``linear_stage_apply``
   stage of width 1024, 4 microbatches of (8, 1024)): the host ms a step
   over 100 steps with one sync after them, ``cuda_ms`` of 5 steps (the
   host queues them behind a ~10 ms spin of the card, so a step whose
   host work outlasts it reads the host's pace, and a step that waits for
   the card reads the card's), the loss, and a ``torch.profiler`` table
   (CPU and CUDA) of 10 steps.  Measured for this checkout's
   ``parallel/pipeline.py`` and for each ``--variant`` (another version
   of the module, e.g. from ``git show <rev>:traceml_tpu_torch/parallel/
   pipeline.py``), interleaved twice in ABBA order.
2. Unless ``--no-gate``: the sharded run of ``chip_smoke.py``
   (``train_seq_parallel``, gated at 1.10x a healthy run's step) after a
   healthy train run, then ``chip_smoke.py``'s in-process phases
   (``seq_parallel_train_phase``, ``parallel_workloads_phase``) and the
   ``moe_pipeline`` run, then a healthy run and the sharded run again.
   Before and after each, ``chip_smoke.process_state``: the OS threads
   and the CPU they use idle, the affinity, the children, a live process
   group.  A failed gate is recorded, not raised.

Prints one ``PIPELINE``, ``PROFILE`` (its table's last lines give the
kernels' total), ``STATE`` and ``RATIO`` line each, the card's
``nvidia-smi`` line and a JSON object of all numbers last; writes the
profiler tables under ``traceml_logs/measure_parallel_phases/``.  Needs
CUDA; exits 2 without it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List

import torch

REPO = Path(__file__).resolve().parents[2]
STEPS_HOST, STEPS_PROFILED = 100, 10


def _pipeline_modules(variants: List[str]) -> Dict[str, Any]:
    import traceml_tpu_torch.parallel.pipeline as current

    mods = {"current": current}
    for item in variants:
        name, path = item.split("=", 1)
        spec = importlib.util.spec_from_file_location(f"pipeline_{name}", path)
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    return mods


def pipeline_costs(cs, mods: Dict[str, Any], out_dir: Path) -> Dict[str, Any]:
    from traceml_tpu_torch.dev.workload import cuda_ms
    from traceml_tpu_torch.parallel.mesh import make_mesh

    gen = torch.Generator().manual_seed(cs.SEED + 4)
    x = torch.randn(cs.PIPELINE_MICRO, generator=gen).cuda()
    y = 0.5 * x
    costs: Dict[str, Any] = {name: [] for name in mods}
    with cs.one_rank_nccl_group():
        mesh = make_mesh({"stage": 1}, device_type="cuda")

        def build(mod) -> Callable[[], Dict[str, torch.Tensor]]:
            stacked = mod.stack_stage_params(mod.init_linear_stages(1, cs.PIPELINE_WIDTH, cs.SEED))
            params = mod.shard_stage_params(stacked, mesh)
            init, step = mod.make_pipeline_train_step(mod.linear_stage_apply, mesh, x.shape[0], learning_rate=0.05)
            optimizer = init(params)
            return lambda: step(params, optimizer, x, y)

        order = list(mods) + list(reversed(mods))
        for name in order + order:
            fn = build(mods[name])
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEPS_HOST):
                out = fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / STEPS_HOST * 1e3
            costs[name].append({"host_ms": host_ms, "cuda_ms": cuda_ms(fn, 5), "loss": out["loss"].item()})
        from torch.profiler import ProfilerActivity, profile

        for name, mod in mods.items():
            fn = build(mod)
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(STEPS_PROFILED):
                    fn()
                torch.cuda.synchronize()
            events = prof.key_averages()
            table = events.table(sort_by="self_cpu_time_total", row_limit=22)
            (out_dir / f"pipeline_profile_{name}.txt").write_text(table)
            launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
            costs[name + "_profile"] = {
                "self_cpu_ms_a_step": sum(e.self_cpu_time_total for e in events) / 1e3 / STEPS_PROFILED,
                "launches_a_step": launches / STEPS_PROFILED,
                "sgd_step_cpu_ms": next((e.cpu_time_total / e.count / 1e3 for e in events
                                         if e.key.startswith("Optimizer.step")), None)}
            print(f"PROFILE {name} " + json.dumps(costs[name + "_profile"]) + "\n" + table, flush=True)
    print("PIPELINE " + json.dumps(costs), flush=True)
    return costs


def gate_sequence(cs, cfg) -> Dict[str, Any]:
    states, ratios = [], []

    def state(tag: str) -> None:
        states.append({"tag": tag, **cs.process_state(2.0)})
        print("STATE " + json.dumps(states[-1]), flush=True)

    def gate(tag: str) -> None:
        run = cs.launch_run(f"{tag}_healthy", 0.0, 0.1, script="train_script.py")
        healthy = cs.check_train_run(f"{tag}_healthy", run, cfg, cs.mfu_verdict)
        try:
            ratio: Any = cs.seq_parallel_run_phase(cfg, healthy)["step_ratio"]
        except cs.CheckFailed as exc:
            ratio = str(exc)
        ratios.append({"tag": tag, "healthy_ms": healthy["steady_state_ms"], "ratio": ratio})
        print("RATIO " + json.dumps(ratios[-1]), flush=True)

    state("start")
    gate("before")
    state("after the first gate")
    cs.seq_parallel_train_phase(cfg)
    torch.cuda.empty_cache()
    state("after seq_parallel_train_phase")
    cs.parallel_workloads_phase(cfg)
    state("after parallel_workloads_phase")
    cs.moe_pipeline_run_phase()
    state("after moe_pipeline_run_phase")
    gate("after")
    state("end")
    return {"states": states, "ratios": ratios}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=PATH",
                    help="another version of parallel/pipeline.py to measure beside this checkout's")
    ap.add_argument("--no-gate", action="store_true", help="only the pipeline's costs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_parallel_phases: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from traceml_tpu_torch.dev.workload import full_width_config
    from traceml_tpu_torch.ops import _build

    out_dir = REPO / "traceml_logs" / "measure_parallel_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    _build.build(_build.kernel_sources())
    cs.build_native()
    result: Dict[str, Any] = {"pipeline": pipeline_costs(cs, _pipeline_modules(args.variant), out_dir)}
    if not args.no_gate:
        result["gate"] = gate_sequence(cs, full_width_config())
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
