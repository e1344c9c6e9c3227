"""Scenario library: each scenario is a small training run with ONE
injected pathology.

Counterpart of ``traceml_tpu/dev/demo/scenarios.py``: every scenario
trains ``TinyMLP(hidden=256, depth=3)`` with Adam on (64, 64) batches,
under ``init(mode="auto")``, ``wrap_step_fn``, ``wrap_dataloader`` and
``trace_step``, with the JAX scenarios' injections and step counts.
Run one alone or under ``run``::

    python -m traceml_tpu_torch.dev.demo.scenarios <name> [steps] [--device cpu]
    python -m traceml_tpu_torch run --nprocs 4 traceml_tpu_torch/dev/demo/scenarios.py \\
        -- input_straggler 60

Scenarios and their expected verdicts:

* ``healthy``           → no injected-fault verdict
* ``input_bound``       → INPUT_BOUND (a 60 ms input delay on every rank)
* ``input_straggler``   → INPUT_STRAGGLER on the last rank (a 0.32 s
  input delay there alone; needs ``--nprocs 4``)
* ``compute_straggler`` → COMPUTE_STRAGGLER: the last rank's step
  function sleeps 0.12 s inside the wrapped call, after its work is
  enqueued and before it returns.  ``wrap_step_fn`` records the compute
  region's CUDA event after the call returns, so the event, and the
  region's device-clock span, ends after the sleep (JAX sleeps in a
  ``pure_callback`` inside the jitted program, to the same effect)
* ``collective_straggler`` → COLLECTIVE_STRAGGLER: each rank's
  "gradient sync" (a host stall, then a local scaling of the weights by
  1/world, no NCCL) runs through ``instrument_collective``; the last
  rank's stall is 0.12 s, the others' 0.02
* ``comm_bound``        → COMM_BOUND (every rank's sync stalls 0.03 s,
  fully exposed)
* ``checkpoint_stall``  → a ``checkpoint`` phase: a real ``torch.save`` of
  the state dict every 5 steps, timed by the auto-patch
* ``memory_creep``      → memory growth: one (256, 1024) f32 tensor on the
  device kept per step, on the module, so the leak outlives the loop
* ``recompile``         → COMPILE_BOUND: the step calls
  ``torch.compile(model, dynamic=False)`` on batches of 17 + (i % 7)
  rows, 7 shapes, under dynamo's recompile limit of 8.  The backend is
  inductor on CUDA and ``aot_eager`` on the CPU (a choice of this script:
  inductor's C++ compiles take seconds a shape there).

The device is CUDA unless asked for the CPU; a rank takes
``cuda:{LOCAL_RANK % device_count}``, so that the 4-rank scenarios run on
one card (a choice of this dev script).  At the end it prints the loss
and ``flash_attention.launches N`` (0: no kernel of the port is on this
path).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
from typing import Iterator, Optional

import numpy as np

NAMES = ("healthy", "input_bound", "input_straggler", "compute_straggler", "collective_straggler",
         "comm_bound", "checkpoint_stall", "memory_creep", "recompile")


def _rank() -> int:
    return int(os.environ.get("RANK", 0))


def _world() -> int:
    return int(os.environ.get("WORLD_SIZE", 1))


def scenario_device(device=None):
    """The rank's device: ``device`` when given, else
    ``cuda:{LOCAL_RANK % device_count}`` (raising without CUDA)."""
    import torch

    from traceml_tpu_torch.utils.device import resolve_device

    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        return resolve_device(None)  # raises DeviceUnavailableError
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0)) % torch.cuda.device_count()}")


def _batches(n: int, delay_s: float = 0.0, delay_rank: Optional[int] = None,
             batch: int = 64) -> Iterator[tuple]:
    rng = np.random.default_rng(_rank())
    for _ in range(n):
        if delay_s and (delay_rank is None or _rank() == delay_rank):
            time.sleep(delay_s)
        x = rng.normal(size=(batch, 64)).astype(np.float32)
        y = rng.normal(size=(batch, 1)).astype(np.float32)
        yield x, y


def _say(line: str) -> None:
    """``line`` and its newline in one write: the ranks share the
    launcher's stdout, and an unbuffered ``print`` writes the two apart."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def run_scenario(name: str, steps: int = 80, device=None) -> None:
    import torch

    import traceml_tpu_torch
    from traceml_tpu_torch.models.mlp import TinyMLP, make_mlp_train_step
    from traceml_tpu_torch.ops import flash_attention
    from traceml_tpu_torch.sdk.state import get_state

    if name not in NAMES:
        raise SystemExit(f"unknown scenario {name!r}; see the module docstring")
    dev = scenario_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    traceml_tpu_torch.init(mode="auto", device=dev)
    model = TinyMLP(hidden=256, depth=3, device=dev)
    if name == "recompile":
        backend = "inductor" if dev.type == "cuda" else "aot_eager"
        init, train_step = make_mlp_train_step(torch.compile(model, dynamic=False, backend=backend))
    else:
        init, train_step = make_mlp_train_step(model)
    init(0)
    step = traceml_tpu_torch.wrap_step_fn(train_step, device=dev)
    world, slow_rank = _world(), _world() - 1
    flash_attention.launches = 0

    def put(x, y):
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    def traced(loader, after=None):
        loss = None
        for i, (x, y) in enumerate(traceml_tpu_torch.wrap_dataloader(loader)):
            with traceml_tpu_torch.trace_step():
                loss = step(*put(x, y))
                if after is not None:
                    after(i)
        return loss

    def scale_weights(stall_s: float):
        def gradient_sync():
            time.sleep(stall_s)
            with torch.no_grad():
                params = [p.mul_(1.0 / max(1, world)) for p in model.parameters()]
            return params

        return traceml_tpu_torch.instrument_collective(gradient_sync, op="all_reduce", group_size=max(1, world))

    if name == "healthy":
        loss = None
        for x, y in traceml_tpu_torch.wrap_dataloader(_batches(steps)):
            with traceml_tpu_torch.trace_step():
                x, y = put(x, y)
                for _ in range(4):  # keep the device busy so compute dominates
                    loss = step(x, y)
    elif name == "input_bound":
        loss = traced(_batches(steps, delay_s=0.06))
    elif name == "input_straggler":
        loss = traced(_batches(steps, delay_s=0.32, delay_rank=slow_rank))
    elif name == "compute_straggler":
        if _rank() == slow_rank:
            def slow_train_step(x, y):
                out = train_step(x, y)
                time.sleep(0.12)
                return out

            step = traceml_tpu_torch.wrap_step_fn(slow_train_step, device=dev)
        loss = traced(_batches(steps))
    elif name == "collective_straggler":
        sync = scale_weights(0.12 if _rank() == slow_rank else 0.02)
        loss = traced(_batches(steps), after=lambda i: sync())
    elif name == "comm_bound":
        sync = scale_weights(0.03)
        loss = traced(_batches(steps), after=lambda i: sync())
    elif name == "checkpoint_stall":
        root = tempfile.mkdtemp(prefix="traceml_ckpt_")
        try:
            def save(i):
                if i % 5 == 4:  # torch.save, timed by the auto-patch
                    torch.save({"model": model.state_dict()}, os.path.join(root, f"step{i}.pt"))

            loss = traced(_batches(steps), after=save)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    elif name == "memory_creep":
        # a real leak outlives the loop, so the forced end-of-run memory
        # sample still sees it: kept on the imported module, which stays in
        # sys.modules when this file runs as a script
        import importlib

        lib = importlib.import_module("traceml_tpu_torch.dev.demo.scenarios")
        leak = lib.__dict__.setdefault("_memory_creep_leak", [])

        def grow(i):
            leak.append(torch.ones((256, 1024), device=dev) * i)  # 1 MiB a step
            time.sleep(0.015)  # a realistic cadence: the sampler needs rows inside the loop

        loss = traced(_batches(steps), after=grow)
    else:  # recompile: ragged batch sizes defeat the compile cache
        loss = None
        for i, (x, y) in enumerate(traceml_tpu_torch.wrap_dataloader(_batches(steps))):
            with traceml_tpu_torch.trace_step():
                ragged = 17 + (i % 7)
                loss = step(*put(x[:ragged], y[:ragged]))
        _say(f"scenario recompile: backend {backend}, {step.compile_count} compile events")
    _say(f"scenario {name} done at step {get_state().current_step}, loss={float(loss):.4f}")
    _say(f"flash_attention.launches {flash_attention.launches}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("name", nargs="?", default="healthy", choices=NAMES)
    parser.add_argument("steps", nargs="?", type=int, default=80)
    parser.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: the rank's CUDA device)")
    args = parser.parse_args(argv)
    run_scenario(args.name, steps=args.steps, device=args.device)


if __name__ == "__main__":
    main()
