"""On-card measurements of the main path, beyond ``chip_smoke.py``'s checks.

    python3 -m traceml_tpu_torch.dev.measure_main_path     # one CUDA card

1. Tracer overhead: the full-width forward loop untraced and traced
   (``init``, runtime, ``wrap_dataloader``, ``trace_step``,
   ``wrap_step_fn``), in turns untraced, traced, traced without the
   ``torch_h2d`` patch, traced without it, traced, untraced; wall time
   per step on the host clock, each run ending in a synchronize (the
   traced runs' ``wrap_step_fn`` counts no FLOPs: that one-off first
   call is timed on its own, ``[flops_count]``).  Then the ``torch_h2d``
   patch alone on the untraced forward with the in-step gate held open,
   off and on in turns (host enqueue per forward and wall per step); the
   ``Tensor.to`` calls one traced step makes (forward, and train step
   with and without remat), and the patched wrapper's host cost of one
   in-step cast of a CUDA tensor against the unpatched method's.
2. Where the device time goes: ``torch.profiler`` over a few traced
   steps, CUDA kernel time by kernel name, and its share of the same
   steps' wall time.  Beside it, the host's side of a step: the time to
   enqueue one untraced forward on an idle card.  The larger of the two
   sets the step's pace.
3. Attention across sequence lengths: the flash kernel, the einsum
   reference and ``scaled_dot_product_attention`` (a yardstick only) at
   B·S = 8192 tokens and a width of 1024 (16 heads of 64, the main path's,
   and 8 heads of 128), bf16, timed with CUDA events.
4. The full-width train step (B=8, 1025 tokens, AdamW): the tracer's
   overhead (untraced, with no patch installed, against traced under
   ``init(mode="auto")``'s patches, with and without ``torch_h2d``,
   ``wrap_dataloader`` and ``trace_step``, in turns), and where its device
   time goes (``torch.profiler`` over a few traced steps, by kernel group,
   and the device time of the kernels launched under the plain attention
   backward, ``traceml_tpu_torch::flash_attention_backward``).
5. The overhead governor: three traced forward loops and three traced
   train loops, reading the governor after each step (the steps whose
   device markers it skipped, its stride and probe-cost EMA).
6. The samplers' cost on the rank: a traced forward loop (300 steps) and
   a traced train loop (60 steps) with the runtime ticking every 0.1 s,
   the wall time of each sampler's ``sample()`` per tick (system: psutil
   and NVML; process: psutil and the allocator; step time; step memory),
   which includes the tick thread's waits for the GIL while the training
   thread holds it; then the system and process samplers alone, called
   from the main thread with nothing else running, and whether the
   host's ``/proc/stat`` advances while the main thread spins (psutil's
   host CPU % reads it).
7. Remat: the untraced train step with each block checkpointed against
   the step without, in turns: device time a step (CUDA events) and the
   step's peak allocated memory; then the remat step traced under a
   runtime ticking every 0.1 s (``[sampler_cost] remat train``): its
   recompute runs Python on autograd's thread, beside the samplers.

8. The live display's cost to the host-paced forward (``--only cli``):
   ``dev/forward_script.py`` under ``python -m traceml_tpu_torch run``
   (300 steps, 0.1 s tick) with no live display (``--mode summary``),
   with it on a pipe (Rich holds the frames and prints the last) and on a
   terminal (``TTY_COMPATIBLE=1``, 120 columns: Rich redraws the frame 4
   times a second), in turns A B C C B A; each run's step device median
   and mean from its stored rows, its wall time and the bytes the
   launcher printed.
9. The forward's host margin (``--only host_margin``): the kernels a
   forward of the forward loop launches, and a forward, a backward and an
   optimizer step of the train step (``torch.profiler``, CUDA kernel
   events, each attributed to the innermost module, to RoPE or, in the
   backward, to the autograd node that launched it), each phase's host
   enqueue on an idle card beside its kernel time; the untraced train
   step's device and wall ms; the flash wrapper's host µs a call, its
   device ms beside ``scaled_dot_product_attention``'s and the TMA map
   cache's counts; and the plain-op routes against their older forms on
   the card (RMSNorm as ``F.rms_norm`` against the eight-op form, RoPE
   against negate-and-concatenate, ``Dense``'s kept cast against
   ``.to``).  Run it against another checkout of the package by putting
   that checkout first on ``PYTHONPATH`` and this file by its path: the
   ``[env]`` line names the package measured.

Each untraced run first removes the auto-patches, each traced run
installs them, so the untraced runs pay nothing of the tracer.

Prints one JSON line per measurement.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time

import torch

STEPS = 60
PROFILED_STEPS = 5
SEED = 0


def _untraced_ms(model, batches, steps: int, keep_patches: bool = False) -> float:
    from traceml_tpu_torch.sdk.initial import shutdown_patches

    if not keep_patches:
        shutdown_patches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i in range(steps):
            model(batches[i % len(batches)].to("cuda", non_blocking=True))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def _init_traced(patch_h2d: bool) -> None:
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.sdk.initial import shutdown_patches

    shutdown_patches()
    tm.init(mode="auto", patch_h2d=patch_h2d)


def _traced_ms(model, batches, steps: int, patch_h2d: bool = True) -> float:
    import traceml_tpu_torch as tm

    def forward(tokens):
        with torch.inference_mode():
            return model(tokens)

    _init_traced(patch_h2d)
    tm.start_runtime()
    step = tm.wrap_step_fn(forward, estimate_flops=False)
    source = (batches[i % len(batches)] for i in range(steps))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tokens in tm.wrap_dataloader(source, to_device=True):
        with tm.trace_step():
            step(tokens)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    tm.stop_runtime()
    return ms


_GROUPS = (
    ("flash_attention_fwd", re.compile(r"flash_fwd_(wgmma|simt)_kernel")),
    ("gemm", re.compile(r"gemm|gemv|cutlass|nvjet|xmma|cublas", re.I)),
    ("elementwise_and_reductions",
     re.compile(r"elementwise|reduce|vectorized|softmax|index|cat|copy|fill|multi_tensor", re.I)),
)


def _host_enqueue_ms(model, batches, steps: int) -> list:
    """Host time to enqueue each of ``steps`` untraced forwards, each on an
    idle card (synchronized before and after), so the launch queue never
    fills and the time is the host's alone."""
    from traceml_tpu_torch.sdk.initial import shutdown_patches

    shutdown_patches()
    times = []
    with torch.inference_mode():
        for i in range(steps):
            tokens = batches[i % len(batches)].to("cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(tokens)
            times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
    return times


def _untraced_train_ms(step, batches, steps: int) -> float:
    from traceml_tpu_torch.sdk.initial import shutdown_patches

    shutdown_patches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(batches[i % len(batches)].to("cuda", non_blocking=True))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def _traced_train_ms(step, batches, steps: int, patch_h2d: bool = True) -> float:
    import traceml_tpu_torch as tm

    _init_traced(patch_h2d)
    tm.start_runtime()
    source = (batches[i % len(batches)] for i in range(steps))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tokens in tm.wrap_dataloader(source, to_device=True):
        with tm.trace_step():
            step(tokens)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    tm.stop_runtime()
    return ms


def _governor_trace(make_step, batches, steps: int) -> dict:
    """One traced loop of ``make_step()``'s step under ``init(mode="auto")``,
    reading the overhead governor after each step: which steps it left
    without device markers, its largest marker stride and probe-cost
    EMA; and the spread of the poll batches' minimum probe times that
    fed it (wall clock)."""
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.sdk.state import get_state
    from traceml_tpu_torch.utils.overhead_governor import get_governor

    tm.init(mode="auto")
    tm.start_runtime()
    step = make_step()
    gov = get_governor()
    skipped, strides, probes, batch_minima = [], [], [], []
    feed = gov.observe_probe_min

    def observe_probe_min(best_s: float) -> None:
        batch_minima.append(best_s)
        feed(best_s)

    gov.observe_probe_min = observe_probe_min
    source = (batches[i % len(batches)] for i in range(steps))
    for i, tokens in enumerate(tm.wrap_dataloader(source, to_device=True)):
        with tm.trace_step():
            if not get_state().sample_markers:
                skipped.append(i + 1)
            step(tokens)
        strides.append(gov.marker_stride)
        probes.append(gov.probe_cost_ema)
    torch.cuda.synchronize()
    tm.stop_runtime()
    del gov.observe_probe_min
    minima = sorted(batch_minima)

    def pct(q: float) -> float:
        return minima[min(len(minima) - 1, int(q * len(minima)))] * 1e6

    return {"skipped_steps": skipped, "max_stride": max(strides),
            "probe_ema_us_median": statistics.median(probes) * 1e6, "probe_ema_us_max": max(probes) * 1e6,
            "step_ema_ms": gov.step_ema * 1e3, "poll_batches": len(minima),
            "batch_min_us_p50_p90_p99_max": [pct(0.5), pct(0.9), pct(0.99), minima[-1] * 1e6],
            "batch_min_over_100us": sum(1 for x in minima if x > 100e-6)}


def _sampler_cost(make_step, batches, steps: int) -> dict:
    """One traced loop under a runtime ticking every 0.1 s, timing each
    sampler's ``sample()`` per tick (``dev/workload.time_samplers``)."""
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.dev.workload import sampler_cost_summary, time_samplers
    from traceml_tpu_torch.runtime.settings import TraceMLSettings

    tm.init(mode="auto")
    rt = tm.start_runtime(TraceMLSettings(sampler_interval_sec=0.1))
    costs = time_samplers(rt.samplers)
    step = make_step()
    source = (batches[i % len(batches)] for i in range(steps))
    t0 = time.perf_counter()
    for tokens in tm.wrap_dataloader(source, to_device=True):
        with tm.trace_step():
            step(tokens)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    tm.stop_runtime()
    return {"steps": steps, "wall_ms_per_step": wall_ms, **sampler_cost_summary(costs),
            "alone_us_per_call": _samplers_alone()}


def _samplers_alone(calls: int = 200) -> dict:
    """The system and process samplers' ``sample()`` from the main thread
    with no training running: their own cost, without GIL waits."""
    from traceml_tpu_torch.samplers.process_sampler import ProcessSampler
    from traceml_tpu_torch.samplers.system_sampler import SystemSampler

    out = {}
    for sampler in (SystemSampler(), ProcessSampler()):
        sampler.sample()  # NVML handles, the allocator backend
        t0 = time.perf_counter()
        for _ in range(calls):
            sampler.sample()
        out[sampler.name] = (time.perf_counter() - t0) / calls * 1e6
    return out


def _proc_stat_advances(spin_s: float = 0.5) -> dict:
    """The host's CPU times before and after ``spin_s`` of a busy main
    thread, and psutil's host CPU % over that spin."""
    import psutil

    before = psutil.cpu_times()
    psutil.cpu_percent(interval=None)
    end = time.perf_counter() + spin_s
    while time.perf_counter() < end:
        pass
    return {"cpu_percent": psutil.cpu_percent(interval=None), "cpu_times_before": before._asdict(),
            "cpu_times_after": psutil.cpu_times()._asdict()}


def _overhead(runs) -> dict:
    mean = {name: statistics.mean(ms for n, ms in runs if n == name) for name, _ in runs}
    out = {"runs_ms_per_step": runs, "untraced_ms": mean["untraced"], "traced_ms": mean["traced"],
           "overhead_pct": (mean["traced"] / mean["untraced"] - 1.0) * 100.0}
    if "traced_no_h2d" in mean:
        out["traced_no_h2d_ms"] = mean["traced_no_h2d"]
        out["overhead_no_h2d_pct"] = (mean["traced_no_h2d"] / mean["untraced"] - 1.0) * 100.0
        out["h2d_patch_pct"] = (mean["traced"] / mean["traced_no_h2d"] - 1.0) * 100.0
    return out


def _h2d_patch_ab(model, batches, steps: int, turns: int = 4) -> dict:
    """The ``torch_h2d`` patch alone on the untraced full-width forward,
    with the trace's in-step gate held open (``tls.in_step``) so that each
    of the model's casts takes the path it takes in a traced step: host
    ms to enqueue one forward on an idle card (median of ``steps``) and
    wall ms per step of ``steps`` back-to-back forwards, patch off and on
    in turns (off, on, on, off, ...)."""
    from traceml_tpu_torch.instrumentation.patches.torch_h2d_patch import patch_torch_h2d, unpatch_torch_h2d
    from traceml_tpu_torch.sdk.initial import shutdown_patches
    from traceml_tpu_torch.sdk.state import get_state

    shutdown_patches()
    device_batches = [b.to("cuda") for b in batches]
    tls = get_state().tls
    out = {"off": {"enqueue_ms_median": [], "wall_ms": []}, "on": {"enqueue_ms_median": [], "wall_ms": []}}
    for turn in range(turns):
        for on in ((False, True) if turn % 2 == 0 else (True, False)):
            if on:
                patch_torch_h2d()
            tls.in_step = True
            try:
                with torch.inference_mode():
                    enqueue = []
                    for i in range(steps):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        model(device_batches[i % len(device_batches)])
                        enqueue.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for i in range(steps):
                        model(device_batches[i % len(device_batches)])
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) / steps * 1e3
            finally:
                tls.in_step = False
                unpatch_torch_h2d()
            key = "on" if on else "off"
            out[key]["enqueue_ms_median"].append(statistics.median(enqueue))
            out[key]["wall_ms"].append(wall)
    for v in out.values():
        v["enqueue_ms_mean_of_medians"] = statistics.mean(v["enqueue_ms_median"])
        v["wall_ms_mean"] = statistics.mean(v["wall_ms"])
    out["enqueue_pct"] = (out["on"]["enqueue_ms_mean_of_medians"] / out["off"]["enqueue_ms_mean_of_medians"]
                          - 1.0) * 100.0
    out["wall_pct"] = (out["on"]["wall_ms_mean"] / out["off"]["wall_ms_mean"] - 1.0) * 100.0
    return out


def _h2d_patch_variants(model, batches, steps: int) -> dict:
    """Wall ms per step of the traced forward loop (``_traced_ms``'s) and of
    the untraced one with only the forward patch installed, each with no
    ``Tensor.to`` patch, with ``torch_h2d``, and with a bare Python
    pass-through over ``Tensor.to`` (what any Python-level patch of the
    method costs), in the order A B C C B A."""
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.instrumentation.patches.torch_patches import patch_torch_forward
    from traceml_tpu_torch.sdk.initial import shutdown_patches

    base = torch.Tensor.to

    def passthrough(self, *args, **kwargs):  # noqa: ANN001
        return base(self, *args, **kwargs)

    def traced(variant: str) -> float:
        if variant == "passthrough":
            _init_traced(False)
            torch.Tensor.to = passthrough
        else:
            _init_traced(variant == "torch_h2d")
        try:
            tm.start_runtime()
            step = tm.wrap_step_fn(lambda t: _inference(model, t), estimate_flops=False)
            source = (batches[i % len(batches)] for i in range(steps))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for tokens in tm.wrap_dataloader(source, to_device=True):
                with tm.trace_step():
                    step(tokens)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / steps * 1e3
            tm.stop_runtime()
            return ms
        finally:
            if variant == "passthrough":
                del torch.Tensor.to

    def untraced(variant: str) -> float:
        from traceml_tpu_torch.instrumentation.patches.torch_h2d_patch import patch_torch_h2d

        shutdown_patches()
        if variant == "passthrough":
            torch.Tensor.to = passthrough
        elif variant == "torch_h2d":
            patch_torch_h2d()
        patch_torch_forward()
        try:
            return _untraced_ms(model, batches, steps, keep_patches=True)
        finally:
            shutdown_patches()
            if variant == "passthrough":
                del torch.Tensor.to

    order = ("none", "torch_h2d", "passthrough", "passthrough", "torch_h2d", "none")
    out = {}
    for name, run in (("traced", traced), ("untraced_forward_patch", untraced)):
        runs = [(v, run(v)) for v in order]
        out[name] = {"runs_ms_per_step": runs,
                     **{v: statistics.mean(ms for n, ms in runs if n == v) for v in order[:3]}}
    return out


def _inference(model, tokens):
    with torch.inference_mode():
        return model(tokens)


def _flops_count_ms(model, batches) -> dict:
    """Host ms of ``wrap_step_fn``'s first in-step call, which runs under
    ``FlopCounterMode``, against its second call (each synchronized)."""
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.sdk.state import get_state

    def forward(tokens):
        with torch.inference_mode():
            return model(tokens)

    st = get_state()
    st.flops_per_step = None
    _init_traced(True)
    step = tm.wrap_step_fn(forward)
    tokens = batches[0].to("cuda")
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        with tm.trace_step():
            t0 = time.perf_counter()
            step(tokens)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return {"first_call_ms": times[0], "second_call_ms": times[1], "flops_per_step": st.flops_per_step,
            "flops_source": st.flops_source}


def _to_calls_per_step(run_step) -> int:
    """``Tensor.to`` calls in one ``run_step()`` inside a ``trace_step``,
    counted by a wrapper over the installed method."""
    import traceml_tpu_torch as tm

    calls = [0]
    installed = torch.Tensor.to

    def counting(self, *args, **kwargs):  # noqa: ANN001
        calls[0] += 1
        return installed(self, *args, **kwargs)

    torch.Tensor.to = counting
    try:
        with tm.trace_step():
            run_step()
        torch.cuda.synchronize()
    finally:
        torch.Tensor.to = installed
    return calls[0]


def _to_call_host_ns(calls: int = 20000) -> dict:
    """Host cost of one in-step ``x.to(torch.bfloat16)`` of a small CUDA
    bf16 tensor (a no-op cast, as most of the model's are), with the
    ``torch_h2d`` patch installed and without it."""
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.sdk.state import get_state

    x = torch.zeros(8, device="cuda", dtype=torch.bfloat16)
    out = {}
    for patched in (False, True, True, False):
        _init_traced(patched)
        with tm.trace_step():
            assert get_state().tls.in_step
            t0 = time.perf_counter()
            for _ in range(calls):
                x.to(torch.bfloat16)
            ns = (time.perf_counter() - t0) / calls * 1e9
        out.setdefault("patched" if patched else "unpatched", []).append(ns)
    torch.cuda.synchronize()
    return {k: statistics.mean(v) for k, v in out.items()} | {"runs": out}


def _remat_compare(cfg, batches, steps: int = 20) -> dict:
    """The untraced train step with and without remat, in turns: device
    ms a step (CUDA events over ``steps`` steps) and the peak allocated
    bytes of one step."""
    import dataclasses

    from traceml_tpu_torch.dev.workload import build_train_state, cuda_ms
    from traceml_tpu_torch.models.transformer import make_train_step
    from traceml_tpu_torch.sdk.initial import shutdown_patches

    shutdown_patches()
    tokens = batches[0].to("cuda")
    out = {}
    for remat in (False, True, True, False):
        model, optimizer = build_train_state(dataclasses.replace(cfg, remat=remat), SEED)
        step = make_train_step(model, optimizer)
        ms = cuda_ms(lambda: step(tokens), steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(tokens)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        key = "remat" if remat else "no_remat"
        out.setdefault(key, {"step_ms": [], "peak_bytes": [], "resident_bytes": []})
        out[key]["step_ms"].append(ms)
        out[key]["peak_bytes"].append(peak)
        out[key]["resident_bytes"].append(base)
        del model, optimizer, step
        torch.cuda.empty_cache()
    for v in out.values():
        v["step_ms_mean"] = statistics.mean(v["step_ms"])
    out["step_ms_ratio"] = out["remat"]["step_ms_mean"] / out["no_remat"]["step_ms_mean"]
    return out


def _cli_display_cost(steps: int = 300) -> dict:
    """Item 8: the forward script under ``run`` in the three display
    variants, in turns; per variant, one entry a run."""
    import os
    import shutil
    import sqlite3
    from pathlib import Path

    from traceml_tpu_torch.utils import timing as T

    repo = Path(__file__).resolve().parents[2]
    work = repo / "traceml_logs" / "measure_cli"
    shutil.rmtree(work, ignore_errors=True)
    variants = {"summary": ("summary", {}), "cli_pipe": ("cli", {}),
                "cli_terminal": ("cli", {"TTY_COMPATIBLE": "1", "COLUMNS": "120"})}
    out = {name: [] for name in variants}
    for i, name in enumerate(("summary", "cli_pipe", "cli_terminal", "cli_terminal", "cli_pipe", "summary")):
        mode, extra = variants[name]
        logs = work / f"{i}_{name}"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", mode, "--logs-dir", str(logs),
             "--sampler-interval", "0.1", str(repo / "traceml_tpu_torch" / "dev" / "forward_script.py"),
             "--", "--steps", str(steps)],
            env=dict(os.environ, PYTHONPATH=str(repo), **extra), cwd=repo, capture_output=True, text=True,
            timeout=600,
        )
        wall_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"run {name} exited {proc.returncode}: {proc.stderr[-2000:]}")
        (session,) = [p for p in logs.iterdir() if p.is_dir()]
        conn = sqlite3.connect(session / "telemetry.sqlite")
        try:
            device = [json.loads(r[0])[T.STEP_TIME]["device_ms"]
                      for r in conn.execute("SELECT events_json FROM step_time_samples ORDER BY step")]
        finally:
            conn.close()
        out[name].append({"median_ms": statistics.median(device), "mean_ms": statistics.fmean(device),
                          "wall_s": wall_s, "stdout_bytes": len(proc.stdout.encode())})
    return out


# -- 9. the forward's host margin -------------------------------------------

HOST_REPEATS = 20


def rms_norm_eight_ops(x, scale, eps: float, dtype):
    """RMSNorm written out, as the model ran it before ``F.rms_norm``."""
    x32 = x.float()
    return (x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps) * scale).to(dtype)


def rope_negate_concat(x, cos, sin_full):
    """The rotation as the model ran it before the roll: [-x2, x1]
    concatenated, and a sin table repeated over both halves."""
    half = x.shape[-1] // 2
    xf = x.float()
    return (xf * cos + torch.cat([-xf[..., half:], xf[..., :half]], dim=-1) * sin_full).to(x.dtype)


@contextlib.contextmanager
def _labelled(model):
    """Each module's forward and each RoPE call as a profiler range."""
    from torch.autograd.profiler import record_function

    from traceml_tpu_torch.models import transformer

    stack = []

    def pre(module, args):  # noqa: ANN001
        stack.append(record_function(f"mod:{type(module).__name__}"))
        stack[-1].__enter__()

    def post(module, args, out):  # noqa: ANN001
        stack.pop().__exit__(None, None, None)

    handles = [h for m in model.modules()
               for h in (m.register_forward_pre_hook(pre), m.register_forward_hook(post))]
    original = transformer._apply_rope

    def rope(*args, **kwargs):  # noqa: ANN001
        with record_function("fn:_apply_rope"):
            return original(*args, **kwargs)

    transformer._apply_rope = rope
    try:
        yield
    finally:
        transformer._apply_rope = original
        for h in handles:
            h.remove()


def _owner(event) -> str:
    """The innermost labelled range or autograd node above ``event``."""
    while event is not None:
        if event.name.startswith(("mod:", "fn:")):
            return event.name
        if event.name.startswith("autograd::engine::evaluate_function: "):
            return "bwd:" + event.name.split(": ", 1)[1]
        event = event.cpu_parent
    return "other"


def _census(fn, repeats: int, sync) -> dict:
    """Kernels a call of ``fn``, in all and by owner, and their device
    ms a call; on the CPU (no CUDA activity) the leaf ``aten::`` ops
    stand in for kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    sync()
    with profile(activities=activities) as prof:
        for _ in range(repeats):
            fn()
        sync()
    events = prof.events()
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    by_owner = {}
    if cuda:
        total, device_ms = len(cuda), sum(e.device_time_total for e in cuda) / 1e3 / repeats
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CPU and e.kernels:
                by_owner[_owner(e)] = by_owner.get(_owner(e), 0) + len(e.kernels)
    else:
        leaves = [e for e in events if not e.cpu_children and e.name.startswith("aten::")]
        total, device_ms = len(leaves), None
        for e in leaves:
            by_owner[_owner(e)] = by_owner.get(_owner(e), 0) + 1
    return {"kernels": total / repeats, "device_ms": device_ms,
            "by_owner": {k: v / repeats for k, v in sorted(by_owner.items(), key=lambda kv: -kv[1])}}


def _idle_host_ms(fn, sync) -> float:
    """Host ms of one call of ``fn`` on an idle device."""
    sync()
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    sync()
    return ms


def _summary(vals) -> dict:
    s = sorted(vals)
    return {"median": statistics.median(s), "min": s[0], "p90": s[min(len(s) - 1, int(0.9 * len(s)))]}


def _pace(path: str, census: dict, host: list, **extra) -> None:
    pace = {"path": path, "kernels": census["kernels"], "kernel_ms": census["device_ms"],
            "host_enqueue_ms": _summary(host), **extra}
    if census["device_ms"]:
        pace["host_over_kernel"] = statistics.median(host) / census["device_ms"]
    print("[launches] " + json.dumps({"path": path, **census}), flush=True)
    print("[pace] " + json.dumps(pace), flush=True)


def _diff(a, b) -> dict:
    d = a.float() - b.float()
    ref = b.float().norm().item()
    return {"bit_equal": bool(torch.equal(a, b)), "max_abs": d.abs().max().item(),
            "rel_fro": d.norm().item() / ref if ref else 0.0, "mismatched": int((a != b).sum().item()),
            "of": a.numel()}


def _routes(cfg, device, B: int, S: int) -> None:
    """The plain-op routes against their older forms, forward and backward."""
    import torch.nn.functional as F

    from traceml_tpu_torch.models import transformer as T

    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    def run(fn, g, *inputs):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        out.backward(g)
        return [out.detach()] + [t.grad for t in leaves]

    x, grad = randn(B, S, cfg.hidden), randn(B, S, cfg.hidden)
    scale = 1.0 + 0.1 * torch.randn((cfg.hidden,), generator=gen, device=device)
    old = run(lambda a, s: rms_norm_eight_ops(a, s, 1e-6, torch.bfloat16), grad, x, scale)
    new = run(lambda a, s: F.rms_norm(a.float(), (cfg.hidden,), s, 1e-6).to(torch.bfloat16), grad, x, scale)
    print("[route] " + json.dumps({"route": "rms_norm", "shape": [B, S, cfg.hidden], **{
        k: _diff(a, b) for k, a, b in zip(("out", "dx", "dscale"), new, old)}}), flush=True)
    hd, half = cfg.head_dim, cfg.head_dim // 2
    positions = torch.arange(S, device=device).expand(B, S)
    freqs = torch.exp(-math.log(cfg.rope_theta) * (2.0 * torch.arange(half, dtype=torch.float32, device=device) / hd))
    angles = positions[..., None].float() * freqs
    cos_full = torch.cat([torch.cos(angles)] * 2, dim=-1)[..., None, :]
    sin_full = torch.cat([torch.sin(angles)] * 2, dim=-1)[..., None, :]
    q, gq = randn(B, S, cfg.n_heads, hd), randn(B, S, cfg.n_heads, hd)
    tables = T._rope_tables(positions, hd, cfg.rope_theta)
    old = run(lambda a: rope_negate_concat(a, cos_full, sin_full), gq, q)
    new = run(lambda a: T._apply_rope(a, *tables), gq, q)
    print("[route] " + json.dumps({"route": "rope", "shape": list(q.shape), "out": _diff(new[0], old[0]),
                                   "dq": _diff(new[1], old[1])}), flush=True)
    dense = T.Dense(cfg.hidden, cfg.hidden, torch.bfloat16, torch.float32, device)
    w = dense.weight.detach().clone().requires_grad_()
    old = run(lambda a, v: F.linear(a, v.to(torch.bfloat16)), grad[:1], x[:1], w)
    with torch.no_grad():
        dense(x[:1])  # keeps the cast
    xs = x[:1].clone().requires_grad_()
    out = dense(xs)
    out.backward(grad[:1])
    print("[route] " + json.dumps({"route": "dense_kept_cast", **{
        k: _diff(a, b) for k, a, b in zip(("out", "dx", "dw"), (out.detach(), xs.grad, dense.weight.grad), old)}}),
        flush=True)


def _host_margin(cfg, device, batch: int, seq: int) -> None:
    """Item 9 at ``batch`` × ``seq`` tokens (full width on the card)."""
    import torch.nn.functional as F

    from traceml_tpu_torch.dev.workload import build_model, build_train_state, cuda_ms, host_batches
    from traceml_tpu_torch.models.transformer import loss_fn, make_train_step
    from traceml_tpu_torch.ops import flash_attention as fa

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    pin = device.type == "cuda"
    model = build_model(cfg, SEED, device=device)
    tokens = host_batches(cfg, SEED + 1, n=1, batch=batch, seq=seq, pin=pin)[0].to(device)

    def forward():
        with torch.inference_mode():
            model(tokens)

    for _ in range(3):
        forward()
    with _labelled(model):
        census = _census(forward, 3, sync)
    _pace("forward_loop", census, [_idle_host_ms(forward, sync) for _ in range(HOST_REPEATS)])
    del model
    model, optimizer = build_train_state(cfg, SEED, device=device)
    tokens = host_batches(cfg, SEED + 1, n=1, batch=batch, seq=seq + 1, pin=pin)[0].to(device)
    step = make_train_step(model, optimizer)
    for _ in range(2):
        step(tokens)
    held = {}
    phases = {
        "forward": lambda: held.update(loss=loss_fn(model, tokens)),
        "backward": lambda: held.pop("loss").backward(),
        "optimizer": lambda: (optimizer.step(), optimizer.zero_grad(set_to_none=True)),
    }
    with _labelled(model):
        censuses = {name: _census(fn, 1, sync) for name, fn in phases.items()}
    host = {name: [] for name in phases}
    for _ in range(HOST_REPEATS // 2):
        for name, fn in phases.items():
            host[name].append(_idle_host_ms(fn, sync))
    for name in phases:
        _pace(f"train_{name}", censuses[name], host[name])
    steps = []
    if device.type == "cuda":
        for _ in range(STEPS // 2):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(tokens)
            end.record()
            end.synchronize()
            steps.append(start.elapsed_time(end))
    sync()
    t0 = time.perf_counter()
    for _ in range(STEPS // 2):
        step(tokens)
    sync()
    print("[train_step] " + json.dumps({"device_ms": _summary(steps) if steps else None,
                                        "loop_wall_ms_per_step": (time.perf_counter() - t0) / (STEPS // 2) * 1e3}),
          flush=True)
    del model, optimizer, step
    gen = torch.Generator(device=device).manual_seed(SEED)
    shape = (8, 1024, 16, 64) if device.type == "cuda" else (1, 128, 2, 64)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
    with torch.inference_mode():
        for _ in range(20):
            fa.flash_attention(q, k, v)
        sync()
        per_call = []
        for _ in range(200):
            t0 = time.perf_counter()
            fa.flash_attention(q, k, v)
            per_call.append((time.perf_counter() - t0) * 1e6)
        sync()
    wrapper = {"shape": list(shape), "host_us_per_call": _summary(per_call)}
    if device.type == "cuda":
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        wrapper["kernel_ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
        wrapper["sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20)
        wrapper["tensor_map_cache"] = fa.tensor_map_cache_stats()
    print("[flash_wrapper] " + json.dumps(wrapper), flush=True)
    _routes(cfg, device, batch, seq)


def kernel_group(kernel_name: str) -> str:
    """The group of a CUDA kernel's profiler name; unmatched names are "other"."""
    return next((name for name, rx in _GROUPS if rx.search(kernel_name)), "other")


def _kernel_breakdown(prof) -> dict:
    kernels = [
        (e.key, e.device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        # a record_function range (``Optimizer.step#AdamW.step``) shows on
        # the device timeline too: it spans kernels, it is none
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    total = sum(ms for _, ms, _ in kernels)
    groups = {name: 0.0 for name, _ in _GROUPS}
    groups["other"] = 0.0
    for key, ms, _ in kernels:
        groups[kernel_group(key)] += ms
    top = sorted(kernels, key=lambda k: -k[1])[:15]
    return {
        "device_ms_per_step": total / PROFILED_STEPS,
        "groups_ms_per_step": {k: v / PROFILED_STEPS for k, v in groups.items()},
        "top_kernels": [
            {"name": k[:120], "ms_per_step": ms / PROFILED_STEPS, "calls_per_step": n / PROFILED_STEPS}
            for k, ms, n in top
        ],
    }


def main(argv=None) -> int:
    """``--only h2d`` stops after the forward's overhead and ``torch_h2d``
    measurements; ``--only cli`` runs item 8 alone, ``--only host_margin``
    item 9."""
    args = sys.argv[1:] if argv is None else argv
    only = args[args.index("--only") + 1] if "--only" in args else None
    if not torch.cuda.is_available():
        print("measure_main_path: CUDA is not available", file=sys.stderr)
        return 2
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.dev.workload import (
        TRAIN_TOKENS,
        build_model,
        build_train_state,
        cuda_ms,
        full_width_config,
        host_batches,
    )
    from traceml_tpu_torch.models.transformer import make_train_step
    from traceml_tpu_torch.ops.attention import causal_attention_reference
    from traceml_tpu_torch.ops.flash_attention import flash_attention

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[env] {card}; torch {torch.__version__} cuda {torch.version.cuda}; package {tm.__file__}", flush=True)
    if only == "cli":
        print("[cli_display] " + json.dumps(_cli_display_cost()), flush=True)
        return 0

    cfg = full_width_config()
    if only == "host_margin":
        from traceml_tpu_torch.dev.workload import BATCH, SEQ

        _host_margin(cfg, torch.device("cuda"), BATCH, SEQ)
        return 0
    model = build_model(cfg, SEED)
    batches = host_batches(cfg, SEED + 1)
    _untraced_ms(model, batches, 5)  # warm-up: cuBLAS handles, the kernel build
    runs = [
        ("untraced", _untraced_ms(model, batches, STEPS)),
        ("traced", _traced_ms(model, batches, STEPS)),
        ("traced_no_h2d", _traced_ms(model, batches, STEPS, patch_h2d=False)),
        ("traced_no_h2d", _traced_ms(model, batches, STEPS, patch_h2d=False)),
        ("traced", _traced_ms(model, batches, STEPS)),
        ("untraced", _untraced_ms(model, batches, STEPS)),
    ]
    print("[overhead] " + json.dumps(_overhead(runs)), flush=True)
    print("[h2d_patch] forward_ab " + json.dumps(_h2d_patch_ab(model, batches, STEPS)), flush=True)
    print("[h2d_patch] variants " + json.dumps(_h2d_patch_variants(model, batches, STEPS)), flush=True)
    if only == "h2d":
        return 0
    print("[flops_count] " + json.dumps(_flops_count_ms(model, batches)), flush=True)
    print("[h2d_patch] to_call_host_ns " + json.dumps(_to_call_host_ns()), flush=True)
    _init_traced(True)
    probe = batches[0].to("cuda")
    with torch.inference_mode():
        print("[h2d_patch] forward to_calls_per_step " + json.dumps(_to_calls_per_step(lambda: model(probe))),
              flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = _traced_ms(model, batches, PROFILED_STEPS)
    breakdown = _kernel_breakdown(prof)
    print("[profile] " + json.dumps(breakdown), flush=True)

    enqueue = _host_enqueue_ms(model, batches, 20)
    host_ms = statistics.median(enqueue)
    device_ms = breakdown["device_ms_per_step"]
    pace = {
        "host_enqueue_ms_median": host_ms,
        "host_enqueue_ms_min": min(enqueue),
        "device_kernel_ms_per_step": device_ms,
        # kernel time and wall time of the same profiled steps
        "profiled_wall_ms_per_step": profiled_ms,
        "device_busy_share_profiled": device_ms / profiled_ms,
        "paced_by": "host" if host_ms > device_ms else "device",
    }
    print("[pace] " + json.dumps(pace), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for (H, D), S in itertools.product(((16, 64), (8, 128)), (256, 512, 1024, 2048, 4096)):
        shape = (8192 // S, S, H, D)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kernel_ms = cuda_ms(lambda: flash_attention(q, k, v), 20)
        row = {
            "shape": list(shape),
            "kernel_ms": kernel_ms,
            "kernel_tflops": 4 * shape[0] * H * D * (S * (S + 1) // 2) / (kernel_ms * 1e-3) / 1e12,
            "reference_ms": cuda_ms(lambda: causal_attention_reference(q, k, v), 20),
            "sdpa_ms": cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20
            ),
        }
        print("[attention] " + json.dumps(row), flush=True)

    def forward(tokens):
        with torch.inference_mode():
            return model(tokens)

    for _ in range(3):
        print("[governor] forward " + json.dumps(_governor_trace(lambda: tm.wrap_step_fn(forward), batches, STEPS)),
              flush=True)
    print("[sampler_cost] forward " + json.dumps(
        _sampler_cost(lambda: tm.wrap_step_fn(forward), batches, 5 * STEPS)), flush=True)

    del model
    torch.cuda.empty_cache()
    model, optimizer = build_train_state(cfg, SEED)
    step = make_train_step(model, optimizer)
    train_batches = host_batches(cfg, SEED + 1, seq=TRAIN_TOKENS)
    _untraced_train_ms(step, train_batches, 3)  # warm-up
    runs = [
        ("untraced", _untraced_train_ms(step, train_batches, STEPS)),
        ("traced", _traced_train_ms(step, train_batches, STEPS)),
        ("traced_no_h2d", _traced_train_ms(step, train_batches, STEPS, patch_h2d=False)),
        ("traced_no_h2d", _traced_train_ms(step, train_batches, STEPS, patch_h2d=False)),
        ("traced", _traced_train_ms(step, train_batches, STEPS)),
        ("untraced", _untraced_train_ms(step, train_batches, STEPS)),
    ]
    print("[train_overhead] " + json.dumps(_overhead(runs)), flush=True)
    _init_traced(True)
    probe = train_batches[0].to("cuda")
    print("[h2d_patch] train to_calls_per_step " + json.dumps(_to_calls_per_step(lambda: step(probe))),
          flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = _traced_train_ms(step, train_batches, PROFILED_STEPS)
    breakdown = _kernel_breakdown(prof)
    backward_ms = sum(e.device_time_total for e in prof.key_averages()
                      if e.key == "traceml_tpu_torch::flash_attention_backward") / 1e3
    breakdown["plain_attention_backward_ms_per_step"] = backward_ms / PROFILED_STEPS
    breakdown["profiled_wall_ms_per_step"] = profiled_ms
    print("[train_profile] " + json.dumps(breakdown), flush=True)
    for _ in range(3):
        print("[governor] train " + json.dumps(_governor_trace(lambda: step, train_batches, STEPS)), flush=True)
    print("[sampler_cost] train " + json.dumps(_sampler_cost(lambda: step, train_batches, STEPS)), flush=True)
    print("[proc_stat] " + json.dumps(_proc_stat_advances()), flush=True)
    del model, optimizer, step
    torch.cuda.empty_cache()
    remat = _remat_compare(cfg, train_batches)
    print("[remat] " + json.dumps(remat), flush=True)
    import dataclasses

    model, optimizer = build_train_state(dataclasses.replace(cfg, remat=True), SEED)
    step = make_train_step(model, optimizer)
    _init_traced(True)
    print("[h2d_patch] remat train to_calls_per_step " + json.dumps(_to_calls_per_step(lambda: step(probe))),
          flush=True)
    print("[sampler_cost] remat train " + json.dumps(_sampler_cost(lambda: step, train_batches, STEPS)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
