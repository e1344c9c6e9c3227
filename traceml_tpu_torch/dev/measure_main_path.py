"""On-card measurements of the main path, beyond ``chip_smoke.py``'s checks.

    python3 -m traceml_tpu_torch.dev.measure_main_path     # one CUDA card

1. Tracer overhead: the full-width forward loop untraced and traced
   (``init``, runtime, ``wrap_dataloader``, ``trace_step``,
   ``wrap_step_fn``), in turns untraced, traced, traced, untraced; wall
   time per step on the host clock, each run ending in a synchronize.
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
   ``init(mode="auto")``'s forward, backward and optimizer patches,
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

Each untraced run first removes the auto-patches, each traced run
installs them, so the untraced runs pay nothing of the tracer.

Prints one JSON line per measurement.
"""

from __future__ import annotations

import itertools
import json
import re
import statistics
import subprocess
import sys
import time

import torch

STEPS = 60
PROFILED_STEPS = 5
SEED = 0


def _untraced_ms(model, batches, steps: int) -> float:
    from traceml_tpu_torch.sdk.initial import shutdown_patches

    shutdown_patches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i in range(steps):
            model(batches[i % len(batches)].to("cuda", non_blocking=True))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def _traced_ms(model, batches, steps: int) -> float:
    import traceml_tpu_torch as tm

    def forward(tokens):
        with torch.inference_mode():
            return model(tokens)

    tm.init(mode="auto")
    tm.start_runtime()
    step = tm.wrap_step_fn(forward)
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


def _traced_train_ms(step, batches, steps: int) -> float:
    import traceml_tpu_torch as tm

    tm.init(mode="auto")
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
    untraced = [ms for name, ms in runs if name == "untraced"]
    traced = [ms for name, ms in runs if name == "traced"]
    return {
        "runs_ms_per_step": runs,
        "untraced_ms": statistics.mean(untraced),
        "traced_ms": statistics.mean(traced),
        "overhead_pct": (statistics.mean(traced) / statistics.mean(untraced) - 1.0) * 100.0,
    }


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


def main() -> int:
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
    print(f"[env] {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    cfg = full_width_config()
    model = build_model(cfg, SEED)
    batches = host_batches(cfg, SEED + 1)
    _untraced_ms(model, batches, 5)  # warm-up: cuBLAS handles, the kernel build
    runs = [
        ("untraced", _untraced_ms(model, batches, STEPS)),
        ("traced", _traced_ms(model, batches, STEPS)),
        ("traced", _traced_ms(model, batches, STEPS)),
        ("untraced", _untraced_ms(model, batches, STEPS)),
    ]
    print("[overhead] " + json.dumps(_overhead(runs)), flush=True)

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
        ("traced", _traced_train_ms(step, train_batches, STEPS)),
        ("untraced", _untraced_train_ms(step, train_batches, STEPS)),
    ]
    print("[train_overhead] " + json.dumps(_overhead(runs)), flush=True)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
