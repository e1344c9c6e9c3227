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
    ("elementwise_and_reductions", re.compile(r"elementwise|reduce|vectorized|softmax|index|cat|copy|fill", re.I)),
)


def _host_enqueue_ms(model, batches, steps: int) -> list:
    """Host time to enqueue each of ``steps`` untraced forwards, each on an
    idle card (synchronized before and after), so the launch queue never
    fills and the time is the host's alone."""
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


def kernel_group(kernel_name: str) -> str:
    """The group of a CUDA kernel's profiler name; unmatched names are "other"."""
    return next((name for name, rx in _GROUPS if rx.search(kernel_name)), "other")


def _kernel_breakdown(prof) -> dict:
    kernels = [
        (e.key, e.device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
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
    from traceml_tpu_torch.dev.workload import build_model, cuda_ms, full_width_config, host_batches
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
    tm.init(mode="auto")
    _untraced_ms(model, batches, 5)  # warm-up: cuBLAS handles, the kernel build
    runs = [
        ("untraced", _untraced_ms(model, batches, STEPS)),
        ("traced", _traced_ms(model, batches, STEPS)),
        ("traced", _traced_ms(model, batches, STEPS)),
        ("untraced", _untraced_ms(model, batches, STEPS)),
    ]
    untraced = [ms for name, ms in runs if name == "untraced"]
    traced = [ms for name, ms in runs if name == "traced"]
    overhead = {
        "runs_ms_per_step": runs,
        "untraced_ms": statistics.mean(untraced),
        "traced_ms": statistics.mean(traced),
        "overhead_pct": (statistics.mean(traced) / statistics.mean(untraced) - 1.0) * 100.0,
    }
    print("[overhead] " + json.dumps(overhead), flush=True)

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
