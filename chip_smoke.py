#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``traceml_tpu_torch``.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

1. Builds every CUDA kernel of the port from ``traceml_tpu_torch/csrc``.
   It prints what ``ptxas`` says of each instantiation: registers,
   shared memory, spills and warnings.
2. Kernel phase: each kernel against its plain PyTorch version on the
   card (bf16 at the main-path shape, at head_dim 128, at S=4096, with
   more (batch, head) pairs than SMs, at S=1088 with a ragged last tile
   and with q scaled by 8; f32 at small shapes), by ``allclose`` and by
   two checks that scale with the output (``traceml_tpu_torch/dev/
   attention_check.py``); planted faults at the main-path shape and at
   S=4096 must fail the same checks.  Then the
   kernel, the plain version and the library call
   (``scaled_dot_product_attention``, timed only as a yardstick) timed
   with CUDA events, beside the card's bound for the same work, with the
   achieved TFLOP/s and the kernel / library ratio of the same call.
3. Main path: the full-width DecoderLM (``traceml_tpu_torch/dev/
   workload.py``: vocab 16384, hidden 1024, 12 layers, 16 heads over 8
   kv heads, bf16; random weights from a numpy seed, loaded through
   ``params_from_jax``) runs a traced forward loop
   at B=8, S=1024 through ``init``, the runtime, ``wrap_dataloader``,
   ``trace_step`` and ``wrap_step_fn``, and its rows give a verdict.
4. Injected fault: the same loop with a host input delay of about 3× the
   measured compute must give INPUT_BOUND.

Any failed check exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

STEPS = 60  # the summary policy needs 50 aligned steps
BATCH, SEQ = 8, 1024  # as traceml_tpu_torch.dev.workload
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 off the tensor cores
LOGITS_REL_TOL = 5e-2  # kernel vs plain attention through 12 bf16 layers
# shapes at which planted faults are put through the kernel's checks
PLANT_AT = ((BATCH, SEQ, 16, 64), (1, 4096, 4, 64), (1, 4096, 4, 128))


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def attention_bound_ms(shape, dtype) -> tuple:
    """The card's least time for causal attention over these inputs: the
    larger of bytes (q, k, v read once, o written once) over HBM rate and
    the causal pairs' operations over the peak rate for the dtype."""
    B, S, H, D = shape
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * B * S * H * D * elem
    flops = 4 * B * H * D * (S * (S + 1) // 2)  # QKᵀ and PV, 2·D each per pair
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def qkv(shape, dtype, gen):
    return tuple(
        torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)
        for _ in range(3)
    )


def kernel_phase() -> dict:
    from traceml_tpu_torch.dev.attention_check import compare, planted_faults
    from traceml_tpu_torch.dev.workload import cuda_ms
    from traceml_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # (shape, dtype, q scale), each held to attention_check.TOLERANCES.
    # S=1088 leaves a ragged last 128-row tile in the bf16 kernel; 9 x 16
    # (batch, head) pairs are more than the card's 132 SMs; q x 8 makes
    # the online rescale work.
    checks = [
        ((BATCH, SEQ, 16, 64), torch.bfloat16, 1.0),  # the main path's shape
        ((2, 1024, 8, 128), torch.bfloat16, 1.0),
        ((1, 4096, 4, 64), torch.bfloat16, 1.0),
        ((1, 4096, 4, 128), torch.bfloat16, 1.0),
        ((9, 1024, 16, 64), torch.bfloat16, 1.0),
        ((2, 1088, 8, 64), torch.bfloat16, 1.0),
        ((2, 1088, 8, 128), torch.bfloat16, 1.0),
        ((2, 1024, 8, 64), torch.bfloat16, 8.0),
        ((2, 1088, 8, 128), torch.bfloat16, 8.0),
        ((1, 512, 4, 64), torch.float32, 1.0),
        ((1, 256, 2, 128), torch.float32, 1.0),
    ]
    errors = {}
    for shape, dtype, q_scale in checks:
        q, k, v = qkv(shape, dtype, gen)
        q = (q.float() * q_scale).to(dtype)
        blk = 128 if shape[1] % 128 == 0 else 64
        out = flash_attention(q, k, v, blk_q=blk, blk_k=blk)
        ref = flash_attention_plain(q, k, v, blk, blk)
        got = compare(out, ref)
        log("kernel", json.dumps({"shape": list(shape), "dtype": str(dtype), "q_scale": q_scale, **got}))
        check(got["ok"], f"flash_attention disagrees with its plain version at {shape} {dtype} q x {q_scale}")
        errors[(shape, dtype, q_scale)] = got["max_abs_err"]
        if shape in PLANT_AT and q_scale == 1.0:
            # the same checks on broken kernels' outputs: each must fail
            for fault, bad in planted_faults(q, k, v).items():
                caught = compare(bad, ref)
                log("kernel", "planted " + json.dumps({"shape": list(shape), "fault": fault, **caught}))
                check(not caught["ok"], f"the checks pass the planted fault {fault} at {shape}")
    for S, blk in ((1000, 128), (96, 32)):
        q, k, v = qkv((1, S, 2, 64), torch.bfloat16, gen)
        try:
            flash_attention(q, k, v, blk_q=blk, blk_k=blk)
        except ValueError as exc:
            log("kernel", f"S={S} refused: {exc}")
        else:
            raise CheckFailed(f"flash_attention accepted S={S}")

    shape, dtype = (BATCH, SEQ, 16, 64), torch.bfloat16
    q, k, v = qkv(shape, dtype, gen)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kernel_ms = cuda_ms(lambda: flash_attention(q, k, v), 20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), 5)
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20
    )
    kernel_ms_2 = cuda_ms(lambda: flash_attention(q, k, v), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):  # the host's cost of one call: checks, tensor maps, launch
        flash_attention(q, k, v)
    wrapper_host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    bound_ms, bound_by = attention_bound_ms(shape, dtype)
    B, S, H, D = shape
    causal_flops = 4 * B * H * D * (S * (S + 1) // 2)
    timing = {"shape": list(shape), "dtype": "bfloat16", "ms": kernel_ms, "ms_repeat": kernel_ms_2,
              "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "tflops": causal_flops / (kernel_ms * 1e-3) / 1e12,
              "library_tflops": causal_flops / (library_ms * 1e-3) / 1e12,
              "kernel_over_library": kernel_ms / library_ms, "wrapper_host_us": wrapper_host_us}
    log("kernel", "timing " + json.dumps(timing))
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "traceml_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "traceml_tpu/ops/pallas_attention.py:72",
        "launches": None,  # filled from the main path's run
        "max_abs_err": errors[(shape, dtype, 1.0)],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def traced_loop(model, batches, steps: int, delay_s: float) -> dict:
    """``steps`` traced forward steps under a fresh runtime; returns the
    runtime's rows, the kernel launches and the loop's wall time."""
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.ops.flash_attention import flash_attention
    from traceml_tpu_torch.runtime.lifecycle import get_active_runtime
    from traceml_tpu_torch.runtime.runtime import RuntimeSettings

    def host_batches():
        for i in range(steps):
            if delay_s:
                time.sleep(delay_s)
            yield batches[i % len(batches)]

    def forward(tokens):
        with torch.inference_mode():
            return model(tokens)

    tm.start_runtime(RuntimeSettings(sampler_interval_sec=0.5))
    rt = get_active_runtime()
    step = tm.wrap_step_fn(forward)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    for tokens in tm.wrap_dataloader(host_batches(), to_device=True):
        with tm.trace_step():
            logits = step(tokens)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = flash_attention.launches
    check(tuple(logits.shape) == (BATCH, SEQ, model.cfg.vocab_size), f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    time.sleep(1.0)  # let one tick sample the finished steps
    live = tm.live_metrics()
    tm.stop_runtime()
    return {
        "rows": rt.sampler("step_time").db.tail("step_time"),
        "memory": rt.sampler("step_memory").db.tail("step_memory"),
        "launches": launches,
        "wall_s": wall_s,
        "live": live,
    }


def phase_medians(rows, name) -> dict:
    from traceml_tpu_torch.utils import timing as T

    key = getattr(T, name)
    dev = [r["events"][key]["device_ms"] for r in rows if r["events"].get(key, {}).get("device_ms") is not None]
    cpu = [r["events"][key]["cpu_ms"] for r in rows if key in r["events"]]
    return {
        "device_ms_median": statistics.median(dev) if dev else None,
        "cpu_ms_median": statistics.median(cpu) if cpu else None,
    }


def main_path_phase() -> int:
    """The traced main path and the injected fault; returns the kernel's
    launches in the main path's run."""
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.dev.workload import build_model, full_width_config, host_batches
    from traceml_tpu_torch.diagnostics.step_time.api import diagnose_rank_rows
    from traceml_tpu_torch.ops import attention as attention_mod
    from traceml_tpu_torch.ops.flash_attention import flash_attention_plain
    from traceml_tpu_torch.utils import timing as T

    cfg = full_width_config()
    t0 = time.perf_counter()
    model = build_model(cfg, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    log("slice", f"config vocab={cfg.vocab_size} hidden={cfg.hidden} layers={cfg.n_layers} "
                 f"heads={cfg.n_heads} kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim} "
                 f"ffn_hidden={cfg.ffn_hidden} batch={BATCH} seq={SEQ} params={n_params} "
                 f"(built in {time.perf_counter() - t0:.3f} s)")

    batches = host_batches(cfg, SEED + 1)

    # the model through the kernel against the model through the plain version
    probe = batches[0][:1].cuda()
    with torch.inference_mode():
        got = model(probe)
        with mock.patch.object(attention_mod, "flash_attention", flash_attention_plain):
            want = model(probe)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    log("slice", f"logits kernel vs plain: max_abs_diff {diff} of max|logit| {scale} "
                 f"(rel {diff / scale}, tol {LOGITS_REL_TOL})")
    check(bool(torch.isfinite(got).all()) and diff / scale < LOGITS_REL_TOL,
          "model logits through the kernel disagree with the plain version")

    with torch.inference_mode():  # warm-up outside the trace
        for tokens in batches[:3]:
            model(tokens.cuda())
    torch.cuda.synchronize()

    tm.init(mode="auto")
    run = traced_loop(model, batches, STEPS, 0.0)
    rows, mem = run["rows"], run["memory"]
    check(run["launches"] == cfg.n_layers * STEPS,
          f"flash launches {run['launches']} != {cfg.n_layers} x {STEPS}")
    check(len(rows) == STEPS, f"{len(rows)} step rows for {STEPS} steps")
    check(all(r["clock"] == "device" for r in rows), "a step row is not on the device clock")
    for key in (T.COMPUTE_TIME, T.H2D_TIME):
        vals = [r["events"].get(key, {}).get("device_ms") for r in rows]
        check(all(v is not None and v > 0 for v in vals), f"{key} device_ms missing or not positive")
    check(bool(mem) and all(m["step_peak_bytes"] > 0 for m in mem), "no positive step-memory rows")
    check(all(m["backend"] == "cuda_memory_stats" for m in mem), "step-memory rows not from CUDA")
    verdict = diagnose_rank_rows({0: rows}).diagnosis
    phases = {name: phase_medians(rows, name) for name in ("STEP_TIME", "COMPUTE_TIME", "H2D_TIME", "DATALOADER_NEXT")}
    log("slice", f"{STEPS} traced steps in {run['wall_s']:.4f} s wall; flash launches {run['launches']}")
    log("slice", "phase medians " + json.dumps(phases))
    log("slice", f"step peak memory {max(m['step_peak_bytes'] for m in mem)} bytes "
                 f"(backend {mem[-1]['backend']}, {len(mem)} rows)")
    log("slice", f"verdict: {verdict.kind} ({verdict.severity}): {verdict.summary}")
    log("slice", "live_metrics " + json.dumps(run["live"]))

    compute_ms = phases["COMPUTE_TIME"]["device_ms_median"]
    delay_s = 3.0 * compute_ms / 1000.0
    fault = traced_loop(model, batches, STEPS, delay_s)
    fault_verdict = diagnose_rank_rows({0: fault["rows"]}).diagnosis
    fault_phases = {name: phase_medians(fault["rows"], name) for name in ("STEP_TIME", "COMPUTE_TIME", "DATALOADER_NEXT")}
    log("fault", f"input delay {delay_s * 1e3:.3f} ms (3x compute median); phase medians " + json.dumps(fault_phases))
    log("fault", f"verdict: {fault_verdict.kind} ({fault_verdict.severity}): {fault_verdict.summary}")
    check(fault_verdict.kind == "INPUT_BOUND", f"injected input delay gave {fault_verdict.kind}, not INPUT_BOUND")
    return run["launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a CUDA card", file=sys.stderr)
        return 2
    from traceml_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("env", f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
               f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build(_build.kernel_sources())
    log("build", f"{len(_build.kernel_sources())} source(s) built in {time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_log.items():  # ptxas -v: each instantiation, then its use
        for line in text.splitlines():
            if any(word in line for word in ("entry function", "registers", "spill", "smem", "arning")):
                log("build", f"{name}: {line.strip()}")
    from traceml_tpu_torch.ops.flash_attention import kernel_smem_bytes

    for dtype in (torch.bfloat16, torch.float32):
        for head_dim in (64, 128):
            log("build", f"flash_attention_fwd {dtype} D={head_dim}: dynamic shared memory "
                         f"{kernel_smem_bytes(dtype, head_dim)} bytes per block")

    t0 = time.perf_counter()
    kernel = kernel_phase()
    log("time", f"kernel phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    kernel["launches"] = main_path_phase()
    log("time", f"main path and fault phases {time.perf_counter() - t0:.2f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
