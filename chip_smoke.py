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
3. Forward path: the full-width DecoderLM (``traceml_tpu_torch/dev/
   workload.py``: vocab 16384, hidden 1024, 12 layers, 16 heads over 8
   kv heads, bf16 compute, f32 parameters; random weights from a numpy
   seed, loaded through ``params_from_jax``) runs a traced forward loop
   at B=8, S=1024 through ``init(mode="auto")``, the runtime,
   ``wrap_dataloader``, ``trace_step`` and ``wrap_step_fn``, and its rows
   give a verdict; the forward patch records nothing inside the compute
   region.  Then the same loop with a host input delay of about 3× the
   measured compute must give INPUT_BOUND.
4. Train path, the slice's main path: the attention op's dq, dk and dv
   (kernel forward, plain backward) against autograd through the
   reference at the main-path shape; the full-width AdamW train step on
   (8, 1025) tokens through the kernel route against the same step
   through the plain route (first-step gradients, three losses, each
   parameter's update after three steps); then a traced train loop in
   process, timed by ``init(mode="auto")``'s forward, backward and
   optimizer patches on the device clock, with its gates (12 launches a
   step, every row on the device clock with forward, backward and
   optimizer device times, the loss falling, the step's peak memory above
   parameters + gradients + AdamW state).  The ``lm_head`` (its forward
   GEMM and both gradient GEMMs at TF32, scoped by ``TF32Dense``) against
   the IEEE route on the same weights and (8, 1025) tokens: logits within
   ``LM_HEAD_LOGITS_REL_FRO`` and the loss within ``LM_HEAD_LOSS_REL``,
   the two routes' GEMM times, and the process's TF32 flag reading the
   same before and after a train step, from ``False`` and from ``True``.
   Each in-process loop prints its samplers' cost per tick.
5. Run phase: the product's entry point, ``python -m traceml_tpu_torch run
   --mode summary``, on ``traceml_tpu_torch/dev/forward_script.py`` and
   on ``traceml_tpu_torch/dev/train_script.py``, each healthy with the
   sender ticking every 0.1 s (ten times the default rate, so it ships
   about a dozen batches while the loop runs; the healthy forward runs
   ``RUN_FORWARD_STEPS`` steps, so that the system rules' last 30 samples
   fall in its loop), then with a host input delay of 3× the in-process
   step at the default 1 s tick.  The
   launcher spawns the aggregator and one rank; the rank runs the
   full-width loop through the kernel and ships its rows over TCP; the
   aggregator stores them in SQLite and writes ``final_summary.json``.
   Gates: the summary's step-time section on the device clock with at
   least 50 steps, its step-memory section with a positive peak, one
   ``step_time_samples`` row per traced step, the manifest ``completed``
   with telemetry ``ok``, no dropped rows or decode errors, 12 × 60 flash
   launches in the rank, and the verdict in the summary and on the
   launcher's stdout: COMPUTE_BOUND for the healthy forward, the band of
   the measured MFU for the healthy train run (LOW_MFU below 15%),
   INPUT_BOUND with the delay.  The train runs also need their stored
   rows to meet the in-process loop's device-clock gates, the loss
   falling, and an ``efficiency`` section with the card's peak,
   ``flops_per_step`` within 2% of the analytic count and an MFU in
   (0, 1).  Every run's ``system`` and ``process`` sections must be OK,
   with ``cpu_pct`` on every host row, NVML utilization, temperature and
   power on every GPU row, ``system_manifest.json`` naming the card and
   its power limit as ``nvidia-smi`` does, RSS above 0 and the process
   rows' GPU peak at least the largest step-memory peak; the healthy
   train run's NVML utilization, as the system rules read it (the mean of
   the last 30 samples), must be at least ``UTIL_HEALTHY_MIN_PCT``.  Reported: the step device times under ``run`` (median, mean,
   p90, max) against the in-process loop's, which runs no sender; the
   sender's busy ticks, its collect and encode cost per busy tick, its
   flush cost per timed send and its codec, the aggregator's
   finalization time and each call's wall time.  The sessions are kept
   under ``traceml_logs/chip_smoke/``.

Any failed check exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import signal
import sqlite3
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

STEPS = 60  # the summary policy needs 50 aligned steps
BATCH, SEQ = 8, 1024  # as traceml_tpu_torch.dev.workload
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 off the tensor cores
LOGITS_REL_TOL = 5e-2  # kernel vs plain attention through 12 bf16 layers
COMPARE_STEPS = 3  # train steps held kernel route against plain route
# the attention op's dq, dk, dv against autograd through the reference:
# the same products in the same order, so only bf16 rounding can differ
GRAD_REL_FRO = 5e-3
# kernel route vs plain route through the full-width bf16 train step (the
# plain route keeps P in f32, and autograd differentiates its blocked
# loop where the kernel route recomputes the einsum attention): the loss
# relative to itself, each gradient and each parameter's update by
# ‖kernel − plain‖_F / ‖plain‖_F
# (measured on the H100 at 2e-5, 0.033 and 0.12; the op-level dq, dk and
# dv above are held to the reference at 5e-3)
TRAIN_LOSS_REL = 1e-3
TRAIN_GRAD_REL_FRO = 0.1
TRAIN_UPDATE_REL_FRO = 0.5
FLOPS_REL_TOL = 0.02  # estimate_step_flops against the analytic count
# the TF32 lm_head against the IEEE route: TF32 rounds each product's
# inputs to a 10-bit mantissa (2^-11 relative), and 1024-term f32 sums of
# such products stay far inside these
LM_HEAD_LOGITS_REL_FRO = 5e-3
LM_HEAD_LOSS_REL = 1e-3
RUN_FORWARD_STEPS = 300  # ~5 s of the healthy forward at the 0.1 s tick
UTIL_HEALTHY_MIN_PCT = 70.0  # NVML utilization of the healthy train run
# shapes at which planted faults are put through the kernel's checks
PLANT_AT = ((BATCH, SEQ, 16, 64), (1, 4096, 4, 64), (1, 4096, 4, 128))
REPO = Path(__file__).resolve().parent
RUN_DIR = REPO / "traceml_logs" / "chip_smoke"  # the launcher's default logs dir
RUN_TIMEOUT_S = 420


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


def traced_loop(step, batches, steps: int, delay_s: float) -> dict:
    """``steps`` traced steps of ``step(tokens)`` under a fresh runtime;
    returns the runtime's rows, the first and last step's outputs, the
    kernel launches, the loop's wall time and its samplers' cost per
    tick."""
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.dev.workload import sampler_cost_summary, time_samplers
    from traceml_tpu_torch.ops.flash_attention import flash_attention
    from traceml_tpu_torch.runtime.lifecycle import get_active_runtime
    from traceml_tpu_torch.runtime.settings import TraceMLSettings
    from traceml_tpu_torch.sdk.state import get_state

    def host_batches():
        for i in range(steps):
            if delay_s:
                time.sleep(delay_s)
            yield batches[i % len(batches)]

    tm.start_runtime(TraceMLSettings(sampler_interval_sec=0.5))
    rt = get_active_runtime()
    costs = time_samplers(rt.samplers)
    # each loop here stands for a run of its own: its first step's
    # envelope must not be back-dated to the previous loop's last step
    get_state().last_step_exit = None
    torch.cuda.synchronize()
    flash_attention.launches = 0
    first = out = None
    t0 = time.perf_counter()
    for tokens in tm.wrap_dataloader(host_batches(), to_device=True):
        with tm.trace_step():
            out = step(tokens)
        if first is None:
            first = out
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = flash_attention.launches
    time.sleep(1.0)  # let one tick sample the finished steps
    live = tm.live_metrics()
    tm.stop_runtime()
    return {
        "rows": rt.sampler("step_time").db.tail("step_time"),
        "memory": rt.sampler("step_memory").db.tail("step_memory"),
        "first": first,
        "last": out,
        "launches": launches,
        "wall_s": wall_s,
        "live": live,
        "sampler_cost": sampler_cost_summary(costs),
    }


def spread(vals) -> dict:
    """Median, mean, p90 and max: a stall on a few steps moves the tail
    and the mean where it leaves the median."""
    vals = sorted(vals)
    return {"median": statistics.median(vals), "mean": statistics.fmean(vals),
            "p90": vals[min(len(vals) - 1, int(0.9 * len(vals)))], "max": vals[-1]}


def phase_medians(rows, name) -> dict:
    from traceml_tpu_torch.utils import timing as T

    key = getattr(T, name)
    dev = [r["events"][key]["device_ms"] for r in rows if r["events"].get(key, {}).get("device_ms") is not None]
    cpu = [r["events"][key]["cpu_ms"] for r in rows if key in r["events"]]
    return {
        "device_ms_median": statistics.median(dev) if dev else None,
        "cpu_ms_median": statistics.median(cpu) if cpu else None,
    }


def main_path_phase() -> dict:
    """The traced main path and the injected fault; returns the kernel's
    launches in the main path's run, the layer count and the medians the
    run phase is held against."""
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

    def forward(tokens):
        with torch.inference_mode():
            return model(tokens)

    # auto mode patches nn.Module.__call__ too; inside wrap_step_fn's
    # compute region the forward patch records nothing
    tm.init(mode="auto")
    step = tm.wrap_step_fn(forward)
    run = traced_loop(step, batches, STEPS, 0.0)
    rows, mem, logits = run["rows"], run["memory"], run["last"]
    check(tuple(logits.shape) == (BATCH, SEQ, cfg.vocab_size), f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(run["launches"] == cfg.n_layers * STEPS,
          f"flash launches {run['launches']} != {cfg.n_layers} x {STEPS}")
    check(len(rows) == STEPS, f"{len(rows)} step rows for {STEPS} steps")
    check(all(r["clock"] == "device" for r in rows), "a step row is not on the device clock")
    for key in (T.STEP_TIME, T.COMPUTE_TIME, T.H2D_TIME):
        vals = [r["events"].get(key, {}).get("device_ms") for r in rows]
        check(all(v is not None and v > 0 for v in vals), f"{key} device_ms missing or not positive")
    check(not any(T.FORWARD_TIME in r["events"] for r in rows),
          "the forward patch recorded a forward inside wrap_step_fn's compute region")
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
    log("slice", "sampler cost per tick (0.5 s tick) " + json.dumps(run["sampler_cost"]))

    compute_ms = phases["COMPUTE_TIME"]["device_ms_median"]
    delay_s = 3.0 * compute_ms / 1000.0
    fault = traced_loop(step, batches, STEPS, delay_s)
    fault_verdict = diagnose_rank_rows({0: fault["rows"]}).diagnosis
    fault_phases = {name: phase_medians(fault["rows"], name) for name in ("STEP_TIME", "COMPUTE_TIME", "DATALOADER_NEXT")}
    log("fault", f"input delay {delay_s * 1e3:.3f} ms (3x compute median); phase medians " + json.dumps(fault_phases))
    log("fault", f"verdict: {fault_verdict.kind} ({fault_verdict.severity}): {fault_verdict.summary}")
    check(fault_verdict.kind == "INPUT_BOUND", f"injected input delay gave {fault_verdict.kind}, not INPUT_BOUND")
    return {"launches": run["launches"], "n_layers": cfg.n_layers, "delay_ms": delay_s * 1e3,
            "step_ms": spread(r["events"][T.STEP_TIME]["device_ms"] for r in rows)}


def analytic_train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 x the matmul parameters x the
    tokens (forward 2, backward 4), plus causal attention counted over
    the full S x S products as XLA counts the jnp path, 4·S²·D per head
    forward and 8·S²·D backward."""
    hd = cfg.head_dim
    per_layer = (2 * cfg.hidden * cfg.n_heads * hd + 2 * cfg.hidden * cfg.n_kv_heads * hd
                 + 3 * cfg.hidden * cfg.ffn_hidden)
    matmul_params = cfg.n_layers * per_layer + cfg.hidden * cfg.vocab_size
    attention = 12 * batch * cfg.n_heads * seq * seq * hd * cfg.n_layers
    return 6.0 * matmul_params * batch * seq + attention


def grad_check_phase() -> None:
    """The attention op's gradient on the card: dq, dk and dv through the
    kernel's custom op (its backward is the plain recompute) against
    autograd through ``attention_reference``, at the main-path shape in
    bf16; and the plain backward's device time per call."""
    from traceml_tpu_torch.dev.attention_check import scaled_errors
    from traceml_tpu_torch.dev.workload import cuda_ms
    from traceml_tpu_torch.ops.attention import attention_reference
    from traceml_tpu_torch.ops.flash_attention import _flash_attention_backward_op, flash_attention

    shape, dtype = (BATCH, SEQ, 16, 64), torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q, k, v, g = qkv(shape, dtype, gen) + qkv(shape, dtype, gen)[:1]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves), leaves, g)
    want = torch.autograd.grad(attention_reference(*leaves), leaves, g)
    errors = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        errors[name] = scaled_errors(a, b)
        check(bool(torch.isfinite(a).all()) and errors[name]["rel_fro"] <= GRAD_REL_FRO,
              f"attention {name} disagrees with autograd through the reference: {errors[name]}")
    backward_ms = cuda_ms(lambda: _flash_attention_backward_op(g, q, k, v), 10)
    log("grad", json.dumps({"shape": list(shape), "dtype": "bfloat16", "tol_rel_fro": GRAD_REL_FRO,
                            **errors, "plain_backward_ms": backward_ms}))


def check_train_rows(name: str, rows) -> None:
    """Gates on a train loop's step rows, ``(step, clock, events)`` each:
    every row on the device clock, with positive device times for
    forward, backward and optimizer."""
    from traceml_tpu_torch.utils import timing as T

    for step, clock, events in rows:
        check(clock == "device", f"{name}: step {step} on the {clock} clock")
        ms = [(events.get(key) or {}).get("device_ms")
              for key in (T.FORWARD_TIME, T.BACKWARD_TIME, T.OPTIMIZER_STEP)]
        check(all(v is not None and v > 0 for v in ms),
              f"{name}: step {step} forward/backward/optimizer device_ms {ms}")


def train_compare_phase(cfg, batches) -> None:
    """The full-width train step through the kernel route against the
    same step through the plain route (``flash_attention_plain`` on the
    card, differentiated by autograd), from the same weights on the same
    batches: the first step's gradients, the loss of each of
    ``COMPARE_STEPS`` steps and each parameter's update after them, by
    checks that scale with the output."""
    from contextlib import nullcontext

    from traceml_tpu_torch.dev.attention_check import scaled_errors
    from traceml_tpu_torch.dev.workload import build_train_state
    from traceml_tpu_torch.models.transformer import loss_fn, make_train_step
    from traceml_tpu_torch.ops import attention as attention_mod
    from traceml_tpu_torch.ops.flash_attention import flash_attention_plain

    tokens = [b.cuda() for b in batches[:COMPARE_STEPS]]
    got = {}
    for route in ("kernel", "plain"):
        model, optimizer = build_train_state(cfg, SEED)
        if route == "kernel":
            start = {n: p.detach().clone() for n, p in model.named_parameters()}
        plain = mock.patch.object(attention_mod, "flash_attention", flash_attention_plain)
        with plain if route == "plain" else nullcontext():
            loss_fn(model, tokens[0]).backward()
            grads = {n: p.grad for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            step = make_train_step(model, optimizer)
            losses = [step(t)["loss"].item() for t in tokens]
        got[route] = {"losses": losses, "grads": grads,
                      "updates": {n: p.detach() - start[n] for n, p in model.named_parameters()}}
        del model, optimizer, step
    k, p = got["kernel"], got["plain"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(k["losses"], p["losses"])]
    grad_rel = {n: scaled_errors(k["grads"][n], p["grads"][n])["rel_fro"] for n in p["grads"]}
    update_rel = {n: (k["updates"][n] - p["updates"][n]).norm().item() / p["updates"][n].norm().item()
                  for n in p["updates"]}
    worst_grad = max(grad_rel, key=grad_rel.get)
    worst_update = max(update_rel, key=update_rel.get)
    log("train", json.dumps({
        "losses_kernel": k["losses"], "losses_plain": p["losses"], "loss_rel": loss_rel,
        "grad_rel_fro_max": [worst_grad, grad_rel[worst_grad]],
        "grad_rel_fro_median": statistics.median(grad_rel.values()),
        "update_rel_fro_max": [worst_update, update_rel[worst_update]],
        "update_rel_fro_median": statistics.median(update_rel.values()),
        "tol": {"loss_rel": TRAIN_LOSS_REL, "grad_rel_fro": TRAIN_GRAD_REL_FRO,
                "update_rel_fro": TRAIN_UPDATE_REL_FRO}}))
    check(all(math.isfinite(x) for x in k["losses"]), "non-finite train loss through the kernel")
    check(max(loss_rel) <= TRAIN_LOSS_REL, f"train loss kernel vs plain: {loss_rel}")
    check(grad_rel[worst_grad] <= TRAIN_GRAD_REL_FRO,
          f"gradient of {worst_grad} kernel vs plain: rel_fro {grad_rel[worst_grad]}")
    check(update_rel[worst_update] <= TRAIN_UPDATE_REL_FRO,
          f"update of {worst_update} kernel vs plain: rel_fro {update_rel[worst_update]}")


def lm_head_phase(cfg) -> dict:
    """The ``lm_head`` at TF32 against the IEEE route (``F.linear`` with the
    process's flag, which the kernel phase set to IEEE) on the same
    full-width weights and (8, 1025) tokens: logits and loss, the two
    routes' forward + gradient GEMM times in turns, and the process's
    TF32 flag before and after a train step from ``False`` and ``True``."""
    import torch.nn.functional as F

    from traceml_tpu_torch.dev.attention_check import scaled_errors
    from traceml_tpu_torch.dev.workload import TRAIN_TOKENS, build_train_state, cuda_ms, host_batches
    from traceml_tpu_torch.models.transformer import _TF32Linear, loss_fn, make_train_step

    def flags():
        return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cuda.matmul.fp32_precision)

    check(flags()[0] is False, f"the kernel phase left TF32 flags {flags()}")
    model, optimizer = build_train_state(cfg, SEED)
    tokens = host_batches(cfg, SEED + 1, seq=TRAIN_TOKENS)[0].cuda()
    head = model.lm_head
    with torch.inference_mode():
        logits, loss = model(tokens[:, :-1]), loss_fn(model, tokens).item()
        with mock.patch.object(head, "forward", lambda x: F.linear(x.float(), head.weight)):
            ieee_logits, ieee_loss = model(tokens[:, :-1]), loss_fn(model, tokens).item()
    err = scaled_errors(logits, ieee_logits)
    loss_rel = abs(loss - ieee_loss) / abs(ieee_loss)
    del logits, ieee_logits

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn((BATCH, SEQ, cfg.hidden), generator=gen, device="cuda", requires_grad=True)
    g = torch.randn((BATCH, SEQ, cfg.vocab_size), generator=gen, device="cuda")
    w = head.weight

    def gemms(fn):  # forward GEMM and both gradient GEMMs
        return lambda: torch.autograd.grad(fn(x, w), (x, w), g)

    tf32, ieee = gemms(_TF32Linear.apply), gemms(F.linear)
    times = [("ieee", cuda_ms(ieee, 10)), ("tf32", cuda_ms(tf32, 10)),
             ("tf32", cuda_ms(tf32, 10)), ("ieee", cuda_ms(ieee, 10))]
    del x, g

    step = make_train_step(model, optimizer)
    flag_reads = []
    for setting in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = setting
        before = flags()
        step(tokens)
        torch.cuda.synchronize()
        flag_reads.append({"set": setting, "before": before, "after": flags()})
    torch.backends.cuda.matmul.allow_tf32 = False
    del model, optimizer, step
    out = {"logits": err, "loss_tf32": loss, "loss_ieee": ieee_loss, "loss_rel": loss_rel,
           "tol": {"logits_rel_fro": LM_HEAD_LOGITS_REL_FRO, "loss_rel": LM_HEAD_LOSS_REL},
           "gemms_ms_in_turns": times,
           "tf32_ms": statistics.fmean(t for r, t in times if r == "tf32"),
           "ieee_ms": statistics.fmean(t for r, t in times if r == "ieee"),
           "flags": flag_reads}
    log("lm_head", json.dumps(out))
    check(err["rel_fro"] <= LM_HEAD_LOGITS_REL_FRO, f"TF32 lm_head logits vs IEEE: {err}")
    check(loss_rel <= LM_HEAD_LOSS_REL, f"TF32 lm_head loss vs IEEE: {loss} vs {ieee_loss}")
    for r in flag_reads:
        check(r["before"] == r["after"], f"a train step changed the TF32 flags: {r}")
    return out


def train_path_phase(cfg) -> dict:
    """The traced full-width train loop in process (the slice's main
    path): ``init(mode="auto")``'s patches time forward, backward and
    optimizer on the device clock; returns the kernel's launches and the
    step's device median."""
    from traceml_tpu_torch.dev.workload import TRAIN_TOKENS, build_train_state, host_batches
    from traceml_tpu_torch.diagnostics.step_time.api import diagnose_rank_rows
    from traceml_tpu_torch.models.transformer import make_train_step
    from traceml_tpu_torch.utils import timing as T

    batches = host_batches(cfg, SEED + 1, seq=TRAIN_TOKENS)
    train_compare_phase(cfg, batches)
    model, optimizer = build_train_state(cfg, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(model, optimizer)
    step(batches[0].cuda())  # warm-up outside the trace
    run = traced_loop(step, batches, STEPS, 0.0)
    rows, mem = run["rows"], run["memory"]
    first, last = run["first"]["loss"].item(), run["last"]["loss"].item()
    peak = max((m["step_peak_bytes"] for m in mem), default=0)
    phases = {name: phase_medians(rows, name)
              for name in ("STEP_TIME", "FORWARD_TIME", "BACKWARD_TIME", "OPTIMIZER_STEP", "H2D_TIME",
                           "DATALOADER_NEXT")}
    verdict = diagnose_rank_rows({0: rows}).diagnosis
    log("train", f"{STEPS} traced train steps in {run['wall_s']:.4f} s wall; flash launches "
                 f"{run['launches']}; loss first {first} last {last}; step peak memory {peak} bytes "
                 f"(params + grads + AdamW state {n_params * 16} bytes)")
    log("train", "phase medians " + json.dumps(phases))
    log("train", f"verdict (no FLOPs in process): {verdict.kind} ({verdict.severity}): {verdict.summary}")
    log("train", "sampler cost per tick (0.5 s tick) " + json.dumps(run["sampler_cost"]))
    check(run["launches"] == cfg.n_layers * STEPS,
          f"train flash launches {run['launches']} != {cfg.n_layers} x {STEPS}")
    check(len(rows) == STEPS, f"{len(rows)} train step rows for {STEPS} steps")
    check_train_rows("in-process train loop", [(r["step"], r["clock"], r["events"]) for r in rows])
    vals = [r["events"].get(T.STEP_TIME, {}).get("device_ms") for r in rows]
    check(all(v is not None and v > 0 for v in vals), "train step_time device_ms missing or not positive")
    check(not any(T.COMPUTE_TIME in r["events"] for r in rows), "a compute phase in the train rows")
    check(math.isfinite(last) and last < first, f"train loss did not fall: first {first}, last {last}")
    check(peak > n_params * 16, f"train step peak {peak} bytes below params + grads + AdamW state")
    return {"launches": run["launches"], "n_params": n_params,
            "step_ms": phases["STEP_TIME"]["device_ms_median"],
            "step_spread": spread(r["events"][T.STEP_TIME]["device_ms"] for r in rows)}


def launch_run(name: str, delay_ms: float, interval_s: float, script: str = "forward_script.py",
               steps: int = STEPS) -> dict:
    """One ``python -m traceml_tpu_torch run`` call of a ``dev/`` script;
    returns its session's artifacts, its system, process and step-memory
    rows, the launcher's output and the call's wall time."""
    logs = RUN_DIR / name
    shutil.rmtree(logs, ignore_errors=True)
    argv = [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary",
            "--logs-dir", str(logs), "--run-name", name, "--sampler-interval", repr(interval_s),
            str(REPO / "traceml_tpu_torch" / "dev" / script),
            "--", "--steps", str(steps), "--delay-ms", repr(delay_ms)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        # SIGTERM lets the launcher stop its rank and aggregator first
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
        raise CheckFailed(f"run {name} did not end within {RUN_TIMEOUT_S} s; stderr tail:\n{err[-3000:]}")
    wall_s = time.perf_counter() - t0
    (RUN_DIR / f"{name}.stdout.txt").write_text(out)
    (RUN_DIR / f"{name}.stderr.txt").write_text(err)
    check(proc.returncode == 0, f"run {name} exited {proc.returncode}; stderr tail:\n{err[-3000:]}")
    sessions = [p for p in logs.iterdir() if p.is_dir()]
    check(len(sessions) == 1, f"run {name}: {len(sessions)} session dirs")
    session = sessions[0]

    def read(fname):
        path = session / fname
        check(path.exists(), f"run {name}: {fname} missing")
        return json.loads(path.read_text())

    conn = sqlite3.connect(session / "telemetry.sqlite")
    conn.row_factory = sqlite3.Row
    try:
        rows = [tuple(r) for r in conn.execute(
            "SELECT step, clock, events_json FROM step_time_samples ORDER BY step")]
        tables = {t: [dict(r) for r in conn.execute(f"SELECT * FROM {t} ORDER BY id")]
                  for t in ("system_samples", "system_device_samples", "process_samples",
                            "process_device_samples", "step_memory_samples")}
    finally:
        conn.close()
    return {"summary": read("final_summary.json"), "manifest": read("manifest.json"),
            "ingest": read("ingest_stats.json"), "system_manifest": read("system_manifest.json"),
            "rows": rows, "tables": tables, "stdout": out, "wall_s": wall_s, "steps": steps}


def check_run(name: str, run: dict, n_layers: int, verdict) -> dict:
    """The run phase's gates on one call; returns its reported numbers.
    ``verdict`` is the expected primary verdict, or a function of the
    summary that gives it."""
    from traceml_tpu_torch.utils import timing as T

    summary, manifest, ingest = run["summary"], run["manifest"], run["ingest"]
    st, sm = summary["sections"]["step_time"], summary["sections"]["step_memory"]
    check(st["status"] == "OK", f"run {name}: step_time section {st['status']}")
    check(st["global"]["clock"] == "device", f"run {name}: step_time clock {st['global']['clock']}")
    check(st["global"]["n_steps"] >= 50, f"run {name}: {st['global']['n_steps']} steps in the window")
    check(sm["status"] == "OK" and sm["global"]["rollup"]["max_peak_bytes"] > 0,
          f"run {name}: no positive step-memory peak")
    check((manifest["status"], manifest["telemetry_status"]) == ("completed", "ok"),
          f"run {name}: manifest {manifest['status']}/{manifest['telemetry_status']}")
    producer = (ingest.get("producers") or {}).get("0") or {}
    drops = {"rows_dropped": ingest["rows_dropped"], "decode_errors": ingest["decode_errors"],
             "corrupt_frame_drops": sum(ingest["corrupt_frame_drops"].values()),
             "unknown_domain_drops": sum(ingest["unknown_domain_drops"].values()),
             "batches_dropped": (producer.get("transport") or {}).get("batches_dropped")}
    check(drops == {k: 0 for k in drops}, f"run {name}: telemetry dropped {drops}")
    check(ingest["finished_ranks"] == [0], f"run {name}: finished ranks {ingest['finished_ranks']}")
    n = run["steps"]
    steps = [r[0] for r in run["rows"]]
    check(steps == list(range(1, n + 1)), f"run {name}: step_time_samples hold steps {steps[:3]}..., "
                                          f"{len(steps)} rows for {n} steps")
    launch_lines = [l for l in run["stdout"].splitlines() if l.startswith("flash_attention.launches ")]
    launches = int(launch_lines[-1].split()[1]) if launch_lines else None
    check(launches == n_layers * n, f"run {name}: rank reports {launches} flash launches, "
                                    f"not {n_layers} x {n}")
    kind = summary["primary_diagnosis"]["kind"]
    log("run", f"{name}: verdict {kind} ({summary['primary_diagnosis']['severity']}): "
               f"{summary['primary_diagnosis'].get('summary')}")
    if callable(verdict):
        verdict = verdict(summary)
    check(kind == verdict, f"run {name}: final_summary.json says {kind}, not {verdict}")
    verdict_lines = [l for l in run["stdout"].splitlines() if "VERDICT" in l]
    check(any(verdict in l for l in verdict_lines), f"run {name}: launcher stdout verdict {verdict_lines}")
    device = [json.loads(r[2])[T.STEP_TIME]["device_ms"] for r in run["rows"]]
    check(all(r[1] == "device" for r in run["rows"]) and all(v is not None for v in device),
          f"run {name}: a stored step row is not on the device clock")
    # collect and encode cover every busy tick, the final one too; the
    # final batch carries these stats, so its send is in neither flush_us
    # nor flushes
    busy = producer["ticks"] - producer["idle_ticks"]
    samplers = producer["samplers"].values()
    cost = {
        "busy_ticks": busy,
        "collect_ms_per_busy_tick": sum(s["collect_us"] for s in samplers) / busy / 1e3,
        "encode_ms_per_busy_tick": sum(s["encode_us"] for s in samplers) / busy / 1e3,
        "flushes": producer["flushes"],
        "flush_ms_per_send": producer["flush_us"] / producer["flushes"] / 1e3 if producer["flushes"] else None,
    }
    return {
        "verdict": kind,
        "efficiency": st["global"].get("efficiency"),
        "step_device_ms": spread(device),
        "step_ms_summary": st["global"]["phases"]["step_time"]["median_ms"],
        "steady_state_ms": (st["global"].get("steady_state") or {}).get("median_ms"),
        "max_peak_bytes": sm["global"]["rollup"]["max_peak_bytes"],
        "flash_launches": launches,
        "producer": {"codec": producer["codec"], "ticks": producer["ticks"],
                     "idle_ticks": producer["idle_ticks"], **cost,
                     "bytes": sum(s["bytes"] for s in samplers)},
        "envelopes_ingested": ingest["envelopes_ingested"],
        "finalize_s": manifest.get("finalize_sec"),
        "wall_s": run["wall_s"],
        "telemetry": check_telemetry(name, run),
    }


def check_telemetry(name: str, run: dict) -> dict:
    """The system and process gates on one call: both sections OK; every
    host row with ``cpu_pct``; every GPU row with NVML utilization,
    temperature and power; the manifest's GPU name and power limit those
    of ``nvidia-smi``; RSS above 0; the process rows' GPU peak at least
    the largest step-memory peak.  Returns what NVML and psutil read, the
    recent means as the system rules read them."""
    from traceml_tpu_torch.diagnostics.system.rules import _recent_mean

    sections, tables = run["summary"]["sections"], run["tables"]
    for key in ("system", "process"):
        check(sections[key]["status"] == "OK", f"run {name}: {key} section {sections[key]['status']}")
    host, gpu = tables["system_samples"], tables["system_device_samples"]
    proc, proc_gpu = tables["process_samples"], tables["process_device_samples"]
    check(bool(host) and all(r["cpu_pct"] is not None for r in host), f"run {name}: host rows without cpu_pct")
    nvml = ("utilization_pct", "temperature_c", "power_w")
    check(bool(gpu) and all(r[k] is not None for r in gpu for k in nvml),
          f"run {name}: GPU rows without NVML counters ({len(gpu)} rows)")
    smi_name, smi_limit = (v.strip() for v in nvidia_smi().split(","))
    devices = run["system_manifest"].get("devices") or [{}]
    check(devices[0].get("nvml_name") == smi_name and
          abs(devices[0].get("power_limit_w", -1.0) - float(smi_limit.split()[0])) < 0.01,
          f"run {name}: manifest GPU {devices[0]} against nvidia-smi {smi_name}, {smi_limit}")
    check(bool(proc) and all(r["rss_bytes"] > 0 for r in proc), f"run {name}: process RSS not positive")
    step_peak = max((r["step_peak_bytes"] for r in tables["step_memory_samples"]), default=0)
    proc_peak = max(r["memory_peak_bytes"] for r in proc_gpu) if proc_gpu else 0
    check(proc_peak >= step_peak, f"run {name}: process GPU peak {proc_peak} below step peak {step_peak}")
    util = [r["utilization_pct"] for r in gpu]
    return {
        "system_verdict": sections["system"]["diagnosis"]["kind"],
        "process_verdict": sections["process"]["diagnosis"]["kind"],
        "gpu_rows": len(gpu), "host_rows": len(host), "process_rows": len(proc),
        "utilization_pct_recent_mean": _recent_mean(gpu, "utilization_pct"),
        "utilization_pct_mean_all_rows": statistics.fmean(util),
        "utilization_pct_series": util,
        "temperature_c_max": max(r["temperature_c"] for r in gpu),
        "power_w_recent_mean": _recent_mean(gpu, "power_w"),
        "host_cpu_pct_recent_mean": _recent_mean(host, "cpu_pct"),
        "process_cpu_pct_recent_mean": _recent_mean(proc, "cpu_pct"),
        "rss_bytes_max": max(r["rss_bytes"] for r in proc),
        "process_gpu_peak_bytes": proc_peak, "step_memory_peak_bytes": step_peak,
        "manifest_gpu": devices[0],
    }


def run_phase(main: dict) -> None:
    """``python -m traceml_tpu_torch run`` on the card, healthy with a fast
    sender tick and with the main path's input delay at the default tick,
    held to the gates of ``check_run``."""
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    for name, delay_ms, interval_s, steps, verdict in (
            ("healthy", 0.0, 0.1, RUN_FORWARD_STEPS, "COMPUTE_BOUND"),
            ("input_delay", main["delay_ms"], 1.0, STEPS, "INPUT_BOUND")):
        got = check_run(name, launch_run(name, delay_ms, interval_s, steps=steps), main["n_layers"], verdict)
        log("run", f"{name} (delay {delay_ms:.3f} ms, sender tick {interval_s} s) " + json.dumps(got))
        if name == "healthy":
            run_ms, ref_ms = got["step_device_ms"], main["step_ms"]
            log("run", "step device ms under run (stored rows) vs in-process (no sender): " + ", ".join(
                f"{k} {run_ms[k]:.4f} vs {ref_ms[k]:.4f} ({run_ms[k] / ref_ms[k]:.4f}x)" for k in run_ms)
                + f"; {got['producer']['busy_ticks']} busy sender ticks")


def mfu_verdict(summary: dict) -> str:
    """The healthy train run's verdict by the band of its measured MFU
    (``diagnostics/step_time/policy.py``): LOW_MFU (warning) below 15%;
    from 15% to 30% MODERATE_MFU (info) must be among the issues, and the
    verdict is whichever of it and COMPUTE_BOUND scores higher; at 30% or
    more, COMPUTE_BOUND."""
    st = summary["sections"]["step_time"]
    mfu = st["global"]["efficiency"]["mfu_median"]
    kinds = [i["kind"] for i in st["issues"]]
    if mfu < 0.15:
        return "LOW_MFU"
    if mfu < 0.30:
        check("MODERATE_MFU" in kinds, f"MFU {mfu} but no MODERATE_MFU issue: {kinds}")
        return kinds[0] if kinds[0] in ("MODERATE_MFU", "COMPUTE_BOUND") else "MODERATE_MFU"
    return "COMPUTE_BOUND"


def train_run_phase(cfg, train: dict) -> None:
    """``python -m traceml_tpu_torch run`` of ``dev/train_script.py``:
    healthy with a 0.1 s sender tick, and with a host input delay of 3x
    the in-process train step at the default tick.  The forward run's
    gates, and: the stored rows held to ``check_train_rows``, the loss
    falling, an ``efficiency`` section with the
    card's peak, model FLOPs within ``FLOPS_REL_TOL`` of the analytic
    count and an MFU in (0, 1), and the verdict of the MFU's band."""
    from traceml_tpu_torch.dev.workload import TRAIN_TOKENS
    from traceml_tpu_torch.utils.chip_specs import peak_flops_for

    analytic = analytic_train_flops(cfg, BATCH, TRAIN_TOKENS - 1)
    peak = peak_flops_for(torch.cuda.get_device_name(0))
    check(peak is not None, f"no peak FLOP/s for {torch.cuda.get_device_name(0)}")
    delay_ms = 3.0 * train["step_ms"]
    for name, delay, interval_s, verdict in (("train_healthy", 0.0, 0.1, mfu_verdict),
                                             ("train_input_delay", delay_ms, 1.0, "INPUT_BOUND")):
        run = launch_run(name, delay, interval_s, script="train_script.py")
        got = check_run(name, run, cfg.n_layers, verdict)
        check_train_rows(
            f"run {name}", [(step, clock, json.loads(ev)) for step, clock, ev in run["rows"]])
        loss_lines = [l for l in run["stdout"].splitlines() if "loss first" in l]
        check(bool(loss_lines), f"run {name}: no loss line")
        words = loss_lines[-1].split()
        first, last = float(words[words.index("first") + 1]), float(words[words.index("last") + 1])
        check(last < first, f"run {name}: loss first {first} last {last}")
        eff = got["efficiency"] or {}
        flops = eff.get("flops_per_step")
        check(flops is not None and abs(flops - analytic) / analytic <= FLOPS_REL_TOL,
              f"run {name}: flops_per_step {flops} vs analytic {analytic}")
        check(eff.get("peak_tflops") == peak / 1e12, f"run {name}: peak {eff.get('peak_tflops')} TFLOP/s")
        mfu = eff.get("mfu_median")
        check(mfu is not None and 0.0 < mfu < 1.0, f"run {name}: MFU {mfu}")
        log("run", f"{name} (delay {delay:.3f} ms, sender tick {interval_s} s; analytic {analytic:.6e} "
                   f"FLOPs/step; loss first {first} last {last}) " + json.dumps(got))
        if name == "train_healthy":
            util = got["telemetry"]["utilization_pct_recent_mean"]
            check(util >= UTIL_HEALTHY_MIN_PCT,
                  f"run {name}: NVML utilization {util}% (last 30 samples) below {UTIL_HEALTHY_MIN_PCT}%")
            run_ms, ref_ms = got["step_device_ms"], train["step_spread"]
            log("run", "train step device ms under run vs in-process: " + ", ".join(
                f"{k} {run_ms[k]:.4f} vs {ref_ms[k]:.4f} ({run_ms[k] / ref_ms[k]:.4f}x)" for k in run_ms))


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a CUDA card", file=sys.stderr)
        return 2
    from traceml_tpu_torch.ops import _build

    smi = nvidia_smi()
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
    main_path = main_path_phase()
    torch.cuda.empty_cache()  # the rank processes below hold their own model
    log("time", f"main path and fault phases {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    grad_check_phase()
    from traceml_tpu_torch.dev.workload import full_width_config

    cfg = full_width_config()
    lm_head_phase(cfg)
    torch.cuda.empty_cache()
    train = train_path_phase(cfg)
    kernel["launches"] = main_path["launches"] + train["launches"]
    kernel["launches_by_path"] = {"forward": main_path["launches"], "train": train["launches"]}
    torch.cuda.empty_cache()
    log("time", f"train phases {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    run_phase(main_path)
    train_run_phase(cfg, train)
    log("time", f"run phase {time.perf_counter() - t0:.2f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
