#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``traceml_tpu_torch``.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

1. Builds every CUDA kernel of the port from ``traceml_tpu_torch/csrc``.
   It prints what ``ptxas`` says of each instantiation: registers,
   shared memory, spills and warnings.  Then it builds the transport
   tier's two C extensions (``traceml_tpu_torch/native/{framing,ring}.c``)
   and logs their paths and build times; a failed build or load, or
   ``TRACEML_NO_NATIVE``, fails the run (the port itself would fall back
   to the Python twins).
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
   full-width loop through the kernel and ships its rows through its
   shared-memory ring (the default transport on one host); the aggregator
   stores them in SQLite and writes ``final_summary.json``.  Every ``run``
   call of every phase below is held to ``check_transport``: all its
   frames by the expected transport (``shm`` unless the phase pins
   another), every rank's ``transport_hello`` naming it with the expected
   codec and no fallback, and no ring segment, descriptor or Unix socket
   of the session left once the launcher exits.  The healthy forward runs
   once more pinned to ``tcp`` (``TRACEML_TRANSPORT=tcp``), its step
   reported against the ring's, not gated (the host paces the forward);
   its verdict is gated, so it runs ``RUN_FORWARD_STEPS`` steps too.
   Gates: the summary's step-time section on the device clock with at
   least 50 steps, its step-memory section with a positive peak, one
   ``step_time_samples`` row per traced step, the manifest ``completed``
   with telemetry ``ok``, no dropped rows or decode errors, 12 × 60 flash
   launches in the rank, the liveness section OK with the rank finished,
   and the verdict in the summary and on the launcher's stdout: the band
   of the measured MFU for the healthy runs (LOW_MFU below 15%, then
   MODERATE_MFU to 30%, then COMPUTE_BOUND; the forward's FLOPs come from
   ``wrap_step_fn``'s first in-step call, within 2% of the analytic
   count), INPUT_BOUND with the delay.  The train runs also need their stored
   rows to meet the in-process loop's device-clock gates, the loss
   falling, and an ``efficiency`` section with the card's peak,
   ``flops_per_step`` within 2% of the analytic count and an MFU in
   (0, 1).  Every run's ``system`` and ``process`` sections must be OK,
   with ``cpu_pct`` on every host row, NVML utilization, temperature and
   power on every GPU row, ``system_manifest.json`` naming the card and
   its power limit as ``nvidia-smi`` does, RSS above 0 and the process
   rows' GPU peak at least the largest step-memory peak; the healthy
   train run's NVML utilization, as the system rules read it (the mean of
   the last 30 samples), must be at least ``UTIL_HEALTHY_MIN_PCT``.
   Reported: the step device times under ``run`` (median, mean,
   p90, max) against the in-process loop's, which runs no sender; the
   sender's busy ticks, its collect and encode cost per busy tick, its
   flush cost per timed send and its codec, the aggregator's
   finalization time and each call's wall time.  The sessions are kept
   under ``traceml_logs/chip_smoke/``.
6. Remat, H2D, tokens, the final summary and a dead rank: the train step
   with each block checkpointed (``ModelConfig.remat``) against the step
   without, then traced in process under ``init(mode="auto",
   traced_model=model)`` (``remat_train_phase``: 24 launches a step, a
   lower peak, FLOPs with the recompute); ``run`` of ``train_script.py
   --remat --h2d to --tokens --final-summary`` (``remat_run_phase``: the
   ``torch_h2d`` patch's h2d device time on every row, tokens/s,
   ``final_summary()`` against the final artifact); ``run`` of
   ``train_script.py --kill-after 20`` under short liveness thresholds
   (``killed_run_phase``: RANK_LOST, critical, the primary diagnosis).

7. The live display (``cli_run_phase``): ``run --mode cli`` of
   ``train_script.py`` at full width, healthy at the 0.1 s tick, held to
   the healthy train run's gates, and: the rank's lines on the launcher's
   stdout, then the dashboard's last frame once; ``stdout_samples`` and
   ``rank_0/stdout.log`` holding those lines in order; the frame's median
   step within ``FRAME_STEP_REL_TOL`` of ``final_summary.json``'s and its
   rank-0 output panel showing the script's last line.  The display runs
   on the window engines (the default: the incremental step-time window,
   the vector rule arms, the diagnosis cache), and the run's report
   carries ``meta.window_build``.  Reported: the ``cli`` run's step
   against the ``summary`` train run's, the same for the forward script
   (``STEPS`` steps, not gated), and the live tick's cost
   (``LiveComputer.payload()`` plus one render) in process on twin copies
   of the finished session DB, the engines on one and the three switches
   (``TRACEML_COLUMNAR_WINDOW``, ``TRACEML_INCR_WINDOW``,
   ``TRACEML_VECTOR_DIAGNOSIS``) at 0 on the other, first, dirty and idle,
   with every dirty tick's payloads gated equal (``canon_payload``) and
   the engine's window extended more often than rebuilt.

8. The HTML report and the browser dashboard.  Every ``run`` call above
   (forward, train, remat, the killed run, ``cli``) and the one below
   must leave a ``final_summary.html`` that parses with ``html.parser``,
   whose banner holds ``final_summary.json``'s primary kind, whose
   step-time phase table, step chart, device-memory and process tables
   have one row (line) per phase or rank of the JSON, and that names no
   JAX or TPU word (``check_html``).  ``dashboard_run_phase``: ``run
   --mode dashboard`` of ``train_script.py`` at full width for
   ``DASHBOARD_STEPS`` steps (healthy, 0.1 s tick), read while the rank
   trains by a ``DashboardProbe`` (``/healthz``, ``/``, ``/api/live``
   with its ETag, ``?since=`` delta and gzip paths, ``/api/stream``, and
   one stream held open across the run's end), held to the healthy train
   run's gates and the dashboard's; the last ``/api/live`` carries the
   window engine's ``window_build`` (more incremental builds than full
   ones, no vector fallback).  Reported: its step against the
   ``summary`` train run's, the serving tier's poll cost on its finished
   DB (``serving_cost``) and ``render_html_summary``'s on the ``summary``
   train run's payload.

9. The aggregator's crash-resume (``aggregator_restart_phase``): ``run
   --mode summary`` of ``train_script.py`` at full width (one rank, 60
   steps, 0.1 s tick) whose aggregator a ``TRACEML_FAULT_PLAN`` kill9
   rule SIGKILLs ``RESTART_KILL_AT`` of the way into the loop (counted in
   payloads from the healthy ``summary`` train run).  The launcher
   restarts it on the pinned port, the rank replays its spool, the
   writer drops duplicates by seq.  Gates: the healthy train run's
   (device clock, 12 x 60 launches, the MFU's band, the HTML) with the
   manifest ``completed`` / ``restarted`` / one restart; ``restarting``
   on stdout; the stored (rank, step) pairs each once and equal to the
   healthy run's; every rank in the summary's ``ranks_seen``; the kill
   and the restart inside the loop.  Reported:
   the kill's step, the time from the launcher's notice to the new ready
   file, reconnects, replayed envelopes, spool bytes, replay duplicates,
   and the step against the healthy run's.  The phase runs twice: over
   the shm ring (the default; also no ring-full drop: the restarted
   aggregator re-attaches the ring and drains its uncommitted window
   again) and pinned to ``tcp``.  Then ``transport_run_phase``: the
   healthy train run over the Unix socket with zstd envelope compression
   (zlib where ``libzstd.so.1`` does not load), held to the healthy train
   gates, every frame over ``uds``, compressed envelopes restored with no
   error; its compression ratio and step against the healthy run's.

10. A long run kept bounded (``bounded_run_phase``): ``run --mode cli``
   of ``train_script.py`` at full width for ``BOUNDED_STEPS`` steps with
   ``--trace-max-steps BOUNDED_CAP --summary-window-rows BOUNDED_WINDOW
   --disk-backup --no-capture-stderr``.  Gates: the run's (exit 0, the
   MFU's band, the device clock, 12 launches a step, system and process,
   the HTML); the recording stop as the JAX runtime does it (every step
   in the rank's disk backup once, steps past the drain tick from the
   final drain, no system or process row while recording is stopped,
   ``rank_finished`` before the loop's end); retention (no partition
   over its retention after ``finalize``, an online prune during the
   loop, the 10 s tier plus the raw survivors equal to the backup's
   steps in count and ``step_ms`` sum); the report's ``history`` block
   and "History:" line; ``view`` and ``inspect`` (every backup frame
   decodes, ``--domain rollup`` lists the tiers); the stderr marker on
   the launcher's stderr and nowhere in the captured output.  Reported:
   the step against the healthy ``summary`` train run's, backup bytes per
   step, prune counts and p99, tier rows, the read commands' wall time.

11. The transport tier in process (``transport_phase``): every envelope
   of the bounded run's disk backup, one a frame, through each arm of
   ``traceml_tpu_torch/dev/transport_bench.py`` (tcp with the C and the
   Python frame split, uds, shm with ``ring.c`` and the Python twin,
   tcp with zstd and with zlib), each arm's decoded list gated equal to
   the backup's envelopes; frames/s, MB/s, native over Python, shm over
   tcp, and each codec's µs an envelope and ratio reported.

12. The code manifest, cross-run baselines and ``compare`` (run with the
   train runs of 5, before 6): every ``run`` call's ``code_manifest.json``
   must be the static scan of its script (``check_code_manifest``:
   ``torch``, ``adamw`` for ``train_script.py``, the launcher's
   ``code_manifest_ms``).  A second healthy train run (``train_healthy_2``,
   60 steps) and the delayed one run under the healthy run's logs dir and
   run name, so one ``traceml_baselines.sqlite`` judges each
   (``baseline_compare_phase``): ``no_baseline``, ``ok`` over one run,
   ``regression`` over two with a PERF_REGRESSION on ``steady_step_ms``
   above +100% and a ``[baseline]`` line; ``regressions.json``, the
   dashboard's meta fragment and a re-finalize on a copy of the store
   give the same section; ``python -m traceml_tpu_torch compare`` of the
   healthy pair is neither REGRESSION nor LIKELY_REGRESSION with no
   step-time finding, of healthy and delayed REGRESSION.  Reported with
   the card's line: the steps, the scan's and the re-evaluation's ms, both
   verdicts.  The second healthy run's launches have their own path,
   ``train_baseline_run``, on the kernels line.

13. The window engines at many ranks (``engine_tick_phase``, after 7):
   the ``cli`` train run's rank-0 rows fanned out to ``ENGINE_RANKS``
   ranks (a 32-node x 8-GPU job; seeded per-rank jitter, one rank
   ``ENGINE_SLOW`` x slower) into twin databases through the port's
   writer, a ``LiveComputer`` on each, the engines on one and the three
   switches at 0 on the other: a first tick, ``ENGINE_TICKS`` dirty ticks
   of one row per rank, as many idle ticks.  Gates: the payloads equal on
   every dirty tick, both verdicts naming the slow rank, the engine's
   window extended more often than rebuilt, the two databases' reports
   equal (timestamps and ``meta.window_build`` aside).  Reported: ms a
   tick for each arm, their ratio, the builds by path and reason.

14. The collectives domain and the mesh (``collectives_run_phase``,
   ``comm_bound_run_phase``, last): ``run --mode summary`` of
   ``train_script.py`` at full width with ``--mesh --grad-sync
   all_reduce``: the rank joins a one-rank NCCL process group
   (``MASTER_ADDR`` and ``MASTER_PORT`` from this script's environment),
   builds ``make_mesh()`` and, after each backward, all-reduces its flat
   f32 gradients (700,551,168 bytes) through ``instrument_collective``.
   ``train_collectives`` (60 steps, ``--disk-backup``): the healthy train
   gates, the collectives section OK (``all_reduce``, ``float32``, group
   size 1, 700,551,168 bytes a step), ALLREDUCE_QUANTIZABLE at 668.1
   MiB/step, no COMM_BOUND, the one-rank four-axis mesh in the database
   and ``meta``, ``inspect`` printing ``overlap_efficiency``, and the
   steady step at most 1.10x ``train_healthy``'s.  ``train_comm_bound``
   (30 steps): the sync synchronizes the device and stalls 100 ms on the
   host before its all-reduce; COMM_BOUND in the collectives section.
   Both runs' flash launches have their own paths on the kernels line.

Any failed check exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import gzip
import html.parser
import http.client
import json
import math
import os
import re
import shutil
import signal
import sqlite3
import statistics
import subprocess
import sys
import threading
import time
import traceback
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
RUN_FORWARD_STEPS = 300  # ~5 s of the healthy forward at the 0.1 s tick (the system rules' last 30 samples)
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


def _matmul_params(cfg) -> tuple:
    """Per layer: the block's matmul weights, and those of its last
    projection (``w_down``); and the ``lm_head``'s."""
    hd = cfg.head_dim
    per_layer = (2 * cfg.hidden * cfg.n_heads * hd + 2 * cfg.hidden * cfg.n_kv_heads * hd
                 + 3 * cfg.hidden * cfg.ffn_hidden)
    return per_layer, cfg.hidden * cfg.ffn_hidden, cfg.hidden * cfg.vocab_size


def analytic_train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 x the matmul parameters x the
    tokens (forward 2, backward 4), plus causal attention counted over
    the full S x S products as XLA counts the jnp path, 4·S²·D per head
    forward and 8·S²·D backward."""
    per_layer, _, head = _matmul_params(cfg)
    matmul_params = cfg.n_layers * per_layer + head
    attention = 12 * batch * cfg.n_heads * seq * seq * cfg.head_dim * cfg.n_layers
    return 6.0 * matmul_params * batch * seq + attention


def analytic_remat_flops(cfg, batch: int, seq: int) -> float:
    """The train step's FLOPs with each block checkpointed: the step's,
    plus each block's forward again in the backward but for its last
    projection, whose output the backward does not need
    (``torch.utils.checkpoint`` stops the recompute there, and XLA leaves
    it out of the rematerialized program; measured on the CPU at small
    size, ``tests/test_torch_train_step.py``)."""
    per_layer, w_down, _ = _matmul_params(cfg)
    recompute = (2.0 * (per_layer - w_down) * batch * seq
                 + 4 * batch * cfg.n_heads * seq * seq * cfg.head_dim) * cfg.n_layers
    return analytic_train_flops(cfg, batch, seq) + recompute


def analytic_forward_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one forward: 2 x the matmul parameters x the tokens,
    plus 4·S²·D per head and layer of attention."""
    per_layer, _, head = _matmul_params(cfg)
    matmul_params = cfg.n_layers * per_layer + head
    return 2.0 * matmul_params * batch * seq + 4 * batch * cfg.n_heads * seq * seq * cfg.head_dim * cfg.n_layers


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


def train_compare_phase(batches, routes, tag: str = "train") -> None:
    """The full-width train step through one route against another from
    the same weights on the same batches: the first step's gradients, the
    loss of each of ``COMPARE_STEPS`` steps and each parameter's update
    after them, by checks that scale with the output.  ``routes`` is
    ``((name, cfg, plain), (name, cfg, plain))``, the route under test
    first; ``plain`` runs attention through ``flash_attention_plain`` on
    the card, differentiated by autograd."""
    from contextlib import nullcontext

    from traceml_tpu_torch.dev.attention_check import scaled_errors
    from traceml_tpu_torch.dev.workload import build_train_state
    from traceml_tpu_torch.models.transformer import loss_fn, make_train_step
    from traceml_tpu_torch.ops import attention as attention_mod
    from traceml_tpu_torch.ops.flash_attention import flash_attention_plain

    tokens = [b.cuda() for b in batches[:COMPARE_STEPS]]
    got, start = {}, None
    for route, cfg, use_plain in routes:
        model, optimizer = build_train_state(cfg, SEED)
        if start is None:
            start = {n: p.detach().clone() for n, p in model.named_parameters()}
        plain = mock.patch.object(attention_mod, "flash_attention", flash_attention_plain)
        with plain if use_plain else nullcontext():
            loss_fn(model, tokens[0]).backward()
            grads = {n: p.grad for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            step = make_train_step(model, optimizer)
            losses = [step(t)["loss"].item() for t in tokens]
        got[route] = {"losses": losses, "grads": grads,
                      "updates": {n: p.detach() - start[n] for n, p in model.named_parameters()}}
        del model, optimizer, step
    (name_k, _, _), (name_p, _, _) = routes
    k, p = got[name_k], got[name_p]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(k["losses"], p["losses"])]
    grad_rel = {n: scaled_errors(k["grads"][n], p["grads"][n])["rel_fro"] for n in p["grads"]}
    update_rel = {n: (k["updates"][n] - p["updates"][n]).norm().item() / p["updates"][n].norm().item()
                  for n in p["updates"]}
    worst_grad = max(grad_rel, key=grad_rel.get)
    worst_update = max(update_rel, key=update_rel.get)
    log(tag, json.dumps({
        "routes": [name_k, name_p],
        f"losses_{name_k}": k["losses"], f"losses_{name_p}": p["losses"], "loss_rel": loss_rel,
        "grad_rel_fro_max": [worst_grad, grad_rel[worst_grad]],
        "grad_rel_fro_median": statistics.median(grad_rel.values()),
        "update_rel_fro_max": [worst_update, update_rel[worst_update]],
        "update_rel_fro_median": statistics.median(update_rel.values()),
        "tol": {"loss_rel": TRAIN_LOSS_REL, "grad_rel_fro": TRAIN_GRAD_REL_FRO,
                "update_rel_fro": TRAIN_UPDATE_REL_FRO}}))
    check(all(math.isfinite(x) for x in k["losses"]), f"non-finite train loss through the {name_k} route")
    check(max(loss_rel) <= TRAIN_LOSS_REL, f"train loss {name_k} vs {name_p}: {loss_rel}")
    check(grad_rel[worst_grad] <= TRAIN_GRAD_REL_FRO,
          f"gradient of {worst_grad} {name_k} vs {name_p}: rel_fro {grad_rel[worst_grad]}")
    check(update_rel[worst_update] <= TRAIN_UPDATE_REL_FRO,
          f"update of {worst_update} {name_k} vs {name_p}: rel_fro {update_rel[worst_update]}")


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
    train_compare_phase(batches, (("kernel", cfg, False), ("plain", cfg, True)))
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
    return {"launches": run["launches"], "n_params": n_params, "peak": peak,
            "step_ms": phases["STEP_TIME"]["device_ms_median"],
            "step_spread": spread(r["events"][T.STEP_TIME]["device_ms"] for r in rows)}


def remat_train_phase(cfg, train: dict) -> dict:
    """The train step with each block checkpointed (``ModelConfig.remat``):
    three steps against the step without remat on the same weights and
    batches, held to the train step's gates; then a traced loop in
    process under ``init(mode="auto", traced_model=model)``, its model
    FLOPs counted on the warm-up step.  Gates: forward, backward and
    optimizer device times on every row and one forward a step (the
    recompute inside the backward is no forward), 2 x 12 flash launches a
    step (the recompute runs the kernel again), a step peak below the
    non-remat loop's, and ``flops_per_step`` within ``FLOPS_REL_TOL`` of
    ``analytic_remat_flops``."""
    import dataclasses

    import traceml_tpu_torch as tm
    from traceml_tpu_torch.dev.workload import TRAIN_TOKENS, build_train_state, host_batches
    from traceml_tpu_torch.models.transformer import make_train_step
    from traceml_tpu_torch.sdk.initial import shutdown_patches
    from traceml_tpu_torch.sdk.state import get_state
    from traceml_tpu_torch.utils import timing as T

    rcfg = dataclasses.replace(cfg, remat=True)
    batches = host_batches(cfg, SEED + 1, seq=TRAIN_TOKENS)
    train_compare_phase(batches, (("remat", rcfg, False), ("no_remat", cfg, False)), tag="remat")
    model, optimizer = build_train_state(rcfg, SEED)
    step = make_train_step(model, optimizer)
    shutdown_patches()
    tm.init(mode="auto", traced_model=model)
    flops = tm.estimate_step_flops(step, batches[0].cuda())  # the warm-up step, outside the trace
    analytic = analytic_remat_flops(cfg, BATCH, TRAIN_TOKENS - 1)
    run = traced_loop(step, batches, STEPS, 0.0)
    rows, mem = run["rows"], run["memory"]
    first, last = run["first"]["loss"].item(), run["last"]["loss"].item()
    peak = max((m["step_peak_bytes"] for m in mem), default=0)
    phases = {name: phase_medians(rows, name)
              for name in ("STEP_TIME", "FORWARD_TIME", "BACKWARD_TIME", "OPTIMIZER_STEP", "H2D_TIME")}
    out = {"launches": run["launches"], "flops_per_step": flops, "analytic_flops": analytic,
           "flops_rel_err": abs(flops - analytic) / analytic, "step_peak_bytes": peak,
           "no_remat_step_peak_bytes": train["peak"], "step_ms": phases["STEP_TIME"]["device_ms_median"],
           "no_remat_step_ms": train["step_ms"], "loss_first": first, "loss_last": last,
           "patches": get_state().patches}
    log("remat", f"{STEPS} traced remat train steps in {run['wall_s']:.4f} s wall " + json.dumps(out))
    log("remat", "phase medians " + json.dumps(phases))
    check(run["launches"] == 2 * cfg.n_layers * STEPS,
          f"remat flash launches {run['launches']} != 2 x {cfg.n_layers} x {STEPS}")
    check(len(rows) == STEPS, f"{len(rows)} remat step rows for {STEPS} steps")
    check_train_rows("in-process remat loop", [(r["step"], r["clock"], r["events"]) for r in rows])
    counts = [r["events"][T.FORWARD_TIME]["count"] for r in rows]
    check(counts == [1] * STEPS, f"remat rows with a forward count other than 1: {counts}")
    check(math.isfinite(last) and last < first, f"remat loss did not fall: first {first}, last {last}")
    check(0 < peak < train["peak"], f"remat step peak {peak} not below the non-remat peak {train['peak']}")
    check(out["flops_rel_err"] <= FLOPS_REL_TOL, f"remat flops_per_step {flops} vs analytic {analytic}")
    del model, optimizer, step
    return out


def launch_run(name: str, delay_ms: float, interval_s: float, script: str = "forward_script.py",
               steps: int = STEPS, script_args=(), launcher_args=(), env_extra=None,
               expect_ok: bool = True, mode: str = "summary", probe=None, transport: str = "shm",
               codec=None, join: str = None) -> dict:
    """One ``python -m traceml_tpu_torch run --mode <mode>`` call of a
    ``dev/`` script; returns its session's artifacts, its system, process,
    step-memory (and in the live modes stdout) rows, the launcher's output
    and the call's wall time.  The call must exit 0, or, with
    ``expect_ok=False``, must not.  Every call's ``final_summary.html`` is
    held to ``check_html``, and its telemetry's path to
    ``check_transport``: ``transport`` (the default ``shm``, the ring that
    ``auto`` picks on one host) with ``codec``.  A ``probe``
    (``DashboardProbe``) runs on a thread beside the call, from its start
    to its end.  ``join`` names an earlier call whose logs dir and run name
    this call shares, so that the baseline store there holds that call's
    run: the dir is kept and the call's session is the one it adds.  Every
    call's ``code_manifest.json`` is held to ``check_code_manifest``."""
    logs = RUN_DIR / (join or name)
    if join is None:
        shutil.rmtree(logs, ignore_errors=True)
    before = {p for p in logs.iterdir() if p.is_dir()} if logs.is_dir() else set()
    argv = [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", mode,
            "--logs-dir", str(logs), "--run-name", join or name, "--sampler-interval", repr(interval_s),
            *launcher_args, str(REPO / "traceml_tpu_torch" / "dev" / script),
            "--", "--steps", str(steps), "--delay-ms", repr(delay_ms), *script_args]
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    probe_thread = None
    if probe is not None:
        probe_thread = threading.Thread(target=probe.run, args=(logs,), name=f"probe-{name}", daemon=True)
        probe_thread.start()
    try:
        out, err = proc.communicate(timeout=RUN_TIMEOUT_S)
        if probe_thread is not None:
            probe.run_ended_at = time.monotonic()
            probe.done.set()
            probe_thread.join(timeout=60)
            check(not probe_thread.is_alive(), f"run {name}: the dashboard probe did not end")
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
    check((proc.returncode == 0) == expect_ok,
          f"run {name} exited {proc.returncode}; stderr tail:\n{err[-3000:]}")
    sessions = [p for p in logs.iterdir() if p.is_dir() and p not in before]
    check(len(sessions) == 1, f"run {name}: {len(sessions)} new session dirs")
    session = sessions[0]

    def read(fname, required=True):
        path = session / fname
        check(path.exists() or not required, f"run {name}: {fname} missing")
        return json.loads(path.read_text()) if path.exists() else None

    conn = sqlite3.connect(session / "telemetry.sqlite")
    conn.row_factory = sqlite3.Row
    try:
        rows = [tuple(r) for r in conn.execute(
            "SELECT step, clock, events_json FROM step_time_samples ORDER BY step")]
        tables = {t: [dict(r) for r in conn.execute(f"SELECT * FROM {t} ORDER BY id")]
                  for t in ("system_samples", "system_device_samples", "process_samples",
                            "process_device_samples", "step_memory_samples")
                  + (("stdout_samples",) if mode in ("cli", "dashboard") else ())}
    finally:
        conn.close()
    summary = read("final_summary.json")
    html_gate = check_html(name, session, summary)
    ingest = read("ingest_stats.json")
    manifest = read("manifest.json")
    code = check_code_manifest(name, REPO / "traceml_tpu_torch" / "dev" / script, read("code_manifest.json"),
                               manifest)
    return {"summary": summary, "html": html_gate, "manifest": manifest, "code_manifest": code,
            "ingest": ingest, "transport": check_transport(name, session, ingest, transport, codec),
            "system_manifest": read("system_manifest.json", required=expect_ok),
            "rows": rows, "tables": tables, "stdout": out, "stderr": err, "wall_s": wall_s, "steps": steps,
            "mode": mode, "session": session, "interval_s": interval_s}


def check_code_manifest(name: str, script: Path, code: dict, manifest: dict) -> dict:
    """``code_manifest.json`` of one call: the static scan of the script
    (``analyze_project`` in this process gives the same, ``generated_at``
    aside), ``framework`` torch, ``adamw`` among the optimizer hints of
    ``train_script.py``; the launcher's ``code_manifest_ms`` in the run
    manifest.  Returns the hints and the scan's time."""
    from traceml_tpu_torch.launcher.ast_scan import analyze_project

    check(code.pop("generated_at", 0) > 0, f"run {name}: code_manifest.json has no generated_at")
    check(code == analyze_project(script), f"run {name}: code_manifest.json is not the scan of {script.name}")
    check(code["framework"] == "torch", f"run {name}: code manifest framework {code['framework']}")
    if script.name == "train_script.py":
        check("adamw" in code["optimizer_hints"], f"run {name}: optimizer hints {code['optimizer_hints']}")
    ms = manifest.get("code_manifest_ms")
    check(isinstance(ms, float) and ms > 0, f"run {name}: manifest code_manifest_ms {ms}")
    return {"framework": code["framework"], "optimizer_hints": code["optimizer_hints"],
            "modules_scanned": code["modules_scanned"], "scan_ms": ms}


def check_transport(name: str, session: Path, ingest: dict, kind: str, codec) -> dict:
    """The transport gates on one call: every frame came by ``kind`` (and
    some did), every rank's ``transport_hello`` names ``kind`` and
    ``codec`` with no fallback, and the launcher left no ring segment,
    descriptor or Unix socket of the session.  Returns the ``transports``
    block."""
    from traceml_tpu_torch.transport.select import default_uds_path
    from traceml_tpu_torch.transport.shm_ring import ring_segment_path

    block = ingest.get("transports") or {}
    frames = block.get("frames_by_kind") or {}
    check(set(frames) == {kind} and frames[kind] > 0, f"run {name}: frames by transport {frames}, not {kind}")
    hellos = block.get("ranks") or {}
    check(bool(hellos) and all(h == {"transport": kind, "compression": codec} for h in hellos.values()),
          f"run {name}: transport hellos {hellos}, not {kind} with codec {codec}")
    ranks = sorted(int(r) for r in hellos)
    left = [str(p) for r in ranks for p in (ring_segment_path(session, r), session / f"rank_{r}" / "shm_ring.json")
            if p.exists()] + [p for p in (default_uds_path(session),) if os.path.exists(p)]
    check(not left, f"run {name}: transport files left after the run: {left}")
    return block


#: a word of the JAX package's platform, which no page or report of the port may hold
JAX_WORDS = re.compile(r"\b(?:jax|tpus?|libtpu|xla|ici)\b", re.IGNORECASE)


class _HTMLTables(html.parser.HTMLParser):
    """The tables of ``final_summary.html``, each under the ``<h2>`` before
    it, as lists of rows of cell texts; the banner's text; the step
    chart's polylines."""

    def __init__(self) -> None:
        super().__init__()
        self.tables, self.heading, self.banner, self.polylines = [], None, "", 0
        self._in = None
        self._row = None

    def handle_starttag(self, tag, attrs):
        attrs = dict(attrs)
        if tag == "h2":
            self._in, self.heading = "h2", ""
        elif tag == "div" and attrs.get("class") == "verdict":
            self._in = "banner"
        elif tag == "table":
            self.tables.append((self.heading, []))
        elif tag == "tr":
            self._row = []
            self.tables[-1][1].append(self._row)
        elif tag in ("td", "th") and self._row is not None:
            self._row.append("")
        elif tag == "polyline":
            self.polylines += 1

    def handle_endtag(self, tag):
        if tag == "h2" or (tag == "div" and self._in == "banner"):
            self._in = None

    def handle_data(self, data):
        if self._in == "h2":
            self.heading += data
        elif self._in == "banner":
            self.banner += data
        elif self._row:
            self._row[-1] += data


def check_html(name: str, session: Path, summary: dict) -> dict:
    """``final_summary.html`` of one call: it parses with ``html.parser``;
    its banner holds the primary diagnosis's kind; its step-time phase
    table has one row per phase of the JSON, its step chart one line per
    rank, its device-memory and process tables one row per rank; it names
    no JAX or TPU word."""
    path = session / "final_summary.html"
    check(path.exists(), f"run {name}: final_summary.html missing")
    text = path.read_text()
    parsed = _HTMLTables()
    parsed.feed(text)
    parsed.close()
    kind = summary["primary_diagnosis"]["kind"]
    check(kind in parsed.banner, f"run {name}: the HTML banner {parsed.banner[:200]!r} lacks {kind}")
    tables = {heading: rows for heading, rows in parsed.tables}
    sections = summary["sections"]
    st = (sections["step_time"].get("global") or {})
    want = {"Step time": len(st.get("phases") or {}),
            "Device memory": len((sections["step_memory"].get("global") or {}).get("per_rank") or {}),
            "Processes": len((sections["process"].get("global") or {}).get("per_rank") or {})}
    got = {heading: len(tables.get(heading, [None])) - 1 for heading in want}
    check(got == want and want["Step time"] > 0, f"run {name}: HTML table rows {got}, the JSON's {want}")
    ranks = len(st.get("step_series_ms") or {})
    check(parsed.polylines == ranks and ranks > 0, f"run {name}: {parsed.polylines} step-chart lines, {ranks} ranks")
    words = sorted(set(JAX_WORDS.findall(text)))
    check(not words, f"run {name}: final_summary.html names {words}")
    return {"bytes": len(text.encode()), "rows": got, "banner_kind": kind}


def check_run(name: str, run: dict, n_layers: int, verdict, launches_per_layer: int = 1,
              telemetry_status: str = "ok") -> dict:
    """The run phase's gates on one call; returns its reported numbers.
    ``verdict`` is the expected primary verdict, or a function of the
    summary that gives it; the flash kernel must launch
    ``launches_per_layer`` times a layer and a step.  With
    ``telemetry_status="restarted"`` the manifest must say so with one
    aggregator restart, and the batches the client could not send must
    all have gone through the rank's spool: none it could not hold, none
    evicted, none left in it."""
    from traceml_tpu_torch.utils import timing as T

    summary, manifest, ingest = run["summary"], run["manifest"], run["ingest"]
    st, sm = summary["sections"]["step_time"], summary["sections"]["step_memory"]
    check(st["status"] == "OK", f"run {name}: step_time section {st['status']}")
    check(st["global"]["clock"] == "device", f"run {name}: step_time clock {st['global']['clock']}")
    check(st["global"]["n_steps"] >= 50, f"run {name}: {st['global']['n_steps']} steps in the window")
    check(sm["status"] == "OK" and sm["global"]["rollup"]["max_peak_bytes"] > 0,
          f"run {name}: no positive step-memory peak")
    check((manifest["status"], manifest["telemetry_status"]) == ("completed", telemetry_status),
          f"run {name}: manifest {manifest['status']}/{manifest['telemetry_status']}")
    producer = (ingest.get("producers") or {}).get("0") or {}
    transport = producer.get("transport") or {}
    drops = {"rows_dropped": ingest["rows_dropped"], "decode_errors": ingest["decode_errors"],
             "corrupt_frame_drops": sum(ingest["corrupt_frame_drops"].values()),
             "unknown_domain_drops": sum(ingest["unknown_domain_drops"].values())}
    if telemetry_status == "restarted":
        check(manifest.get("aggregator_restarts") == 1,
              f"run {name}: aggregator_restarts {manifest.get('aggregator_restarts')}")
        drops.update({k: transport.get(k) for k in ("spool_send_failures", "spool_evicted_envelopes",
                                                     "spool_frames")})
    else:
        drops["batches_dropped"] = transport.get("batches_dropped")
    check(drops == {k: 0 for k in drops}, f"run {name}: telemetry dropped {drops}")
    check(ingest["finished_ranks"] == [0], f"run {name}: finished ranks {ingest['finished_ranks']}")
    n = run["steps"]
    steps = [r[0] for r in run["rows"]]
    check(steps == list(range(1, n + 1)), f"run {name}: step_time_samples hold steps {steps[:3]}..., "
                                          f"{len(steps)} rows for {n} steps")
    launch_lines = [l for l in run["stdout"].splitlines() if l.startswith("flash_attention.launches ")]
    launches = int(launch_lines[-1].split()[1]) if launch_lines else None
    check(launches == launches_per_layer * n_layers * n,
          f"run {name}: rank reports {launches} flash launches, not {launches_per_layer} x {n_layers} x {n}")
    liveness = summary["sections"]["liveness"]
    check(liveness["status"] == "OK" and liveness["diagnosis"]["kind"] == "HEALTHY"
          and {r: v["state"] for r, v in liveness["ranks"].items()} == {"0": "finished"},
          f"run {name}: liveness {liveness['status']} {liveness['diagnosis']} {liveness.get('ranks')}")
    kind = summary["primary_diagnosis"]["kind"]
    log("run", f"{name}: verdict {kind} ({summary['primary_diagnosis']['severity']}): "
               f"{summary['primary_diagnosis'].get('summary')}")
    if callable(verdict):
        verdict = verdict(summary)
    check(kind == verdict, f"run {name}: final_summary.json says {kind}, not {verdict}")
    if run["mode"] == "summary":  # in cli mode the display's last frame is on stdout instead
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
        "session": str(run["session"]),
        "code_manifest": run["code_manifest"],
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


def run_phase(main: dict) -> dict:
    """``python -m traceml_tpu_torch run`` on the card, healthy with a fast
    sender tick and with the main path's input delay at the default tick,
    held to the gates of ``check_run``.  ``wrap_step_fn`` counts the
    forward's FLOPs on its first in-step call, so the healthy verdict is
    that of the measured MFU's band, and ``flops_per_step`` must lie
    within ``FLOPS_REL_TOL`` of ``analytic_forward_flops``.  Returns the
    healthy run's numbers."""
    from traceml_tpu_torch.dev.workload import full_width_config

    RUN_DIR.mkdir(parents=True, exist_ok=True)
    analytic = analytic_forward_flops(full_width_config(), BATCH, SEQ)
    for name, delay_ms, interval_s, steps, verdict, transport in (
            ("healthy", 0.0, 0.1, RUN_FORWARD_STEPS, mfu_verdict, "shm"),
            ("healthy_tcp", 0.0, 0.1, RUN_FORWARD_STEPS, mfu_verdict, "tcp"),
            ("input_delay", main["delay_ms"], 1.0, STEPS, "INPUT_BOUND", "shm")):
        env = {"TRACEML_TRANSPORT": "tcp"} if transport == "tcp" else None
        got = check_run(name, launch_run(name, delay_ms, interval_s, steps=steps, env_extra=env,
                                         transport=transport), main["n_layers"], verdict)
        eff = got["efficiency"] or {}
        flops = eff.get("flops_per_step")
        check(eff.get("flops_source") == "flop_counter" and flops is not None
              and abs(flops - analytic) / analytic <= FLOPS_REL_TOL,
              f"run {name}: forward flops_per_step {flops} ({eff.get('flops_source')}) vs analytic {analytic}")
        log("run", f"{name} (delay {delay_ms:.3f} ms, sender tick {interval_s} s; analytic {analytic:.6e} "
                   f"FLOPs/step) " + json.dumps(got))
        if name == "healthy":
            healthy = got
            run_ms, ref_ms = got["step_device_ms"], main["step_ms"]
            log("run", "step device ms under run (stored rows) vs in-process (no sender): " + ", ".join(
                f"{k} {run_ms[k]:.4f} vs {ref_ms[k]:.4f} ({run_ms[k] / ref_ms[k]:.4f}x)" for k in run_ms)
                + f"; {got['producer']['busy_ticks']} busy sender ticks")
        elif name == "healthy_tcp":
            shm_ms, tcp_ms = healthy["step_device_ms"], got["step_device_ms"]
            log("run", "forward step device ms under run, shm ring vs tcp (reported, not gated: the host "
                       "paces the forward): " + ", ".join(
                f"{k} {shm_ms[k]:.4f} vs {tcp_ms[k]:.4f} ({shm_ms[k] / tcp_ms[k]:.4f}x)" for k in shm_ms))
    return healthy


def mfu_verdict(summary: dict) -> str:
    """A healthy run's verdict by the band of its measured MFU
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


def check_train_run(name: str, run: dict, cfg, verdict, telemetry_status: str = "ok") -> dict:
    """The healthy and delayed train runs' gates: ``check_run``'s, the
    stored rows held to ``check_train_rows``, the loss falling, and an
    ``efficiency`` section with the card's peak, model FLOPs within
    ``FLOPS_REL_TOL`` of the analytic count and an MFU in (0, 1).
    Returns ``check_run``'s numbers."""
    from traceml_tpu_torch.dev.workload import TRAIN_TOKENS
    from traceml_tpu_torch.utils.chip_specs import peak_flops_for

    analytic = analytic_train_flops(cfg, BATCH, TRAIN_TOKENS - 1)
    peak = peak_flops_for(torch.cuda.get_device_name(0))
    check(peak is not None, f"no peak FLOP/s for {torch.cuda.get_device_name(0)}")
    got = check_run(name, run, cfg.n_layers, verdict, telemetry_status=telemetry_status)
    check_train_rows(f"run {name}", [(step, clock, json.loads(ev)) for step, clock, ev in run["rows"]])
    loss_lines = [l for l in run["stdout"].splitlines() if l.startswith("train_script: ") and "loss first" in l]
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
    log("run", f"{name} (sender tick {run['interval_s']} s; analytic {analytic:.6e} FLOPs/step; "
               f"loss first {first} last {last}) " + json.dumps(got))
    return got


def check_healthy_utilization(name: str, got: dict) -> None:
    util = got["telemetry"]["utilization_pct_recent_mean"]
    check(util >= UTIL_HEALTHY_MIN_PCT,
          f"run {name}: NVML utilization {util}% (last 30 samples) below {UTIL_HEALTHY_MIN_PCT}%")


def train_run_phase(cfg, train: dict) -> dict:
    """``python -m traceml_tpu_torch run`` of ``dev/train_script.py``:
    healthy with a 0.1 s sender tick, healthy again (``train_healthy_2``)
    and with a host input delay of 3x the in-process train step at the
    default tick, the three under one logs dir and run name (the healthy
    run's), so that the baseline store judges the second against the
    first and the delayed one against both.  Each is held to
    ``check_train_run``, with the verdict of the MFU's band (healthy) or
    INPUT_BOUND; the healthy runs' NVML utilization at least
    ``UTIL_HEALTHY_MIN_PCT``.  Returns each run's numbers by name."""
    delay_ms = 3.0 * train["step_ms"]
    runs = {}
    for name, delay, interval_s, verdict, join in (
            ("train_healthy", 0.0, 0.1, mfu_verdict, None),
            ("train_healthy_2", 0.0, 0.1, mfu_verdict, "train_healthy"),
            ("train_input_delay", delay_ms, 1.0, "INPUT_BOUND", "train_healthy")):
        log("run", f"{name}: input delay {delay:.3f} ms")
        got = check_train_run(name, launch_run(name, delay, interval_s, script="train_script.py", join=join),
                              cfg, verdict)
        if verdict is mfu_verdict:
            check_healthy_utilization(name, got)
            run_ms, ref_ms = got["step_device_ms"], train["step_spread"]
            log("run", f"{name}: train step device ms under run vs in-process: " + ", ".join(
                f"{k} {run_ms[k]:.4f} vs {ref_ms[k]:.4f} ({run_ms[k] / ref_ms[k]:.4f}x)" for k in run_ms))
        runs[name] = got
    return runs


COMPARE_BLOCKING = ("REGRESSION", "LIKELY_REGRESSION")  # verdicts two healthy runs must not get
BASELINE_EVAL_REPEATS = 20


def _compare_cli(name: str, baseline: Path, candidate: Path) -> dict:
    """``python -m traceml_tpu_torch compare <baseline> <candidate> --output``:
    exit 0, the payload file and the text beside it; returns the payload."""
    out = RUN_DIR / f"compare_{name}.json"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "traceml_tpu_torch", "compare", str(baseline), str(candidate),
                           "--output", str(out)], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    wall_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"compare {name} exited {proc.returncode}: {proc.stderr[-2000:]}")
    payload = json.loads(out.read_text())
    check(payload["schema"] == "traceml-tpu-compare/2", f"compare {name}: schema {payload['schema']}")
    check(proc.stdout.startswith(f"VERDICT: {payload['verdict']}")
          and out.with_suffix(".txt").read_text() == proc.stdout[:-1],
          f"compare {name}: stdout and {out.with_suffix('.txt').name} disagree with the payload")
    return {"payload": payload, "wall_s": wall_s}


def baseline_compare_phase(runs: dict) -> dict:
    """Cross-run baselines and ``compare`` on the three train runs of
    ``train_run_phase`` (one logs dir, one run name, one
    ``traceml_baselines.sqlite``).  Gates: the first run's ``regressions``
    ``no_baseline``; the second's ``ok`` over one run with its
    ``steady_step_ms`` check ``ok``; the delayed run's ``regression`` with
    a PERF_REGRESSION on ``steady_step_ms`` above +100% whose action names
    ``python -m traceml_tpu_torch compare`` and a ``[baseline]
    PERF_REGRESSION`` line in ``final_summary.txt``; every run's
    ``regressions.json`` equal to its payload's section, to the dashboard's
    meta fragment on the finished session and to ``evaluate_and_record``
    run again in this process on a copy of the store for the delayed run,
    the last one recorded (the section a re-finalize gives: the run does
    not match itself); ``compare`` of the
    two healthy runs exit 0, no step-time finding, a verdict outside
    ``COMPARE_BLOCKING``; ``compare`` of healthy and delayed REGRESSION,
    its step-time findings led by a major STEP_TIME_REGRESSION ranked among
    the major regressions that open the list, and the candidate's
    ``candidate_baseline`` ``regression``.  Reported with the card's
    ``nvidia-smi`` line: each run's steady step, the launcher's scan ms,
    the re-evaluation's ms, both verdicts."""
    from traceml_tpu_torch.analytics.baselines import STORE_FILENAME, evaluate_and_record
    from traceml_tpu_torch.renderers.web_payload import _meta_fragment
    from traceml_tpu_torch.reporting.compare.verdict import _REGRESSION_KINDS

    smi = nvidia_smi()
    sessions = {name: Path(got["session"]) for name, got in runs.items()}
    want = {"train_healthy": ("no_baseline", 0), "train_healthy_2": ("ok", 1), "train_input_delay": ("regression", 2)}
    out = {"card": smi, "runs": {}}
    for name, (status, n) in want.items():
        session = sessions[name]
        summary = json.loads((session / "final_summary.json").read_text())
        check("regressions" in summary, f"run {name}: final_summary.json has no regressions section")
        reg = summary["regressions"]
        on_disk = json.loads((session / "regressions.json").read_text())
        check(on_disk == reg, f"run {name}: regressions.json differs from the payload's section")
        check((reg["status"], reg["baseline_runs"]) == (status, n),
              f"run {name}: regressions {reg['status']} over {reg['baseline_runs']} runs, not {status} over {n}")
        check(reg["fingerprint"] == {"run_name": "train_healthy", "mesh_axes": "", "world_size": 1},
              f"run {name}: fingerprint {reg['fingerprint']}")
        meta = _meta_fragment({"db_exists": True}, session)
        check(meta.get("regressions") == on_disk, f"run {name}: the dashboard's meta regressions differ")
        step = next((c for c in reg["checks"] if c["metric"] == "steady_step_ms"), None)
        if status == "ok":
            check(step is not None and step["status"] == "ok", f"run {name}: steady_step_ms check {step}")
        times = None
        if status == "regression":
            # the last run recorded: finalize it again, in process, on a copy
            # of the store as it stands, BASELINE_EVAL_REPEATS times
            store = RUN_DIR / f"{name}_{STORE_FILENAME}"
            shutil.copyfile(session.parent / STORE_FILENAME, store)
            payload = {k: v for k, v in summary.items() if k != "regressions"}
            times = []
            for _ in range(BASELINE_EVAL_REPEATS):
                t0 = time.perf_counter()
                again = evaluate_and_record(session, payload, topology=None, store_path=store)
                times.append((time.perf_counter() - t0) * 1e3)
            check(again == reg, f"run {name}: a re-finalize gives {again}, not the stored section")
            issue = next((i for i in reg["issues"] if i["metric"] == "steady_step_ms"), None)
            check(step is not None and step["status"] == "regression" and step["delta_pct"] > 100.0
                  and issue is not None and issue["kind"] == "PERF_REGRESSION",
                  f"run {name}: steady_step_ms check {step}, issue {issue}")
            check("python -m traceml_tpu_torch compare" in issue["action"], f"run {name}: action {issue['action']}")
            text = (session / "final_summary.txt").read_text()
            check(any(l.startswith("[baseline] PERF_REGRESSION: steady_step_ms") for l in text.splitlines()),
                  f"run {name}: no [baseline] PERF_REGRESSION line in final_summary.txt")
        out["runs"][name] = {
            "status": reg["status"], "baseline_runs": reg["baseline_runs"],
            "steady_step_ms": summary["sections"]["step_time"]["global"]["steady_state"]["median_ms"],
            "step_check": step, "scan_ms_launcher": runs[name]["code_manifest"]["scan_ms"],
            "baseline_eval_ms": spread(times) if times else None}
        log("baseline", f"{name}: {smi}: " + json.dumps(out["runs"][name]))
    same = _compare_cli("healthy_vs_healthy_2", sessions["train_healthy"], sessions["train_healthy_2"])
    p = same["payload"]
    step_findings = [f for f in p["findings"] if f["section"] == "step_time"]
    check(p["verdict"] not in COMPARE_BLOCKING and not step_findings,
          f"compare healthy vs healthy_2: {p['verdict']}, step-time findings {step_findings}")
    delayed = _compare_cli("healthy_vs_input_delay", sessions["train_healthy"], sessions["train_input_delay"])
    q = delayed["payload"]
    step_findings = [f for f in q["findings"] if f["section"] == "step_time"]
    lead = next((i for i, f in enumerate(q["findings"]) if f["section"] == "step_time"), None)
    check(q["verdict"] == "REGRESSION" and lead is not None
          and (q["findings"][lead]["kind"], q["findings"][lead]["significance"]) == ("STEP_TIME_REGRESSION", "major")
          and all(f["significance"] == "major" and f["kind"] in _REGRESSION_KINDS for f in q["findings"][:lead]),
          f"compare healthy vs input_delay: {q['verdict']}, findings {[f['kind'] for f in q['findings']]}")
    check((q.get("candidate_baseline") or {}).get("status") == "regression",
          f"compare healthy vs input_delay: candidate_baseline {q.get('candidate_baseline')}")
    out["compare"] = {
        "healthy_vs_healthy_2": {"verdict": p["verdict"], "step_delta_rel": p["step_delta_rel"],
                                 "findings": [f["kind"] for f in p["findings"]], "wall_s": same["wall_s"]},
        "healthy_vs_input_delay": {"verdict": q["verdict"], "step_delta_rel": q["step_delta_rel"],
                                   "findings": [f["kind"] for f in q["findings"]],
                                   "step_finding_rank": lead, "wall_s": delayed["wall_s"],
                                   "candidate_baseline": q["candidate_baseline"]["status"]}}
    log("baseline", f"compare: {smi}: " + json.dumps(out["compare"]))
    return out


def remat_run_phase(cfg, remat: dict) -> dict:
    """``run`` of ``train_script.py --remat --h2d to --tokens --final-summary``
    (healthy, 0.1 s sender tick): the ``torch_h2d`` patch times the
    script's own ``batch.to(device, non_blocking=True)`` inside the step,
    the script declares its tokens and asks for ``final_summary()``
    before it exits.  The train run's gates with 2 x 12 launches a step,
    and: an h2d device time on every row (one copy a step, none by
    ``wrap_dataloader``), ``tokens_per_step`` 8 x 1024 and
    ``tokens_per_sec_median`` within ``FLOPS_REL_TOL`` of the tokens over
    the summary's steady-state step, ``flops_per_step`` within
    ``FLOPS_REL_TOL`` of ``analytic_remat_flops``, the dict that
    ``final_summary()`` returned with the final artifact's primary kind
    and no more steps, and the verdict of the MFU's band."""
    from traceml_tpu_torch.dev.workload import TRAIN_TOKENS
    from traceml_tpu_torch.utils import timing as T

    name = "train_remat_h2d"
    run = launch_run(name, 0.0, 0.1, script="train_script.py",
                     script_args=("--remat", "--h2d", "to", "--tokens", "--final-summary"))
    got = check_run(name, run, cfg.n_layers, mfu_verdict, launches_per_layer=2)
    rows = [(step, clock, json.loads(ev)) for step, clock, ev in run["rows"]]
    check_train_rows(f"run {name}", rows)
    check("train_script: batches copied by Tensor.to in the step" in run["stdout"],
          f"run {name}: the script did not copy its batches in the step")
    h2d = [(ev.get(T.H2D_TIME) or {}) for _, _, ev in rows]
    check(all(e.get("count") == 1 and (e.get("device_ms") or 0) > 0 for e in h2d),
          f"run {name}: rows without one h2d copy on the device clock: "
          f"{[(r[0], e) for r, e in zip(rows, h2d) if not (e.get('count') == 1 and (e.get('device_ms') or 0) > 0)][:3]}")
    summary = run["summary"]
    eff = got["efficiency"] or {}
    tokens = BATCH * (TRAIN_TOKENS - 1)
    check(eff.get("tokens_per_step") == tokens, f"run {name}: tokens_per_step {eff.get('tokens_per_step')}")
    want_tps = tokens / (got["steady_state_ms"] / 1e3)
    tps = eff.get("tokens_per_sec_median")
    check(tps is not None and abs(tps - want_tps) / want_tps <= FLOPS_REL_TOL,
          f"run {name}: tokens_per_sec_median {tps} vs {want_tps}")
    analytic = analytic_remat_flops(cfg, BATCH, TRAIN_TOKENS - 1)
    flops = eff.get("flops_per_step")
    check(flops is not None and abs(flops - analytic) / analytic <= FLOPS_REL_TOL,
          f"run {name}: flops_per_step {flops} vs analytic {analytic}")
    lines = [l for l in run["stdout"].splitlines() if l.startswith("final_summary ")]
    check(bool(lines), f"run {name}: the script printed no final_summary line")
    asked = json.loads(lines[-1].split(" ", 1)[1])
    final_kind = summary["primary_diagnosis"]["kind"]
    final_steps = summary["sections"]["step_time"]["global"]["n_steps"]
    check(asked["kind"] == final_kind and asked["n_steps"] is not None and asked["n_steps"] <= final_steps,
          f"run {name}: final_summary() gave {asked}, the final artifact {final_kind} over {final_steps} steps")
    out = {**got, "final_summary_in_script": asked, "analytic_flops": analytic,
           "tokens_per_sec_expected": want_tps,
           "h2d_device_ms_median": statistics.median(e["device_ms"] for e in h2d),
           "in_process_remat": {k: remat[k] for k in ("step_ms", "step_peak_bytes")}}
    log("run", f"{name} " + json.dumps(out))
    return out


FRAME_HEADER = "TraceML (PyTorch) — live · session"
FRAME_STEP_REL_TOL = 0.05  # the frame's median step vs final_summary.json's (display rounding is 0.1 ms)
LIVE_TICKS = 50  # dirty and idle live ticks, for each of the two arms


def check_cli_output(name: str, run: dict, got: dict) -> dict:
    """The ``cli`` mode's gates on one call: the launcher's stdout holds
    the rank's lines, then the dashboard's last frame once; the session's
    ``stdout_samples`` rows and ``rank_0/stdout.log`` hold the same lines
    in the same order; the frame's step-time panel reads a median step
    within ``FRAME_STEP_REL_TOL`` of the summary's, and its rank-0 output
    panel shows the script's last line, its header the rank finished."""
    out = run["stdout"]
    check(out.count(FRAME_HEADER) == 1, f"run {name}: {out.count(FRAME_HEADER)} dashboard frames on stdout")
    at = out.index(FRAME_HEADER)
    printed = [l for l in out[:at].splitlines() if l and not l.startswith("[TraceML]")]
    check(bool(printed) and printed[-1].startswith("flash_attention.launches"),
          f"run {name}: the rank's lines before the frame end with {printed[-1:]}")
    stored = [r["line"] for r in run["tables"]["stdout_samples"] if r["stream"] == "stdout"]
    check(stored == printed, f"run {name}: stdout_samples {len(stored)} lines, the script printed "
                             f"{len(printed)}; first difference at "
                             f"{next((i for i, (a, b) in enumerate(zip(stored, printed)) if a != b), None)}")
    log_lines = (run["session"] / "rank_0" / "stdout.log").read_text().splitlines()
    logged = [l[len("[stdout] "):] for l in log_lines if l.startswith("[stdout] ")]
    check(logged == printed, f"run {name}: rank_0/stdout.log holds {len(logged)} stdout lines, not the "
                             f"{len(printed)} printed")
    frame = out[at:]
    match = re.search(r"│ *step_time +([0-9.]+) (µs|ms|s) ", frame)
    check(match is not None, f"run {name}: no step_time row in the frame:\n{frame[:2000]}")
    frame_ms = float(match.group(1)) * {"µs": 1e-3, "ms": 1.0, "s": 1e3}[match.group(2)]
    summary_ms = got["step_ms_summary"]
    check(abs(frame_ms - summary_ms) / summary_ms <= FRAME_STEP_REL_TOL,
          f"run {name}: the frame's median step {frame_ms} ms vs final_summary.json {summary_ms} ms")
    check("rank 0 output" in frame and printed[-1] in frame.split("rank 0 output", 1)[1],
          f"run {name}: the rank-0 output panel lacks the script's last line {printed[-1]!r}")
    check("ranks: 1 finished" in " ".join(frame.split()), f"run {name}: the frame's liveness strip is not "
                                                          f"'1 finished':\n{frame.splitlines()[:2]}")
    return {"frame_step_ms": frame_ms, "summary_step_ms": summary_ms, "lines_printed": len(printed),
            "stdout_rows": len(run["tables"]["stdout_samples"]), "frame_lines": len(frame.splitlines())}


def _row_appender(db: Path):
    """A connection to a copy of a finished session DB and a function that
    commits the i-th sender tick's rows: one step-time, system, process
    and step-memory row more, copies of the newest, 0.1 s later each."""
    conn = sqlite3.connect(db)
    conn.row_factory = sqlite3.Row
    newest = {t: conn.execute(f"SELECT * FROM {t} ORDER BY id DESC LIMIT 1").fetchone()
              for t in ("step_time_samples", "system_samples", "process_samples", "step_memory_samples")}
    last = {t: dict(row) for t, row in newest.items() if row is not None}

    def append(i: int) -> None:
        for table, row in last.items():
            row = {k: v for k, v in row.items() if k != "id"}
            if "step" in row:
                row["step"] += i
            row["timestamp"] += 0.1 * i
            conn.execute(f"INSERT INTO {table} ({', '.join(row)}) VALUES ({', '.join('?' * len(row))})",
                         tuple(row.values()))
        conn.commit()

    return conn, append


ENGINE_SWITCHES = ("TRACEML_COLUMNAR_WINDOW", "TRACEML_INCR_WINDOW", "TRACEML_VECTOR_DIAGNOSIS")


def engine_arm(arm: str):
    """A context under one arm of the window engines: ``"engine"`` (the
    three switches unset, the default) or ``"scalar"`` (all three at
    ``0``).  The port reads them on every call, so a tick computed inside
    takes that arm; the environment comes back as it was after it."""
    env = {k: v for k, v in os.environ.items() if k not in ENGINE_SWITCHES}
    if arm == "scalar":
        env.update(dict.fromkeys(ENGINE_SWITCHES, "0"))
    return mock.patch.dict(os.environ, env, clear=True)


def canon_payload(payload: dict, db: Path) -> tuple:
    """One tick's payload in canonical form, ``ts`` and the engine's
    ``window_build_stats`` aside: as JSON, every fragment a viewer is
    served (the views, findings, stdout, meta) and the step-time and
    memory diagnoses; beside it the step-time window in plain form
    (compared as a dict: its JSON would cost more than the tick at many
    ranks, and a value the served JSON would tell apart reaches the
    fragments).  Taken within the tick: an engine window's arrays are the
    cache's until its next build."""
    from traceml_tpu_torch.renderers.web_payload import FRAGMENT_ORDER, build_fragment
    from traceml_tpu_torch.utils.columnar import window_to_plain

    frags = {}
    for name in FRAGMENT_ORDER:
        frag = build_fragment(name, payload, session="canon", db_path=db)
        if name == "meta":
            frag.pop("window_build", None)
        frags[name] = frag
    st = payload.get("step_time") or {}
    diagnoses = {k: (d.to_dict() if d is not None else None)
                 for k, d in (("step_time", st.get("diagnosis")), ("memory", payload.get("step_memory_diagnosis")))}
    return json.dumps({"fragments": frags, "diagnoses": diagnoses}, sort_keys=True), window_to_plain(st.get("window"))


def live_tick_cost(db: Path) -> dict:
    """``LiveComputer.payload()`` plus one render of the dashboard (to a
    terminal console of 120 columns, styles included), timed in process
    on copies of a finished session DB, for each arm of the window
    engines: the engines (the default) on one copy, the three switches at
    0 on its twin.  The first tick, ``LIVE_TICKS`` dirty ticks (before
    each, one step-time, system, process and step-memory row more is
    committed to both copies, as a sender tick brings them), then
    ``LIVE_TICKS`` idle ticks (no commit; each must return the cached
    payload).  Gate: on the first and every dirty tick the two arms'
    payloads are equal (``canon_payload``)."""
    import io

    from rich.console import Console

    from traceml_tpu_torch.renderers.compute import LiveComputer
    from traceml_tpu_torch.renderers.panels import dashboard

    work = RUN_DIR / "live_tick"
    shutil.rmtree(work, ignore_errors=True)
    console = Console(file=io.StringIO(), width=120, force_terminal=True, color_system="standard")

    def tick(computer):
        t0 = time.perf_counter_ns()
        payload = computer.payload()
        console.print(dashboard(payload, "live_tick"))
        us = (time.perf_counter_ns() - t0) / 1e3
        console.file.seek(0)
        console.file.truncate()
        return us, payload

    arms = {}
    for arm in ("engine", "scalar"):
        copy = work / arm / "telemetry.sqlite"
        copy.parent.mkdir(parents=True)
        shutil.copyfile(db, copy)
        conn, append = _row_appender(copy)
        arms[arm] = {"db": copy, "conn": conn, "append": append, "computer": LiveComputer(copy),
                     "first": [], "dirty": [], "idle": []}
    try:
        def both(i: int, kind: str) -> None:
            canon = {}
            for arm, a in arms.items():
                if i:
                    a["append"](i)
                with engine_arm(arm):
                    us, payload = tick(a["computer"])
                    canon[arm] = canon_payload(payload, a["db"])
                a[kind].append(us)
            check(canon["engine"] == canon["scalar"], f"live tick {i}: the engine's payload differs from the "
                                                      f"scalar arm's")

        both(0, "first")
        for i in range(1, LIVE_TICKS + 1):
            both(i, "dirty")
        for arm, a in arms.items():
            with engine_arm(arm):
                cached = a["computer"].payload()
                a["idle"] = [tick(a["computer"])[0] for _ in range(LIVE_TICKS)]
                check(a["computer"].payload() is cached, f"an idle live tick ({arm}) did not return the cached "
                                                         f"payload")
        with engine_arm("engine"):
            build = arms["engine"]["computer"].store.window_build_stats()
    finally:
        for a in arms.values():
            a["computer"].close()
            a["conn"].close()
    check(build["step_time"]["incr_ticks"] > build["step_time"]["full_rebuilds"],
          f"the live engine's window was rebuilt more often than extended: {build['step_time']}")
    out = {arm: {"first_tick_us": a["first"][0], "dirty_tick_us": spread(a["dirty"]),
                 "idle_tick_us": spread(a["idle"])} for arm, a in arms.items()}
    out.update({"ticks": LIVE_TICKS, "payloads_equal": LIVE_TICKS + 1, "window_build": build})
    return out


def cli_run_phase(cfg, train_healthy: dict, forward_healthy: dict) -> dict:
    """``python -m traceml_tpu_torch run --mode cli`` of ``dev/
    train_script.py`` at full width ((8, 1025) tokens, 60 steps, healthy,
    0.1 s sender tick): the live display redraws from the session SQLite
    every 0.5 s and, stdout being a pipe, prints its last frame at the
    end.  Gates: ``check_train_run``'s with the verdict of the MFU's band,
    the healthy utilization, and ``check_cli_output``'s.  Reported: its
    step against the ``summary`` train run's; the forward script's
    (``STEPS`` steps) under ``cli`` against the ``summary``
    forward run's (not gated: the forward is paced by the host); the live
    tick's cost on twin copies of this run's DB, both arms (``live_tick_cost``)."""
    from traceml_tpu_torch.utils import timing as T

    name = "train_cli"
    run = launch_run(name, 0.0, 0.1, script="train_script.py", mode="cli")
    got = check_train_run(name, run, cfg, mfu_verdict)
    check_healthy_utilization(name, got)
    check_report_window_build(name, run["summary"])
    out = {"train": {**check_cli_output(name, run, got), "flash_launches": got["flash_launches"],
                     "verdict": got["verdict"], "step_device_ms_cli": got["step_device_ms"],
                     "step_device_ms_summary": train_healthy["step_device_ms"],
                     "mfu_cli": got["efficiency"]["mfu_median"],
                     "mfu_summary": train_healthy["efficiency"]["mfu_median"],
                     "wall_s_cli": got["wall_s"], "wall_s_summary": train_healthy["wall_s"]}}
    fwd = launch_run("forward_cli", 0.0, 0.1, steps=STEPS, mode="cli")
    fwd_ms = [json.loads(ev)[T.STEP_TIME]["device_ms"] for _, _, ev in fwd["rows"]]
    out["forward"] = {"step_device_ms_cli": spread(fwd_ms),
                      "step_device_ms_summary": forward_healthy["step_device_ms"],
                      "verdict_cli": fwd["summary"]["primary_diagnosis"]["kind"],
                      "verdict_summary": forward_healthy["verdict"],
                      "wall_s_cli": fwd["wall_s"], "wall_s_summary": forward_healthy["wall_s"]}
    out["live_tick"] = live_tick_cost(run["session"] / "telemetry.sqlite")
    out["session"] = run["session"]
    for path in ("train", "forward"):
        a, b = out[path]["step_device_ms_cli"], out[path]["step_device_ms_summary"]
        log("cli", f"{path} step device ms, cli vs summary: " + ", ".join(
            f"{k} {a[k]:.4f} vs {b[k]:.4f} ({a[k] / b[k]:.4f}x)" for k in a))
    tick = out["live_tick"]
    for arm in ("engine", "scalar"):
        t = tick[arm]
        log("cli", f"live tick (payload + render) µs, {arm}: first {t['first_tick_us']:.1f}; dirty median "
                   f"{t['dirty_tick_us']['median']:.1f}, idle median {t['idle_tick_us']['median']:.1f} "
                   f"over {LIVE_TICKS} ticks each")
    log("cli", f"live tick payloads equal on {tick['payloads_equal']} ticks; engine window builds "
               + json.dumps(tick["window_build"]["step_time"]))
    log("cli", json.dumps(out, default=str))
    return out


def check_report_window_build(name: str, summary: dict) -> None:
    """A report written with the engines on carries ``meta.window_build``:
    the step-time cache's one build and the report's one profiled tick."""
    wb = summary["meta"].get("window_build") or {}
    st = wb.get("step_time") or {}
    check(st.get("full_rebuilds") == 1 and (wb.get("tick_profile") or {}).get("ticks") == 1,
          f"run {name}: final_summary.json meta.window_build {wb}")


ENGINE_RANKS = 256  # a 32-node x 8-GPU job, the reference's multi-node user
ENGINE_SLOW_RANK = 137
ENGINE_SLOW = 1.3  # the slow rank's durations, x the others'
ENGINE_JITTER = 0.01  # per-rank duration factor ~ N(1, 0.01); per-row noise 0.2%
ENGINE_TICKS = 25  # dirty ticks, one new row per rank each; then as many idle ticks


def _fanout_sources(session: Path):
    """Rank 0's step-time and step-memory rows of a finished session, in
    step order, as the writer's envelopes carry them."""
    conn = sqlite3.connect(session / "telemetry.sqlite")
    conn.row_factory = sqlite3.Row
    try:
        steps = [{"step": r["step"], "timestamp": r["timestamp"], "clock": r["clock"],
                  "late_markers": r["late_markers"], "events": json.loads(r["events_json"])}
                 for r in conn.execute("SELECT step, timestamp, clock, late_markers, events_json FROM "
                                       "step_time_samples WHERE global_rank = 0 ORDER BY step, id")]
        memory = [dict(r) for r in conn.execute(
            "SELECT step, timestamp, device_id, device_kind, current_bytes, peak_bytes, step_peak_bytes, "
            "limit_bytes FROM step_memory_samples WHERE global_rank = 0 ORDER BY step, id")]
    finally:
        conn.close()
    check(len(steps) >= STEPS and memory, f"engine phase: {len(steps)} step rows, {len(memory)} memory rows "
                                          f"in {session}")
    return steps, memory


class _Fanout:
    """Writes a run's rows as ``ENGINE_RANKS`` ranks would ship them, into
    twin databases through the port's ``SQLiteWriter``: rank r's durations
    are the source's times a seeded factor (``ENGINE_SLOW`` more on
    ``ENGINE_SLOW_RANK``) times 0.2% noise a row, its bytes the source's
    times a seeded factor; envelopes columnar, ``seq`` monotonic a rank."""

    def __init__(self, dbs, steps, memory) -> None:
        import numpy as np

        from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter

        self.np = np
        self.rng = np.random.default_rng(SEED)
        self.factor = self.rng.normal(1.0, ENGINE_JITTER, ENGINE_RANKS)
        self.factor[ENGINE_SLOW_RANK] *= ENGINE_SLOW
        self.mem_factor = self.rng.uniform(0.98, 1.02, ENGINE_RANKS)
        self.steps, self.memory = steps, memory
        self.writers = []
        for db in dbs:
            w = SQLiteWriter(db)
            w.start()
            self.writers.append(w)
        self.seq = [0] * ENGINE_RANKS

    def _step_row(self, rank: int, src: dict, step: int) -> dict:
        f = float(self.factor[rank] * (1.0 + 0.002 * self.rng.standard_normal()))
        events = {name: {k: (v * f if k in ("cpu_ms", "device_ms") and v is not None else v) for k, v in ev.items()}
                  for name, ev in src["events"].items()}
        return {**src, "step": step, "timestamp": src["timestamp"] + 0.001 * rank, "events": events}

    def _memory_row(self, rank: int, src: dict, step: int) -> dict:
        f = float(self.mem_factor[rank])
        return {**src, "step": step, **{k: int(src[k] * f) for k in ("current_bytes", "peak_bytes",
                                                                     "step_peak_bytes") if src[k] is not None}}

    def _send(self, rank: int, table: str, rows) -> None:
        from traceml_tpu_torch.telemetry.envelope import SenderIdentity, normalize_telemetry_envelope, rows_to_columns

        ident = SenderIdentity(session_id="engine_tick", global_rank=rank, local_rank=rank % 8,
                               world_size=ENGINE_RANKS, local_world_size=8, node_rank=rank // 8,
                               hostname=f"node-{rank // 8}", pid=1000 + rank)
        self.seq[rank] += 1
        meta = ident.to_meta()
        meta.update({"schema": 2, "sampler": table, "timestamp": time.time(), "seq": self.seq[rank]})
        env = normalize_telemetry_envelope({"meta": meta, "body": {"tables": {table: rows_to_columns(rows)}}})
        for w in self.writers:  # the writers only read an envelope
            check(w.ingest(env), f"engine phase: the writer refused rank {rank}'s {table} envelope")

    def write(self, first: int, n: int) -> None:
        """Steps ``first`` to ``first + n - 1`` on every rank, the source
        rows reused in turn."""
        for rank in range(ENGINE_RANKS):
            idx = [(first - 1 + i) % len(self.steps) for i in range(n)]
            self._send(rank, "step_time", [self._step_row(rank, self.steps[j], first + i) for i, j in enumerate(idx)])
            mem = [(first - 1 + i) % len(self.memory) for i in range(n)]
            self._send(rank, "step_memory", [self._memory_row(rank, self.memory[j], first + i)
                                             for i, j in enumerate(mem)])
        for w in self.writers:
            check(w.force_flush(timeout=120), "engine phase: a writer did not flush")

    def finalize(self) -> None:
        for w in self.writers:
            check(w.finalize(timeout=120), "engine phase: a writer did not finalize")


def engine_tick_phase(session: Path) -> dict:
    """The window engines at many ranks, in process on the card's host: the
    healthy full-width ``cli`` train run's rank-0 step-time and step-memory
    rows fanned out to ``ENGINE_RANKS`` ranks (``_Fanout``: seeded per-rank
    jitter, rank ``ENGINE_SLOW_RANK`` ``ENGINE_SLOW`` x slower) into twin
    databases; a ``LiveComputer`` with the engines (the default) on one and
    one under the three switches at 0 on the other: a first tick, then
    ``ENGINE_TICKS`` dirty ticks (one more row per rank each), then as many
    idle ticks.  Gates: on every dirty tick the two payloads are equal
    (``canon_payload``); both name the slow rank in the step-time verdict;
    the engine's cache extends the window more often than it rebuilds it;
    re-finalizing each database under its arm writes the same
    ``final_summary.json``, ``generated_at`` and ``meta.window_build``
    aside.  Reported: ms a tick for each arm and their ratio, the engine's
    builds by path and invalidation reason, each arm's report ms."""
    from traceml_tpu_torch.renderers.compute import LiveComputer
    from traceml_tpu_torch.reporting.final import generate_summary
    from traceml_tpu_torch.runtime.settings import TraceMLSettings

    steps, memory = _fanout_sources(session)
    work = RUN_DIR / "engine_tick"
    shutil.rmtree(work, ignore_errors=True)
    arms = {}
    for arm in ("engine", "scalar"):
        (work / arm).mkdir(parents=True)
        arms[arm] = {"db": work / arm / "telemetry.sqlite", "ticks": {"first": [], "dirty": [], "idle": []}}
    fan = _Fanout([a["db"] for a in arms.values()], steps, memory)
    t0 = time.perf_counter()
    fan.write(1, len(steps))
    write_s = time.perf_counter() - t0
    for a in arms.values():
        a["computer"] = LiveComputer(a["db"])
    verdicts = {}
    try:
        def both(kind: str, tick_no: int) -> None:
            canon = {}
            for arm, a in arms.items():
                with engine_arm(arm):
                    t = time.perf_counter_ns()
                    payload = a["computer"].payload()
                    a["ticks"][kind].append((time.perf_counter_ns() - t) / 1e6)
                    if kind == "idle":
                        check(payload is a["last"], f"engine phase: an idle {arm} tick rebuilt its payload")
                        continue
                    a["last"] = payload
                    canon[arm] = canon_payload(payload, a["db"])
                    verdicts[arm] = payload["step_time"]["diagnosis"].diagnosis
            if canon:
                check(canon["engine"] == canon["scalar"], f"engine phase: {kind} tick {tick_no}: the engine's "
                                                          f"payload differs from the scalar arm's")

        both("first", 0)
        for i in range(1, ENGINE_TICKS + 1):
            fan.write(len(steps) + i, 1)
            both("dirty", i)
        for i in range(1, ENGINE_TICKS + 1):
            both("idle", i)
        with engine_arm("engine"):
            build = arms["engine"]["computer"].store.window_build_stats()
    finally:
        for a in arms.values():
            if "computer" in a:
                a["computer"].close()
        fan.finalize()
    for arm, v in verdicts.items():
        check(v.kind.endswith("STRAGGLER") and f"Rank {ENGINE_SLOW_RANK} " in v.summary,
              f"engine phase: the {arm} arm's step-time verdict {v.kind}: {v.summary}")
    st_build = build["step_time"]
    check(st_build["incr_ticks"] > st_build["full_rebuilds"] >= 1 and not [
        k for k in build["tick_profile"]["counters"] if k.startswith("vector_fallbacks_")],
          f"engine phase: the engine's builds {build}")
    reports = {}
    for arm, a in arms.items():
        session_dir = work / f"report_{arm}" / "s"  # its own logs dir: its own baseline store
        with engine_arm(arm):
            t = time.perf_counter()
            check(generate_summary(a["db"], session_dir, TraceMLSettings(session_id="engine_tick", mode="summary")),
                  f"engine phase: the {arm} report failed")
            a["report_ms"] = (time.perf_counter() - t) * 1e3
        report = json.loads((session_dir / "final_summary.json").read_text())
        wb = report["meta"].pop("window_build", None)
        check((wb is not None) == (arm == "engine"), f"engine phase: the {arm} report's meta.window_build {wb}")
        del report["meta"]["generated_at"]
        reports[arm] = report
    check(reports["engine"] == reports["scalar"], "engine phase: the two arms' final_summary.json differ")
    primary = reports["engine"]["primary_diagnosis"]
    out = {"ranks": ENGINE_RANKS, "slow_rank": ENGINE_SLOW_RANK, "source_steps": len(steps),
           "source_memory_rows": len(memory), "write_s": write_s, "dirty_ticks": ENGINE_TICKS,
           "verdict": {"kind": verdicts["engine"].kind, "summary": verdicts["engine"].summary},
           "report_primary": {"kind": primary.get("kind"), "summary": primary.get("summary")},
           "window_build": st_build, "tick_profile_counters": build["tick_profile"]["counters"]}
    for arm, a in arms.items():
        out[arm] = {"first_ms": a["ticks"]["first"][0], "dirty_ms": spread(a["ticks"]["dirty"]),
                    "idle_ms": spread(a["ticks"]["idle"]), "report_ms": a["report_ms"]}
    out["dirty_ratio_scalar_over_engine"] = out["scalar"]["dirty_ms"]["median"] / out["engine"]["dirty_ms"]["median"]
    for arm in ("engine", "scalar"):
        t = out[arm]
        log("engine", f"{arm}: {ENGINE_RANKS} ranks, ms a tick: first {t['first_ms']:.2f}; dirty median "
                      f"{t['dirty_ms']['median']:.2f} p90 {t['dirty_ms']['p90']:.2f} over {ENGINE_TICKS}; idle "
                      f"median {t['idle_ms']['median']:.4f}; the report {t['report_ms']:.1f} ms")
    log("engine", f"dirty tick scalar / engine {out['dirty_ratio_scalar_over_engine']:.2f}x; engine builds "
                  + json.dumps(st_build) + f"; verdict {verdicts['engine'].kind}: {verdicts['engine'].summary}")
    log("engine", json.dumps(out))
    return out


DASHBOARD_STEPS = 70  # ~8 s of the full-width train step: the probe reads the page while the rank trains
STREAM_WINDOW_S = 5.0  # /api/stream must yield two events within this
POLL_TIMES = 200


def _http_get(port: int, path: str, headers=None, timeout: float = 10.0):
    """(status, lower-cased headers, body) of one GET to the dashboard."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def _read_sse_event(resp) -> dict:
    """One server-sent event as {field: value}; {} at the stream's end."""
    event = {}
    while True:
        line = resp.fp.readline()
        if not line:
            return event
        line = line.decode().rstrip("\n")
        if line == "":
            if event:
                return event
            continue
        field, _, value = line.partition(": ")
        event[field] = value


def _canon(payload: dict) -> str:
    return json.dumps({k: v for k, v in payload.items() if k != "ts"}, sort_keys=True)


def _live_step_ms(live: dict):
    rows = [p for p in ((live.get("step_time") or {}).get("phases") or []) if p.get("key") == "step_time"]
    return rows[0]["median_ms"] if rows else None


class DashboardProbe:
    """Reads the dashboard of a ``--mode dashboard`` call while its rank
    trains, from a thread beside ``launch_run``: it waits for
    ``display_port`` in the session's ``aggregator_ready.json``; gets
    ``/healthz`` and ``/``; reads ``/api/live`` until its step time, the
    NVML device rows and the script's stdout have arrived; takes one
    ``If-None-Match`` read, one ``?since=`` delta between two full reads
    that share its token, one gzip read beside a plain one with the same
    token, and ``STREAM_WINDOW_S`` of ``/api/stream``; then holds one
    stream open across the run's end (on its own thread) and reads
    ``/api/live`` every 0.5 s until the server is gone.  It records what
    it read; ``dashboard_run_phase`` gates it.  An exception ends the
    probe and is kept for the gate."""

    def __init__(self) -> None:
        self.done = threading.Event()
        self.run_ended_at = None
        self.error = None
        self.port = None
        self.reads = {}
        self.last_live = None
        self.held = {"events": 0, "closed_at": None}

    def run(self, logs: Path) -> None:
        try:
            self._run(logs)
        except Exception as exc:
            self.error = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))

    @staticmethod
    def ready(live: dict) -> bool:
        """The payload holds the rank's steps, the GPU rows and its stdout."""
        devices = [d for n in ((live.get("system") or {}).get("nodes") or []) for d in n.get("devices") or []]
        return ((live.get("step_time") or {}).get("n_steps") or 0) >= 5 and bool(devices) and bool(live.get("stdout"))

    def _full(self):
        code, headers, body = _http_get(self.port, "/api/live")
        check(code == 200, f"/api/live answered {code}")
        return headers["x-traceml-token"], json.loads(body)

    def _hold_stream(self) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            conn.request("GET", "/api/stream")
            resp = conn.getresponse()
            while _read_sse_event(resp):
                self.held["events"] += 1
        finally:
            self.held["closed_at"] = time.monotonic()
            conn.close()

    def _run(self, logs: Path) -> None:
        deadline = time.monotonic() + RUN_TIMEOUT_S
        while self.port is None:
            check(not self.done.is_set() and time.monotonic() < deadline,
                  "no display_port in aggregator_ready.json while the run lasted")
            for path in logs.glob("*/aggregator_ready.json"):
                self.port = json.loads(path.read_text()).get("display_port")
            time.sleep(0.05)
        code, headers, body = _http_get(self.port, "/healthz")
        self.reads["healthz"] = {"code": code, "body": json.loads(body)}
        code, headers, body = _http_get(self.port, "/")
        self.reads["page"] = {"code": code, "type": headers.get("content-type"), "text": body.decode()}
        while True:
            check(not self.done.is_set(), "the run ended before /api/live held steps, GPU rows and stdout")
            token, live = self._full()
            if self.ready(live):
                self.reads["live"] = live
                break
            time.sleep(0.25)
        token, _ = self._full()
        code, headers, _ = _http_get(self.port, "/api/live", {"If-None-Match": f'"{token}"'})
        self.reads["etag"] = {"sent": f'"{token}"', "code": code, "etag": headers.get("etag")}
        for attempt in range(1, 31):  # a delta between two full reads that share its token
            token_a, full_a = self._full()
            code, headers, body = _http_get(self.port, f"/api/live?since={token_a}")
            token_c, full_c = self._full()
            if headers["x-traceml-token"] == token_c:
                self.reads["delta"] = {"attempt": attempt, "code": code, "since": token_a,
                                       "token": headers["x-traceml-token"], "full_a": full_a,
                                       "body": json.loads(body) if code == 200 else None, "full_c": full_c}
                break
        for attempt in range(1, 31):
            token_p, plain = self._full()
            code, headers, body = _http_get(self.port, "/api/live", {"Accept-Encoding": "gzip"})
            if headers["x-traceml-token"] == token_p:
                self.reads["gzip"] = {"attempt": attempt, "code": code, "encoding": headers.get("content-encoding"),
                                      "same": _canon(json.loads(gzip.decompress(body))) == _canon(plain)}
                break
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=STREAM_WINDOW_S)
        events, t0 = [], time.monotonic()
        try:
            conn.request("GET", "/api/stream")
            resp = conn.getresponse()
            while len(events) < 2 and time.monotonic() - t0 < STREAM_WINDOW_S:
                event = _read_sse_event(resp)
                if event.get("event") == "fragment":
                    events.append({"id": event.get("id"), "at_s": time.monotonic() - t0,
                                   "token": json.loads(event["data"])["token"]})
        except OSError:
            pass  # the window's timeout: the gate counts the events
        finally:
            conn.close()
        self.reads["stream"] = events
        held = threading.Thread(target=self._hold_stream, name="held-stream", daemon=True)
        held.start()
        while True:  # the last read before the server stops
            try:
                self.last_live = self._full()[1]
            except OSError:
                break
            time.sleep(0.5)
        held.join(timeout=60)
        check(not held.is_alive(), "the held SSE stream outlived the dashboard")


def serving_cost(session: Path) -> dict:
    """The serving tier's cost, in process on a copy of a finished session
    (its DB, ingest stats and rank status): ``publisher.poll()`` plus
    ``full_body()`` (µs) the first time, ``POLL_TIMES`` times dirty (one
    sender tick's rows committed before each, as in ``live_tick_cost``)
    and ``POLL_TIMES`` times idle (nothing new: the token must not move);
    the full body's bytes, raw and gzip; the publisher's counts of polls,
    fragment builds and publishes, and full-body assemblies."""
    from traceml_tpu_torch.renderers.serving import SessionPublisher

    work = RUN_DIR / "serving_cost"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for fname in ("telemetry.sqlite", "ingest_stats.json", "rank_status.json"):
        shutil.copyfile(session / fname, work / fname)
    conn, append = _row_appender(work / "telemetry.sqlite")
    pub = SessionPublisher(work / "telemetry.sqlite", "serving_cost")
    pub.min_poll_interval = 0.0

    def poll() -> float:
        t0 = time.perf_counter_ns()
        pub.poll()
        pub.full_body()
        return (time.perf_counter_ns() - t0) / 1e3

    try:
        first = poll()
        dirty = []
        for i in range(1, POLL_TIMES + 1):
            append(i)
            dirty.append(poll())
        token = pub.token
        idle = [poll() for _ in range(POLL_TIMES)]
        check(pub.token == token, f"idle polls moved the token {token} -> {pub.token}")
        raw, _, _ = pub.full_body()
        gz, _, enc = pub.full_body(accept_gzip=True)
        check(enc == "gzip" and gzip.decompress(gz) == raw, "the gzip body does not decode to the raw one")
    finally:
        pub.close()
        conn.close()
    return {"first_us": first, "dirty_us": spread(dirty), "idle_us": spread(idle), "polls": POLL_TIMES,
            "full_body_bytes": len(raw), "full_body_gzip_bytes": len(gz), "publisher": pub.stats}


def html_render_cost(summary: dict, repeats: int = 20) -> dict:
    """``render_html_summary`` on one run's final payload: ms (median of
    ``repeats``) and the document's bytes."""
    from traceml_tpu_torch.reporting.html.writer import render_html_summary

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter_ns()
        text = render_html_summary(summary)
        times.append((time.perf_counter_ns() - t0) / 1e6)
    return {"ms_median": statistics.median(times), "ms_min": min(times), "bytes": len(text.encode()),
            "repeats": repeats}


def dashboard_run_phase(cfg, train_healthy: dict) -> dict:
    """``python -m traceml_tpu_torch run --mode dashboard`` of ``dev/
    train_script.py`` at full width ((8, 1025) tokens, ``DASHBOARD_STEPS``
    steps, healthy, 0.1 s sender tick), read by a ``DashboardProbe`` while
    the rank trains.  Gates: ``check_train_run``'s with the verdict of the
    MFU's band and the healthy utilization; ``/healthz`` 200 with the
    session; ``/`` HTML naming "TraceML (PyTorch)" and no JAX word;
    ``/api/live`` at version 3 with the session, its step time on the
    device clock with a median above 0, NVML utilization on every device
    row, the script's lines so far in order; ``If-None-Match`` 304 (or 200
    with a new ETag); the ``?since=`` delta a 204 with the same token or
    only the fragments whose versions moved, merged equal to a full read;
    the gzip body equal to the plain one; two ``/api/stream`` events with
    ids within ``STREAM_WINDOW_S``; the last live median step within
    ``FRAME_STEP_REL_TOL`` of the summary's; a stream held open across
    the run's end, closed before the launcher exited; the URL line on the
    launcher's stdout.  Reported: the step against the ``summary`` train
    run's, ``serving_cost`` on this run's session, ``html_render_cost`` on
    the ``summary`` train run's payload."""
    from traceml_tpu_torch.renderers.web_payload import FRAGMENT_ORDER

    name = "train_dashboard"
    probe = DashboardProbe()
    run = launch_run(name, 0.0, 0.1, script="train_script.py", steps=DASHBOARD_STEPS, mode="dashboard",
                     probe=probe)
    got = check_train_run(name, run, cfg, mfu_verdict)
    check_healthy_utilization(name, got)
    check(probe.error is None, f"run {name}: the dashboard probe failed: {probe.error}")
    session_id = run["session"].name
    reads = probe.reads
    check(f"[TraceML] dashboard: http://127.0.0.1:{probe.port}/" in run["stdout"],
          f"run {name}: no dashboard URL line on the launcher's stdout")
    health = reads["healthz"]
    check(health["code"] == 200 and health["body"].get("ok") is True and health["body"].get("session") == session_id,
          f"run {name}: /healthz {health}")
    page = reads["page"]
    words = sorted(set(JAX_WORDS.findall(page["text"])))
    check(page["code"] == 200 and page["type"].startswith("text/html") and "TraceML (PyTorch)" in page["text"]
          and not words, f"run {name}: / answered {page['code']} {page['type']}, JAX words {words}")
    live = reads["live"]
    st = live["step_time"]
    devices = [d for n in live["system"]["nodes"] for d in n.get("devices") or []]
    check(live["version"] == 3 and live["session"] == session_id, f"run {name}: /api/live header {live['version']}"
                                                                    f" {live['session']}")
    check(st["clock"] == "device" and (_live_step_ms(live) or 0) > 0,
          f"run {name}: /api/live step time on the {st['clock']} clock, median {_live_step_ms(live)}")
    check(bool(devices) and all(d.get("utilization_pct") is not None for d in devices),
          f"run {name}: /api/live GPU rows without NVML utilization: {devices}")
    printed = [r["line"] for r in run["tables"]["stdout_samples"] if r["stream"] == "stdout"]
    live_lines = [l["line"] for l in live["stdout"] if l["stream"] == "stdout"]
    at = printed.index(live_lines[0]) if live_lines and live_lines[0] in printed else -1
    check(at >= 0 and printed[at:at + len(live_lines)] == live_lines,
          f"run {name}: /api/live stdout {live_lines} is not the script's lines {printed} in order")
    etag = reads["etag"]
    check(etag["code"] == 304 or (etag["code"] == 200 and etag["etag"] != etag["sent"]),
          f"run {name}: If-None-Match {etag}")
    delta = reads.get("delta")
    check(delta is not None, f"run {name}: no ?since= delta between two full reads with its token in 30 tries")
    if delta["code"] == 204:
        check(delta["token"] == delta["since"], f"run {name}: a 204 delta moved the token {delta['since']} -> "
                                                f"{delta['token']}")
        merged = delta["full_a"]
    else:
        check(delta["code"] == 200, f"run {name}: ?since= answered {delta['code']}")
        before = dict(zip(FRAGMENT_ORDER, delta["since"].split(":")[1].split(".")))
        after = dict(zip(FRAGMENT_ORDER, delta["token"].split(":")[1].split(".")))
        moved = {f for f in FRAGMENT_ORDER if before[f] != after[f]}
        check(set(delta["body"]["fragments"]) == moved,
              f"run {name}: the delta holds {sorted(delta['body']['fragments'])}, the versions moved {sorted(moved)}")
        merged = dict(delta["full_a"])
        for frag in delta["body"]["fragments"].values():
            merged.update(frag)
    check(_canon(merged) == _canon(delta["full_c"]), f"run {name}: the merged delta differs from a full read")
    gz = reads.get("gzip")
    check(gz is not None and gz["code"] == 200 and gz["encoding"] == "gzip" and gz["same"],
          f"run {name}: gzip read {gz}")
    events = reads["stream"]
    check(len(events) >= 2 and all(e["id"] and e["id"] == e["token"] for e in events),
          f"run {name}: /api/stream gave {events} within {STREAM_WINDOW_S} s")
    last_ms, summary_ms = _live_step_ms(probe.last_live or {}), got["step_ms_summary"]
    check(last_ms is not None and abs(last_ms - summary_ms) / summary_ms <= FRAME_STEP_REL_TOL,
          f"run {name}: the last live median step {last_ms} ms vs final_summary.json {summary_ms} ms")
    held = probe.held
    check(held["closed_at"] is not None and held["closed_at"] <= probe.run_ended_at and held["events"] >= 1,
          f"run {name}: the SSE stream held across the run's end: {held}")
    build = (probe.last_live or {}).get("window_build") or {}
    st_build = build.get("step_time") or {}
    fallbacks = [k for k in ((build.get("tick_profile") or {}).get("counters") or {})
                 if k.startswith("vector_fallbacks_")]
    check(st_build.get("incr_ticks", 0) > st_build.get("full_rebuilds", 0) >= 1 and not fallbacks,
          f"run {name}: the last /api/live's window_build {build}")
    check_report_window_build(name, run["summary"])
    train_summary = json.loads((Path(train_healthy["session"]) / "final_summary.json").read_text())
    out = {"flash_launches": got["flash_launches"], "verdict": got["verdict"],
           "step_device_ms_dashboard": got["step_device_ms"],
           "step_device_ms_summary": train_healthy["step_device_ms"],
           "mfu_dashboard": got["efficiency"]["mfu_median"], "mfu_summary": train_healthy["efficiency"]["mfu_median"],
           "wall_s_dashboard": got["wall_s"], "wall_s_summary": train_healthy["wall_s"],
           "live_step_ms_last": last_ms, "summary_step_ms": summary_ms,
           "live_n_steps_first": st["n_steps"], "live_n_steps_last": probe.last_live["step_time"]["n_steps"],
           "delta": {"code": delta["code"], "attempt": delta["attempt"]}, "stream_events_at_s": [
               e["at_s"] for e in events], "held_stream_events": held["events"],
           "held_stream_closed_before_exit_s": probe.run_ended_at - held["closed_at"],
           "window_build": build, "html": run["html"], "serving": serving_cost(run["session"]),
           "html_render": html_render_cost(train_summary)}
    a, b = out["step_device_ms_dashboard"], out["step_device_ms_summary"]
    log("dashboard", "train step device ms, dashboard vs summary: " + ", ".join(
        f"{k} {a[k]:.4f} vs {b[k]:.4f} ({a[k] / b[k]:.4f}x)" for k in a))
    cost = out["serving"]
    log("dashboard", f"poll + full_body µs: first {cost['first_us']:.1f}; dirty median "
                     f"{cost['dirty_us']['median']:.1f} p90 {cost['dirty_us']['p90']:.1f}, idle median "
                     f"{cost['idle_us']['median']:.1f} p90 {cost['idle_us']['p90']:.1f} over {POLL_TIMES} each; "
                     f"full body {cost['full_body_bytes']} bytes, gzip {cost['full_body_gzip_bytes']}")
    log("dashboard", "the last /api/live's window_build: step_time " + json.dumps(st_build) + ", tick profile "
        + json.dumps(build["tick_profile"]))
    log("dashboard", f"render_html_summary on the summary train run's payload: "
                     f"{out['html_render']['ms_median']:.3f} ms, {out['html_render']['bytes']} bytes")
    log("dashboard", json.dumps(out))
    return out


def killed_run_phase() -> dict:
    """``run`` of ``train_script.py --kill-after 20``: the rank sends itself
    SIGKILL after 20 of 60 steps, under the JAX chaos test's settings
    (heartbeat every 0.5 s, stale after 1 s, lost after 3 s, an 8 s
    settle window, so the window crosses the lost line).  Gates: the
    run exits non-zero with the manifest ``failed``; the final summary
    exists, its liveness diagnosis is RANK_LOST, critical, naming rank 0;
    rank 0 is unfinished as ``lost`` with a data gap; the primary
    diagnosis is the liveness one."""
    name = "train_killed"
    env = {"TRACEML_HEARTBEAT_INTERVAL_SEC": "0.5", "TRACEML_LIVENESS_STALE_SEC": "1",
           "TRACEML_LIVENESS_LOST_SEC": "3"}
    run = launch_run(name, 0.0, 0.25, script="train_script.py", script_args=("--kill-after", "20"),
                     launcher_args=("--finalize-timeout", "8"), env_extra=env, expect_ok=False)
    summary, manifest = run["summary"], run["manifest"]
    sec = summary["sections"]["liveness"]
    diag, primary = sec["diagnosis"], summary["primary_diagnosis"]
    out = {"manifest_status": manifest["status"], "exit_code": manifest.get("exit_code"),
           "liveness": {k: sec.get(k) for k in ("thresholds", "ranks", "data_gaps", "unfinished_ranks",
                                                "unfinished_rank_states")},
           "liveness_kinds": [i["kind"] for i in sec["issues"]],
           "primary": {k: primary.get(k) for k in ("kind", "domain", "severity", "summary")},
           "stored_steps": len(run["rows"]), "wall_s": run["wall_s"]}
    log("run", f"{name} " + json.dumps(out))
    check(manifest["status"] == "failed", f"run {name}: manifest status {manifest['status']}")
    check(diag["kind"] == "RANK_LOST" and diag["severity"] == "critical" and 0 in diag["ranks"],
          f"run {name}: liveness diagnosis {diag}")
    check(0 in (sec.get("unfinished_ranks") or []) and (sec.get("unfinished_rank_states") or {}).get("0") == "lost",
          f"run {name}: unfinished {sec.get('unfinished_ranks')} {sec.get('unfinished_rank_states')}")
    check("0" in (sec.get("data_gaps") or {}), f"run {name}: data gaps {sec.get('data_gaps')}")
    check(primary.get("domain") == "liveness" and primary["kind"] in ("RANK_LOST", "LIKELY_PREEMPTED"),
          f"run {name}: primary diagnosis {primary}")
    return out


RESTART_KILL_AT = 0.4  # where in the healthy run's loop the restart run's aggregator is killed


def _payloads_before(session: Path, t: float) -> int:
    """About how many payloads the aggregator of ``session`` (one rank,
    every sampler publishing each tick) had drained by wall time ``t``:
    the system and process envelopes carry one row a tick, the step-time
    and step-memory ones a step or two; the few control messages are
    left out."""
    conn = sqlite3.connect(session / "telemetry.sqlite")
    try:
        return sum(conn.execute(f"SELECT COUNT(*) FROM {table} WHERE timestamp < ?", (t,)).fetchone()[0]
                   for table in ("system_samples", "process_samples", "step_time_samples",
                                 "step_memory_samples"))
    finally:
        conn.close()


def _step_times(session: Path) -> list:
    """(global_rank, step, timestamp) of every stored step row, in id order."""
    conn = sqlite3.connect(session / "telemetry.sqlite")
    try:
        return [tuple(r) for r in conn.execute(
            "SELECT global_rank, step, timestamp FROM step_time_samples ORDER BY id")]
    finally:
        conn.close()


def aggregator_restart_phase(cfg, train_healthy: dict, transport: str = "shm") -> dict:
    """``run --mode summary`` of ``dev/train_script.py`` at full width (one
    rank, 60 steps, 0.1 s tick), over ``transport`` (the default shm ring,
    or pinned to ``tcp``), whose aggregator is SIGKILLed mid-loop by
    ``TRACEML_FAULT_PLAN=[{"point": "aggregator.ingest", "action":
    "kill9", "after": N}]``; N is the number of payloads the healthy
    ``summary`` train run had ingested ``RESTART_KILL_AT`` of the way into
    its loop.  The launcher restarts the aggregator on the pinned port,
    the rank replays its spool and the writer drops the duplicates by
    seq.  Gates: ``check_train_run``'s (device clock, 12 x 60 launches,
    the verdict of the MFU's band, the HTML) with the manifest
    ``completed`` / ``restarted`` / one restart and nothing lost in the
    spool; ``restarting`` on the launcher's stdout; the stored (rank,
    step) pairs each once and equal to the healthy run's; rank 0 in the
    summary's ``meta.topology.ranks_seen``; the launcher's
    notice of the death (the crash log's mtime, within one 0.1 s
    supervise poll of the kill) and the new ready file both before the
    rank's last stored step, and the notice after its first; over the ring
    also no ring-full drop (the restarted aggregator re-attached the ring,
    whose uncommitted window it drained again).  Reported: the time from
    that notice to the new ready file, the rank's reconnects (over the
    ring, consumer-generation flips), replayed envelopes and spool bytes,
    the writer's replay duplicates, and the step's device median against
    the healthy ``summary`` run's."""
    healthy_session = Path(train_healthy["session"])
    healthy_steps = _step_times(healthy_session)
    stamps = sorted(ts for _, _, ts in healthy_steps)
    after = _payloads_before(healthy_session, stamps[int(RESTART_KILL_AT * len(stamps))])
    name = "train_restart" if transport == "shm" else f"train_restart_{transport}"
    plan = json.dumps([{"point": "aggregator.ingest", "action": "kill9", "after": after}])
    log("restart", f"{name}: kill9 after {after} payloads ({RESTART_KILL_AT:.0%} into the healthy run's loop; "
                   f"it ingested {train_healthy['envelopes_ingested']} envelopes in all), over {transport}")
    env = {"TRACEML_FAULT_PLAN": plan, **({"TRACEML_TRANSPORT": transport} if transport != "shm" else {})}
    run = launch_run(name, 0.0, 0.1, script="train_script.py", launcher_args=("--finalize-timeout", "60"),
                     env_extra=env, transport=transport)
    got = check_train_run(name, run, cfg, mfu_verdict, telemetry_status="restarted")
    check("restarting" in run["stdout"], f"run {name}: no 'restarting' on the launcher's stdout")
    session = run["session"]
    steps = _step_times(session)
    pairs = [(r, st) for r, st, _ in steps]
    check(len(pairs) == len(set(pairs)), f"run {name}: {len(pairs) - len(set(pairs))} duplicate step rows")
    check(set(pairs) == {(r, st) for r, st, _ in healthy_steps},
          f"run {name}: stored steps differ from the healthy run's")
    ranks_seen = run["summary"]["meta"]["topology"]["ranks_seen"]
    check(ranks_seen == [0], f"run {name}: ranks_seen {ranks_seen}")
    crash_logs = [Path(c) for c in run["manifest"].get("crash_logs") or [] if "aggregator" in c]
    check(len(crash_logs) == 1 and crash_logs[0].exists(), f"run {name}: aggregator crash logs {crash_logs}")
    noticed = crash_logs[0].stat().st_mtime
    ready = json.loads((session / "aggregator_ready.json").read_text())["ts"]
    first, last = min(ts for _, _, ts in steps), max(ts for _, _, ts in steps)
    killed_at_step = sum(1 for _, _, ts in steps if ts <= noticed)
    check(first < noticed < ready < last,
          f"run {name}: the kill (noticed {noticed}) or the restart (ready {ready}) fell outside the loop "
          f"({first} .. {last})")
    producer = run["ingest"]["producers"]["0"]["transport"]
    if transport == "shm":
        check(producer.get("ring_full_drops") == 0, f"run {name}: ring-full drops {producer.get('ring_full_drops')}")
    out = {
        "transport": transport, "frames_by_kind": run["transport"]["frames_by_kind"],
        "ring_full_drops": producer.get("ring_full_drops"), "shm": run["transport"].get("shm"),
        "after": after, "killed_at_step": killed_at_step, "steps": len(pairs),
        "notice_to_ready_s": ready - noticed, "ready_to_last_step_s": last - ready,
        "reconnects": producer["reconnects"], "replayed_envelopes": producer["replayed_envelopes"],
        "spooled_envelopes": producer["spooled_envelopes"], "spool_bytes": producer["spool_bytes"],
        "batches_dropped": producer["batches_dropped"],
        "replay_duplicates": run["ingest"]["replay_duplicates"],
        "step_device_ms": got["step_device_ms"], "step_device_ms_healthy": train_healthy["step_device_ms"],
        "verdict": got["verdict"], "flash_launches": got["flash_launches"], "wall_s": got["wall_s"],
        "finalize_s": got["finalize_s"],
    }
    log("restart", f"{name} " + json.dumps(out))
    run_ms, ref_ms = got["step_device_ms"], train_healthy["step_device_ms"]
    log("restart", f"train step device ms, restarted ({transport}) vs healthy summary run: " + ", ".join(
        f"{k} {run_ms[k]:.4f} vs {ref_ms[k]:.4f} ({run_ms[k] / ref_ms[k]:.4f}x)" for k in run_ms))
    return out


BOUNDED_STEPS = 400  # ~47 s of the full-width train step: several 10 s rollup buckets
BOUNDED_CAP = 340  # --trace-max-steps: the 340 live step rows pass retention + slack (60 + 256)
BOUNDED_WINDOW = 40  # --summary-window-rows: retention 60 raw rows, past the summary's 50 aligned steps
BOUNDED_LATE_STEPS = 5  # steps the drain tick may ship past the cap (flushed before it ran)
STDERR_MARKER = "train_script: stderr marker, loop ended at "


class IngestProbe:
    """Reads the session's ``ingest_stats.json`` every 0.2 s while a
    ``run`` call goes, from a thread beside ``launch_run``; it keeps the
    ``ts`` of the first snapshot whose ``finished_ranks`` holds rank 0
    (the aggregator writes one every 5 s)."""

    def __init__(self) -> None:
        self.done = threading.Event()
        self.run_ended_at = None
        self.error = None
        self.finished_ts = None

    def run(self, logs: Path) -> None:
        try:
            while not self.done.wait(0.2):
                for path in logs.glob("*/ingest_stats.json"):
                    try:
                        stats = json.loads(path.read_text())
                    except (OSError, ValueError):
                        continue  # written atomically, but the session may be new
                    if self.finished_ts is None and 0 in stats.get("finished_ranks", []) and not stats.get("final"):
                        self.finished_ts = stats["ts"]
        except Exception as exc:
            self.error = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))


def _walk_backup(path: Path) -> int:
    """Every frame of one backup file, v1 or v2, decoded with the wire
    codec; the walk must end exactly at the end of the file.  Returns the
    frames."""
    from traceml_tpu_torch.database.database_writer import V2_MAGIC
    from traceml_tpu_torch.utils import msgpack_codec

    data, pos, frames = path.read_bytes(), 0, 0
    while pos < len(data):
        if data[pos:pos + 4] == V2_MAGIC:
            pos += 4
        check(pos + 4 <= len(data), f"{path}: torn frame header at byte {pos}")
        n = int.from_bytes(data[pos:pos + 4], "big")
        check(pos + 4 + n <= len(data), f"{path}: torn frame body at byte {pos}")
        msgpack_codec.decode(data[pos + 4:pos + 4 + n])  # raises CodecError on a bad frame
        pos, frames = pos + 4 + n, frames + 1
    return frames


def _timed_cli(*args) -> tuple:
    """One ``python -m traceml_tpu_torch`` read command: its stdout and
    wall seconds; it must exit 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "traceml_tpu_torch", *args], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{' '.join(args[:1])} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, wall


def bounded_run_phase(cfg, train_healthy: dict) -> dict:
    """A long run kept bounded: ``run --mode cli`` of ``dev/train_script.py``
    at full width, ``BOUNDED_STEPS`` steps at the 0.1 s tick, with
    ``--trace-max-steps BOUNDED_CAP --summary-window-rows BOUNDED_WINDOW
    --disk-backup --no-capture-stderr``; the script prints one marker line
    to stderr when its loop ends.  Gates:

    * the run: exit 0, manifest ``completed`` / ``ok``, the verdict of the
      MFU's band, every stored step row on the device clock, 12 flash
      launches a step over all ``BOUNDED_STEPS``, the system and process
      gates of ``check_telemetry``, the HTML (``check_html``);
    * the recording stop: the rank's disk backup holds every step once;
      the steps stamped before the loop's end are 1..k with k from
      ``BOUNDED_CAP`` to ``BOUNDED_CAP + BOUNDED_LATE_STEPS`` (the drain
      tick ships what was flushed before it ran), the rest come after it,
      in the final drain, as in JAX; no system or process row is stamped
      later than one tick after step ``BOUNDED_CAP``'s row until the loop
      ends; ``rank_finished`` reached the aggregator (``ingest_stats``)
      before the loop ended;
    * retention and rollups: after ``finalize`` no partition of a
      retention table holds more than 1.5 x ``BOUNDED_WINDOW`` rows; a
      ``retention_watermarks`` row of ``step_time_samples`` stamped before
      the loop's end (an online prune); the 10 s tier's rank-grain
      ``step_ms`` count plus the raw survivors equals the backup's step
      rows, and their sum the backup's sum of ``step_ms`` within 1e-9;
    * the report: ``history.step_time.step_ms`` from the first step's
      10 s bucket to the last one's, one rank; "History:" in the text;
    * ``view`` prints ``final_summary.txt``, ``view --format json`` the
      JSON; ``inspect`` of ``rank_0/data`` exits 0 and every backup frame
      decodes, the walk ending at each file's end; ``inspect --domain
      rollup`` lists the step_time and step_memory tiers;
    * ``--no-capture-stderr``: the marker is on the launcher's stderr, in
      no ``stdout_samples`` row and not in ``rank_0/stdout.log``.

    Reported: the step's device median (all backed-up steps) against the
    healthy ``summary`` train run's, backup bytes per step and the sender's
    backup writes per busy tick, the prunes and their p99, the tier rows,
    the wall time of each read command."""
    from traceml_tpu_torch.aggregator.sqlite_writers import ALL_WRITERS
    from traceml_tpu_torch.database.database_writer import iter_backup_tables
    from traceml_tpu_torch.utils import timing as T

    name, retention, interval = "train_bounded", int(BOUNDED_WINDOW * 1.5), 0.1
    probe = IngestProbe()
    run = launch_run(name, 0.0, interval, script="train_script.py", steps=BOUNDED_STEPS, mode="cli",
                     script_args=("--stderr-marker",), probe=probe,
                     launcher_args=("--trace-max-steps", str(BOUNDED_CAP), "--summary-window-rows",
                                    str(BOUNDED_WINDOW), "--disk-backup", "--no-capture-stderr"))
    check(probe.error is None, f"run {name}: the ingest probe failed: {probe.error}")
    session, summary, manifest, ingest = run["session"], run["summary"], run["manifest"], run["ingest"]
    check((manifest["status"], manifest["telemetry_status"]) == ("completed", "ok"),
          f"run {name}: manifest {manifest['status']}/{manifest['telemetry_status']}")
    kind = summary["primary_diagnosis"]["kind"]
    check(kind == mfu_verdict(summary), f"run {name}: verdict {kind}, not {mfu_verdict(summary)}")
    launch_lines = [l for l in run["stdout"].splitlines() if l.startswith("flash_attention.launches ")]
    launches = int(launch_lines[-1].split()[1]) if launch_lines else None
    check(launches == cfg.n_layers * BOUNDED_STEPS,
          f"run {name}: rank reports {launches} flash launches, not {cfg.n_layers} x {BOUNDED_STEPS}")
    telemetry = check_telemetry(name, run)

    # the recording stop, read from the rank's disk backup (the database
    # keeps the last `retention` rows only)
    marker = [l for l in run["stderr"].splitlines() if l.startswith(STDERR_MARKER)]
    check(len(marker) == 1, f"run {name}: {len(marker)} stderr marker lines on the launcher's stderr")
    loop_end = float(marker[0][len(STDERR_MARKER):])
    data = session / "rank_0" / "data"
    backed = {t: [] for t in ("step_time", "system", "system_device", "process", "process_device")}
    for sampler in ("step_time", "system", "process"):
        for table, row in iter_backup_tables(data / sampler / "envelopes.msgpack"):
            if table in backed:
                backed[table].append(row)
    steps = sorted(r["step"] for r in backed["step_time"])
    check(steps == list(range(1, BOUNDED_STEPS + 1)), f"run {name}: the backup holds steps {steps[:3]}... "
                                                       f"({len(steps)} rows) for {BOUNDED_STEPS}")
    by_step = {r["step"]: r for r in backed["step_time"]}
    live = sorted(s for s, r in by_step.items() if r["timestamp"] < loop_end)
    k = len(live)
    host_steps = sorted(s for s, r in by_step.items() if r["clock"] != "device")
    log("bounded", f"{name}: {k} steps stamped before the loop's end, host-clock steps {host_steps}; "
                   f"rank_finished in ingest_stats at {probe.finished_ts}, loop end {loop_end}, "
                   f"step {BOUNDED_CAP} stamped {by_step[BOUNDED_CAP]['timestamp'] - loop_end:+.3f} s from it")
    check(all(r[1] == "device" and json.loads(r[2])[T.STEP_TIME]["device_ms"] is not None for r in run["rows"])
          and not host_steps, f"run {name}: step rows off the device clock: {host_steps}")
    check(live == list(range(1, k + 1)) and BOUNDED_CAP <= k <= BOUNDED_CAP + BOUNDED_LATE_STEPS,
          f"run {name}: {k} steps stamped before the loop's end (cap {BOUNDED_CAP}), not 1..k")
    cap_ts = by_step[BOUNDED_CAP]["timestamp"]
    late = [(t, r["timestamp"]) for t in ("system", "system_device", "process", "process_device")
            for r in backed[t] if cap_ts + interval < r["timestamp"] < loop_end]
    check(not late, f"run {name}: {len(late)} system/process rows while recording was stopped: {late[:3]}")
    check(probe.finished_ts is not None and probe.finished_ts < loop_end,
          f"run {name}: rank_finished seen at {probe.finished_ts}, the loop ended at {loop_end}")
    check(ingest["finished_ranks"] == [0], f"run {name}: finished ranks {ingest['finished_ranks']}")

    def step_ms(row):
        ev = row["events"][T.STEP_TIME]
        return ev["device_ms"] if row["clock"] == "device" and ev.get("device_ms") is not None else ev["cpu_ms"]

    # retention and the rollup tiers
    conn = sqlite3.connect(session / "telemetry.sqlite")
    try:
        fullest = {}
        for table in sorted({t for w in ALL_WRITERS for t in w.RETENTION_TABLES}):
            fullest[table] = max((n for (n,) in conn.execute(
                f"SELECT COUNT(*) FROM {table} GROUP BY session_id, global_rank")), default=0)
        online = conn.execute("SELECT MIN(ts) FROM retention_watermarks WHERE table_name='step_time_samples'"
                              ).fetchone()[0]
        raw = [json.loads(ev) for (ev,) in conn.execute("SELECT events_json FROM step_time_samples")]
        clocks = [c for (c,) in conn.execute("SELECT clock FROM step_time_samples")]
        tier_n, tier_sum = conn.execute(
            "SELECT SUM(count), SUM(sum) FROM rollup_samples_10s WHERE source_table='step_time_samples'"
            " AND grain='rank' AND grain_key='0' AND metric='step_ms'").fetchone()
        tier_rows = {t: conn.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
                     for t in ("rollup_samples_10s", "rollup_samples_1m")}
        stdout_lines = [l for (l,) in conn.execute("SELECT line FROM stdout_samples")]
    finally:
        conn.close()
    check(max(fullest.values()) <= retention and fullest["step_time_samples"] == retention,
          f"run {name}: rows per partition after finalize {fullest}, retention {retention}")
    check(online is not None and online < loop_end,
          f"run {name}: no step_time_samples prune before the loop's end (first at {online}, end {loop_end})")
    raw_ms = [ev[T.STEP_TIME]["device_ms"] if c == "device" else ev[T.STEP_TIME]["cpu_ms"]
              for ev, c in zip(raw, clocks)]
    backup_sum = math.fsum(step_ms(r) for r in backed["step_time"])
    check(tier_n is not None and tier_n + len(raw_ms) == len(backed["step_time"]),
          f"run {name}: 10 s tier {tier_n} + raw {len(raw_ms)} != {len(backed['step_time'])} backed-up steps")
    check(abs(tier_sum + math.fsum(raw_ms) - backup_sum) <= 1e-9 * backup_sum,
          f"run {name}: tier + raw step_ms sum {tier_sum + math.fsum(raw_ms)} vs backup {backup_sum}")

    # the history block and line
    hist = (summary.get("history") or {}).get("step_time", {}).get("step_ms") or {}
    pts = hist.get("points") or []
    first_bucket = math.floor(by_step[1]["timestamp"] / 10.0) * 10.0
    last_bucket = math.floor(by_step[BOUNDED_STEPS]["timestamp"] / 10.0) * 10.0
    check(hist.get("ranks") == 1 and pts and pts[0]["t"] == round(first_bucket, 3)
          and pts[-1]["t"] == round(last_bucket, 3),
          f"run {name}: history {len(pts)} points from {pts[0]['t'] if pts else None} "
          f"({first_bucket} .. {last_bucket} wanted), ranks {hist.get('ranks')}")
    txt = (session / "final_summary.txt").read_text()
    history_line = [l for l in txt.splitlines() if l.startswith("History:")]
    check(len(history_line) == 1, f"run {name}: {len(history_line)} History lines in final_summary.txt")

    # view and inspect, as a user calls them
    view_txt, view_s = _timed_cli("view", str(session))
    check(view_txt == txt + "\n", f"run {name}: view printed something else than final_summary.txt")
    view_json, view_json_s = _timed_cli("view", str(session), "--format", "json")
    check(json.loads(view_json) == summary, f"run {name}: view --format json differs from final_summary.json")
    dump, inspect_s = _timed_cli("inspect", str(data))
    files = sorted(data.rglob("*.msgpack"))
    frames = {str(f.relative_to(data)): _walk_backup(f) for f in files}
    check(all(f"── {f}" in dump for f in files) and all(frames.values()),
          f"run {name}: inspect listed {dump.count('── ')} of {len(files)} backup files; frames {frames}")
    tiers_out, rollup_s = _timed_cli("inspect", "--domain", "rollup", str(session))
    check("step_time.step_ms" in tiers_out and "step_memory.current_bytes" in tiers_out,
          f"run {name}: inspect --domain rollup printed {tiers_out[:400]!r}")

    # --no-capture-stderr
    stdout_log = (session / "rank_0" / "stdout.log").read_text()
    check(not any(STDERR_MARKER in l for l in stdout_lines) and STDERR_MARKER not in stdout_log,
          f"run {name}: the stderr marker reached the captured output")
    check(any(l.startswith("train_script: ") for l in stdout_lines), f"run {name}: no script stdout captured")

    device = [r["events"][T.STEP_TIME]["device_ms"] for r in backed["step_time"]]
    backup_bytes = sum(f.stat().st_size for f in files)
    prune = ingest["prune"]
    producer = ingest["producers"]["0"]
    busy = producer["ticks"] - producer["idle_ticks"]
    out = {
        "verdict": kind, "flash_launches": launches, "steps_live": k, "loop_end_to_last_step_s":
            by_step[BOUNDED_STEPS]["timestamp"] - loop_end, "rank_finished_ingest_ts_before_loop_end_s":
            loop_end - probe.finished_ts, "first_prune_before_loop_end_s": loop_end - online,
        "step_device_ms": spread(device), "step_device_ms_healthy": train_healthy["step_device_ms"],
        "backup_bytes": backup_bytes, "backup_bytes_per_step": backup_bytes / BOUNDED_STEPS,
        "backup_frames": frames, "backup_ms_per_busy_tick":
            sum(v["backup_us"] for v in producer["samplers"].values()) / busy / 1e3, "prune": prune, "rollup": ingest.get("rollup"), "tier_rows": tier_rows,
        "rows_per_partition_max": fullest, "history_points": len(pts), "history_line": history_line[0],
        "view_s": view_s, "view_json_s": view_json_s, "inspect_s": inspect_s, "inspect_rollup_s": rollup_s,
        "wall_s": run["wall_s"], "finalize_s": manifest.get("finalize_sec"),
        "nvml_utilization_pct_recent_mean": telemetry["utilization_pct_recent_mean"],
        "session": str(session),
    }
    log("bounded", f"{name} " + json.dumps(out))
    run_ms, ref_ms = out["step_device_ms"], train_healthy["step_device_ms"]
    log("bounded", "train step device ms, bounded cli run (all backed-up steps) vs healthy summary run: " + ", ".join(
        f"{key} {run_ms[key]:.4f} vs {ref_ms[key]:.4f} ({run_ms[key] / ref_ms[key]:.4f}x)" for key in run_ms))
    return out


def transport_run_phase(cfg, train_healthy: dict) -> dict:
    """``run --mode summary`` of ``dev/train_script.py`` at full width (one
    rank, 60 steps, 0.1 s tick) over the Unix socket with envelope
    compression: ``TRACEML_TRANSPORT=uds TRACEML_TRANSPORT_COMPRESS=zstd``
    (zlib where ``libzstd.so.1`` does not load here; logged).  Gates: the
    healthy train run's (``check_train_run``, the verdict of the MFU's
    band); every frame over ``uds`` and the rank's hello ``uds`` with the
    codec (``check_transport``); compressed envelopes restored, none
    failing.  Reported: the producer's compression ratio (bytes offered
    over bytes on the wire, over the envelopes it compressed, and how many
    passed through), the server's, and the step's device median against
    the healthy ``summary`` run's."""
    from traceml_tpu_torch.transport import compression

    codec = "zstd" if "zstd" in compression.available_codecs() else "zlib"
    log("transport", f"uds run codec {codec} (available: {compression.available_codecs()})")
    name = "train_uds_" + codec
    run = launch_run(name, 0.0, 0.1, script="train_script.py", transport="uds", codec=codec,
                     env_extra={"TRACEML_TRANSPORT": "uds", "TRACEML_TRANSPORT_COMPRESS": codec})
    got = check_train_run(name, run, cfg, mfu_verdict)
    server = run["transport"]["compression"]
    check(server["envelopes"] > 0 and server["errors"] == 0, f"run {name}: server compression {server}")
    producer = run["ingest"]["producers"]["0"]["transport"]["compression"]
    check(producer["codec"] == codec and producer["envelopes_compressed"] > 0,
          f"run {name}: producer compression {producer}")
    out = {"codec": codec, "producer_compression": producer, "server_compression": server,
           "server_ratio": server["bytes_decoded"] / server["bytes_in"],
           "frames_by_kind": run["transport"]["frames_by_kind"], "verdict": got["verdict"],
           "flash_launches": got["flash_launches"], "step_device_ms": got["step_device_ms"],
           "step_device_ms_healthy": train_healthy["step_device_ms"], "wall_s": got["wall_s"],
           "finalize_s": got["finalize_s"]}
    log("transport", f"{name} " + json.dumps(out))
    run_ms, ref_ms = got["step_device_ms"], train_healthy["step_device_ms"]
    log("transport", f"train step device ms, uds + {codec} vs healthy summary run (shm): " + ", ".join(
        f"{k} {run_ms[k]:.4f} vs {ref_ms[k]:.4f} ({run_ms[k] / ref_ms[k]:.4f}x)" for k in run_ms))
    return out


TRANSPORT_REPEATS = 5


def transport_phase(bounded: dict) -> dict:
    """The transport tier in process on real full-width telemetry: every
    envelope of the bounded run's disk backup (``rank_0/data/*/
    envelopes.msgpack``), pushed one a frame through each arm of
    ``traceml_tpu_torch/dev/transport_bench.py`` (tcp with the C and the
    Python frame split, uds, shm with ``ring.c`` and the Python twin,
    segments in ``/dev/shm``, tcp with zstd and with zlib),
    ``TRANSPORT_REPEATS`` runs each, interleaved.  Gates: each arm's
    decoded list equals the backup's envelopes; the compressed arms
    compressed and restored with no error.  Reported: frames/s and MB/s
    per arm, native over Python, shm and uds over tcp, the ring and the
    frame split alone, and each codec's µs an envelope and ratio."""
    from traceml_tpu_torch.database.database_writer import V2_MAGIC
    from traceml_tpu_torch.dev.transport_bench import run_arms
    from traceml_tpu_torch.transport.shm_ring import default_ring_dir
    from traceml_tpu_torch.utils import msgpack_codec

    bodies = []
    for path in sorted((Path(bounded["session"]) / "rank_0" / "data").rglob("envelopes.msgpack")):
        data, pos = path.read_bytes(), 0
        while pos < len(data):
            if data[pos:pos + 4] == V2_MAGIC:
                pos += 4
            n = int.from_bytes(data[pos:pos + 4], "big")
            body = data[pos + 4:pos + 4 + n]
            enc = msgpack_codec.preencode(msgpack_codec.decode(body))
            check(enc.body == body, f"{path}: a backup envelope does not re-encode to its bytes")
            bodies.append(enc)
            pos += 4 + n
    check(len(bodies) > 100, f"transport phase: {len(bodies)} envelopes in the bounded run's backup")
    out = run_arms(bodies, ring_dir=default_ring_dir(), repeats=TRANSPORT_REPEATS)
    for arm, got in out["arms"].items():
        check(got["equal"], f"transport arm {arm}: the decoded envelopes differ from the backup's")
        check(got["decompress_errors"] == 0 and (got["compressed"] > 0) == arm.startswith("tcp_z"),
              f"transport arm {arm}: {got['compressed']} envelopes restored, {got['decompress_errors']} errors")
    for arm, got in out["arms"].items():
        log("transport", f"{arm}: {got['frames_per_s']:.1f} frames/s, {got['mb_per_s']:.3f} MB/s "
                         f"(fastest of {TRANSPORT_REPEATS}: {got['seconds_min'] * 1e3:.3f} ms, median "
                         f"{got['seconds_median'] * 1e3:.3f} ms; {got['wire_bytes']} wire bytes, "
                         f"{got['send_retries']} full-ring retries)")
    log("transport", f"{out['envelopes']} envelopes, {out['body_bytes']} body bytes; ratios "
                     + json.dumps(out["ratios"]))
    log("transport", "alone " + json.dumps(out["alone"]) + "; codecs " + json.dumps(out["codecs"]))
    return out


COLLECTIVES_GRAD_BYTES = 700_551_168  # the flat f32 gradients: 175,137,792 parameters x 4 bytes
COLLECTIVES_STEP_REL = 1.10  # the synced step's steady median against train_healthy's
COMM_BOUND_STEPS = 30  # the collectives summary policy needs 10 steps
COMM_BOUND_SLEEP_MS = 100.0  # the slow link: a host stall inside the sync, after the device synchronized
COMM_BOUND_SHARE_WARN = 0.25  # the summary policy's exposed-share warning line (critical at 0.40)


def _dist_env() -> dict:
    """The process group's rendezvous for a one-rank NCCL group: the
    caller's ``MASTER_ADDR`` and ``MASTER_PORT`` (a free local port), and
    NCCL's bootstrap on the loopback interface."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "NCCL_SOCKET_IFNAME": "lo"}


def _session_rows(run: dict, sql: str) -> list:
    conn = sqlite3.connect(run["session"] / "telemetry.sqlite")
    try:
        return conn.execute(sql).fetchall()
    finally:
        conn.close()


def check_mesh(name: str, run: dict) -> dict:
    """The one-rank mesh of ``make_mesh()``: one ``mesh_topology`` row,
    the four canonical axes of size 1 (ICI: one node), coordinates
    [0, 0, 0, 0], source ``mesh``; the same in ``meta.topology.mesh``."""
    axes = [{"name": a, "size": 1, "kind": "ici"} for a in ("data", "fsdp", "tensor", "context")]
    rows = _session_rows(run, "SELECT global_rank, source, axes_json, coords_json FROM mesh_topology")
    got = [(r[0], r[1], json.loads(r[2]), json.loads(r[3])) for r in rows]
    check(got == [(0, "mesh", axes, [0, 0, 0, 0])], f"run {name}: mesh_topology rows {got}")
    mesh = run["summary"]["meta"]["topology"].get("mesh")
    check(mesh == {"axes": axes, "source": "mesh", "ranks": 1, "hosts": 1}, f"run {name}: meta mesh {mesh}")
    return mesh


def collectives_numbers(sec: dict) -> dict:
    g = sec.get("global") or {}
    return {k: g.get(k) for k in ("n_steps", "group_size", "bytes_per_step", "comm_ms_per_step",
                                  "exposed_ms_per_step", "overlap_efficiency", "exposed_share_of_step",
                                  "comm_share_of_step")} | {
        "issues": [(i["kind"], i["severity"]) for i in sec.get("issues", [])]}


def collectives_run_phase(cfg, train_healthy: dict) -> dict:
    """``train_collectives``: the healthy full-width train run with a
    data-parallel gradient sync (``--mesh --grad-sync all_reduce``): a
    one-rank NCCL group, ``make_mesh()``, and after each backward one
    ``dist.all_reduce`` of the flat f32 gradients recorded by
    ``instrument_collective`` (``dev/workload.py`` ``gradient_sync``),
    with ``--disk-backup``.  Gates: the healthy train run's; the
    ``collectives`` section OK over 60 steps, op ``all_reduce`` alone,
    group size 1, ``COLLECTIVES_GRAD_BYTES`` a step; every stored row
    ``all_reduce``, ``float32``, those bytes, count 1; ALLREDUCE_QUANTIZABLE
    at 668.1 MiB/step and no COMM_BOUND; the ``collective`` phase's device
    time on every step row; the mesh (``check_mesh``); ``inspect
    --domain collectives`` printing ``overlap_efficiency``; the steady
    step at most ``COLLECTIVES_STEP_REL`` x ``train_healthy``'s."""
    from traceml_tpu_torch.utils import timing as T

    name = "train_collectives"
    run = launch_run(name, 0.0, 0.1, script="train_script.py", script_args=("--mesh", "--grad-sync", "all_reduce"),
                     launcher_args=("--disk-backup",), env_extra=_dist_env())
    got = check_train_run(name, run, cfg, mfu_verdict)
    check_healthy_utilization(name, got)
    sec = run["summary"]["sections"]["collectives"]
    numbers = collectives_numbers(sec)
    log("run", f"{name}: collectives " + json.dumps(numbers))
    check(sec["status"] == "OK", f"run {name}: collectives section {sec['status']}")
    g = sec["global"]
    check(g["n_steps"] == run["steps"] and g["group_size"] == 1 and list(g["per_op"]) == ["all_reduce"],
          f"run {name}: collectives window {numbers} ops {list(g['per_op'])}")
    check(g["bytes_per_step"] == float(COLLECTIVES_GRAD_BYTES),
          f"run {name}: {g['bytes_per_step']} bytes a step, not {COLLECTIVES_GRAD_BYTES}")
    rows = _session_rows(run, "SELECT step, op, dtype, count, bytes, group_size FROM collectives_samples ORDER BY id")
    check([r[0] for r in rows] == list(range(1, run["steps"] + 1))
          and {r[1:] for r in rows} == {("all_reduce", "float32", 1, COLLECTIVES_GRAD_BYTES, 1)},
          f"run {name}: collectives rows {rows[:3]}... ({len(rows)})")
    kinds = {i["kind"]: i for i in sec["issues"]}
    quant = kinds.get("ALLREDUCE_QUANTIZABLE")
    check(quant is not None and quant["evidence"]["fp32_allreduce_mib_per_step"] == 668.1,
          f"run {name}: ALLREDUCE_QUANTIZABLE {quant}")
    check("COMM_BOUND" not in kinds, f"run {name}: COMM_BOUND on a healthy sync: {kinds.get('COMM_BOUND')}")
    coll_ms = [json.loads(ev).get(T.COLLECTIVE_TIME, {}).get("device_ms") for _, _, ev in run["rows"]]
    check(all(v is not None and v > 0 for v in coll_ms), f"run {name}: collective device_ms {coll_ms[:5]}")
    mesh = check_mesh(name, run)
    proc = subprocess.run([sys.executable, "-m", "traceml_tpu_torch", "inspect", str(run["session"] / "rank_0" / "data"),
                           "--domain", "collectives", "--limit", "3"], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    check(proc.returncode == 0 and "overlap_efficiency" in proc.stdout,
          f"run {name}: inspect --domain collectives rc {proc.returncode}: {proc.stdout[-500:]}{proc.stderr[-500:]}")
    first = next(l for l in proc.stdout.splitlines() if l.startswith("{"))
    ratio = got["steady_state_ms"] / train_healthy["steady_state_ms"]
    log("run", f"{name}: steady step {got['steady_state_ms']:.4f} ms vs train_healthy "
               f"{train_healthy['steady_state_ms']:.4f} ms: {ratio:.4f}x (gate {COLLECTIVES_STEP_REL}x); "
               f"collective phase device ms {json.dumps(spread([v for v in coll_ms if v is not None]))}; "
               f"mesh {json.dumps(mesh)}; inspect {first}")
    check(ratio <= COLLECTIVES_STEP_REL, f"run {name}: steady step {ratio:.4f}x train_healthy's")
    return {**got, "collectives": numbers, "step_ratio": ratio,
            "collective_device_ms": spread([v for v in coll_ms if v is not None])}


def comm_bound_run_phase(cfg) -> dict:
    """``train_comm_bound``: the synced train run at ``COMM_BOUND_STEPS``
    steps with a slow link (``--sync-sleep-ms COMM_BOUND_SLEEP_MS``: the
    sync synchronizes the device, then stalls on the host inside the
    recorded window before its all-reduce).  Gates: exit 0, the manifest
    ``completed`` / ``ok``, 12 launches a step, the collectives section OK
    with COMM_BOUND among its issues and its exposed share of the step
    past the warning line; the mesh.  Reported: exposed ms a step, the
    share, the severity."""
    name = "train_comm_bound"
    run = launch_run(name, 0.0, 0.1, script="train_script.py", steps=COMM_BOUND_STEPS,
                     script_args=("--mesh", "--grad-sync", "all_reduce", "--sync-sleep-ms", repr(COMM_BOUND_SLEEP_MS)),
                     env_extra=_dist_env())
    manifest, summary = run["manifest"], run["summary"]
    check((manifest["status"], manifest["telemetry_status"]) == ("completed", "ok"),
          f"run {name}: manifest {manifest['status']}/{manifest['telemetry_status']}")
    launch_lines = [l for l in run["stdout"].splitlines() if l.startswith("flash_attention.launches ")]
    launches = int(launch_lines[-1].split()[1]) if launch_lines else None
    check(launches == cfg.n_layers * COMM_BOUND_STEPS, f"run {name}: {launches} flash launches")
    sec = summary["sections"]["collectives"]
    numbers = collectives_numbers(sec)
    st = summary["sections"]["step_time"]
    step_ms = (((st.get("global") or {}).get("phases") or {}).get("step_time") or {}).get("median_ms")
    log("run", f"{name}: collectives " + json.dumps(numbers) + f"; step median {step_ms} ms; "
               f"exposed_ms_per_step {numbers['exposed_ms_per_step']} share {numbers['exposed_share_of_step']}")
    check(sec["status"] == "OK" and numbers["n_steps"] == COMM_BOUND_STEPS,
          f"run {name}: collectives section {sec['status']} {numbers}")
    comm = [i for i in sec["issues"] if i["kind"] == "COMM_BOUND"]
    check(bool(comm), f"run {name}: no COMM_BOUND: {numbers['issues']}")
    check((numbers["exposed_share_of_step"] or 0.0) >= COMM_BOUND_SHARE_WARN,
          f"run {name}: exposed share {numbers['exposed_share_of_step']}")
    check_mesh(name, run)
    return {"collectives": numbers, "comm_bound": {k: comm[0].get(k) for k in ("severity", "summary", "evidence")},
            "step_median_ms": step_ms, "flash_launches": launches, "wall_s": run["wall_s"]}


def build_native() -> dict:
    """Build both C extensions of the transport tier (``traceml_tpu_torch/
    native/``) from the checkout, strictly: a failed build, a failed load
    or ``TRACEML_NO_NATIVE`` fails the run, where the port would fall back
    to the Python twins."""
    from traceml_tpu_torch import native

    check(not native.disabled(), "TRACEML_NO_NATIVE is set: the C extensions would not be used")
    out = {}
    for name in native.SOURCES:
        t0 = time.perf_counter()
        try:
            path = native.build(name)
        except native.NativeBuildError as exc:
            raise CheckFailed(f"native {name}.c failed to build: {exc}") from exc
        out[name] = {"path": str(path.relative_to(REPO)), "build_s": time.perf_counter() - t0}
        log("build", f"native {name}.c -> {out[name]['path']} in {out[name]['build_s']:.3f} s")
    check(native.get_framing() is not None and native.get_ring() is not None,
          "a native extension built but did not load")
    return out


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
    build_native()
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
    torch.cuda.empty_cache()
    remat = remat_train_phase(cfg, train)
    kernel["launches"] = main_path["launches"] + train["launches"] + remat["launches"]
    kernel["launches_by_path"] = {"forward": main_path["launches"], "train": train["launches"],
                                  "remat_train": remat["launches"]}
    torch.cuda.empty_cache()
    log("time", f"train phases {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    forward_healthy = run_phase(main_path)
    train_runs = train_run_phase(cfg, train)
    train_healthy = train_runs["train_healthy"]
    kernel["launches"] += train_runs["train_healthy_2"]["flash_launches"]
    kernel["launches_by_path"]["train_baseline_run"] = train_runs["train_healthy_2"]["flash_launches"]
    t1 = time.perf_counter()
    baseline_compare_phase(train_runs)
    log("time", f"baseline compare checks {time.perf_counter() - t1:.2f} s")
    remat_run_phase(cfg, remat)
    killed_run_phase()
    log("time", f"run phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cli = cli_run_phase(cfg, train_healthy, forward_healthy)
    kernel["launches"] += cli["train"]["flash_launches"]
    kernel["launches_by_path"]["train_cli_run"] = cli["train"]["flash_launches"]
    log("time", f"cli run phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    engine_tick_phase(cli["session"])
    log("time", f"engine tick phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dashboard = dashboard_run_phase(cfg, train_healthy)
    kernel["launches"] += dashboard["flash_launches"]
    kernel["launches_by_path"]["train_dashboard_run"] = dashboard["flash_launches"]
    log("time", f"dashboard run phase {time.perf_counter() - t0:.2f} s")
    for transport, path in (("shm", "train_restart_run"), ("tcp", "train_restart_tcp_run")):
        t0 = time.perf_counter()
        restart = aggregator_restart_phase(cfg, train_healthy, transport)
        kernel["launches"] += restart["flash_launches"]
        kernel["launches_by_path"][path] = restart["flash_launches"]
        log("time", f"aggregator restart phase over {transport} {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    uds = transport_run_phase(cfg, train_healthy)
    kernel["launches"] += uds["flash_launches"]
    kernel["launches_by_path"]["train_uds_compressed_run"] = uds["flash_launches"]
    log("time", f"transport run phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    bounded = bounded_run_phase(cfg, train_healthy)
    kernel["launches"] += bounded["flash_launches"]
    kernel["launches_by_path"]["train_bounded_run"] = bounded["flash_launches"]
    log("time", f"bounded run phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    transport_phase(bounded)
    log("time", f"transport phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    coll = collectives_run_phase(cfg, train_healthy)
    kernel["launches"] += coll["flash_launches"]
    kernel["launches_by_path"]["train_collectives_run"] = coll["flash_launches"]
    comm_bound = comm_bound_run_phase(cfg)
    kernel["launches"] += comm_bound["flash_launches"]
    kernel["launches_by_path"]["train_comm_bound_run"] = comm_bound["flash_launches"]
    log("time", f"collectives run phase {time.perf_counter() - t0:.2f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
