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
   verdicts, and how fast the host ran beside each train run
   (``HostPace``: a fixed Python loop's ms every 0.5 s), since the host
   paces part of the train step's forward and a slower host moves the
   pair apart.  The second healthy run's launches have their own path,
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

15. The parallel layer (``seq_parallel_train_phase`` after the train
   phases, ``seq_parallel_run_phase`` after the run phase, beside the
   ``train_healthy`` run it is held to), over a one-rank NCCL group
   with ``make_mesh({fsdp: 1, context: 1})``.  In process, each route's
   AdamW step against its reference by ``train_compare_phase`` (the
   train gates, ``COMPARE_STEPS`` steps): ``attention_impl="ulysses"``
   against ``"dense"`` (both through the flash kernel: 12 launches a
   step), ``"ring"`` against the plain route (0 launches: its blocks are
   einsums), the FSDP2-sharded step against the unsharded one; each
   route's step ms, and what the Ulysses exchanges that a one-rank group
   skips would cost through NCCL (``ulysses_exchange_cost``).  The group
   is destroyed before the later phases.  Then ``train_seq_parallel``:
   ``run`` of ``train_script.py --mesh-shape fsdp=1,context=1
   --attention-impl ulysses --fsdp --ici-stats 10 --tokens``, held to
   the healthy train gates (FLOPs and tokens/s within 2%, 720 launches,
   NVML), the mesh in the database, 6 gathered (1, 12) stat matrices
   whose ``step_ms`` equal the stored rows' within f32 rounding, and the
   steady step at most ``SEQ_PARALLEL_STEP_REL`` x ``train_healthy``'s;
   reported: each gather's wait for the step's device work (the sync
   point) and the collective's ms.  Its launches have their own path on
   the kernels line.

16. Tensor, expert and pipeline parallelism (``parallel_workloads_phase``
   in a one-rank NCCL group of its own, then ``moe_pipeline_run_phase``,
   both last, after every gated ``run`` of the phases above).  In
   process: the full-width DecoderLM's AdamW step tensor-parallel on
   ``make_mesh({tensor: 1})`` (the column- and row-parallel layers, the
   hidden-sharded embedding and the vocabulary-gathered ``lm_head`` built,
   their collectives skipped at one rank) and with FSDP2 on ``{fsdp: 1,
   tensor: 1}``, each against the unsharded dense route by the train
   gates (``COMPARE_STEPS`` steps, 12 flash launches a step); the MoE
   block at the DecoderLM's widths (8 experts, hidden 1024, ffn 2816, x
   (8, 1024, 1024) f32) on ``{expert: 1}`` against the unsharded block,
   ``MOE_STEPS`` Adam steps (losses, aux losses and updates within
   ``PARALLEL_REL``; the loss falling); the pipeline on ``{stage: 1}``
   (``linear_stage_apply`` at width 1024, 4 microbatches of (8, 1024))
   against the sequential stack (the output within rtol 2e-4 / atol
   2e-5, the gradients and ``PIPELINE_STEPS`` SGD losses within
   ``PARALLEL_REL``).  Each route's step ms is logged, and the process's
   threads, their idle CPU, its affinity and its children before and
   after the phase (``process_state``; no process group, child or
   narrowed affinity may remain).  Then
   ``moe_pipeline``: ``run`` of ``dev/moe_pipeline_script.py``,
   ``MOE_PIPELINE_RUN_STEPS`` traced steps of each workload in one
   session: the manifest completed/ok, an OK step-time section, one
   stored row a step, each workload's loss falling, 0 flash launches, the
   HTML and transport gates; the MoE's rows on the device clock (the
   pipeline's few-ms host step gets a device marker every few steps, by
   the overhead governor's budget: reported).  The tensor routes'
   launches and the run's 0 have their own paths on the kernels line.
17. The second model family and the fault-scenario lab, last.
   ``vit_train_phase``: the ViT at ``ViTConfig()``'s widths (image 64,
   patch 8, hidden 256, 4 layers, 4 heads, ffn 1024, 10 classes: the
   widest ViT in the repo), bf16 compute, batch ``VIT_BATCH``,
   ``VIT_STEPS`` AdamW steps in process under ``init(mode="auto")``,
   ``wrap_step_fn`` and ``trace_step``: the loss falls, every row on the
   device clock, no ``compile`` phase (eager), 0 flash launches (its
   attention is the einsum reference, as in JAX); the step's device ms,
   peak bytes and parameter count are logged.  A compute straggler's
   span: a step function that sleeps 0.12 s after its work is enqueued
   (``dev/demo/scenarios.py``'s ``compute_straggler``) must read at least
   95% of it as compute on the device clock.  Then ``SCENARIO_RUNS`` in two
   waves (a run's wall is mostly its rank's set-up; one GPU
   time-slices the processes of runs at once, so the verdict most moved by
   them, ``vit_stress``'s INPUT_BOUND, runs in the first wave, beside the
   inductor ``recompile`` run alone, whose compiles stay in its rank):
   ``vit_stress`` with no fault (no fault kind) and with ``input_bound``
   (INPUT_BOUND) (``vit_stress_run_phase``), and the demo scenarios
   (``scenario_lab_phase``): ``healthy`` (no fault kind),
   ``input_bound`` (INPUT_BOUND), ``input_straggler`` on 4 ranks
   (INPUT_STRAGGLER on rank 3, four ranks seen), ``recompile`` under
   inductor (COMPILE_BOUND, at least 4 steps with ``compile`` events
   after the warm-up), ``checkpoint_stall`` (a ``checkpoint`` phase with
   a positive mean) and ``memory_creep`` (growth above 20 MiB), each by
   the precision harness's own detectors (``dev/precision_harness.py``),
   each with the HTML, transport and code-manifest gates of every
   ``run`` and 0 flash launches.
18. The Lightning and Ray integrations and the profile capture, last.
   ``lightning_callback_phase``: 30 full-width AdamW steps in process
   through the port's ``TraceMLCallback``, its hooks called in Lightning
   2.x's automatic-optimization order on a stand-in
   ``lightning.pytorch.Callback`` (Lightning is not installed; the log
   says so): every row on the device clock with one forward, backward and
   optimizer region, their sum within the step, 12 launches a step.
   ``ray_loop_phase``: ``traceml_train_loop`` on a stand-in ``ray`` whose
   actors live in this process: rank 0's aggregator actor, the endpoint,
   60 full-width steps (the summary's verdict needs 50), the actor
   finalized and killed; ``final_summary.json`` with 60 device-clock
   steps and the verdict of the MFU's band, 12 launches a step.  The
   bounded run (above) is also the profile capture's target: while it
   trains, ``python -m traceml_tpu_torch profile <session> --steps 5``
   must exit 0 with an ``ok`` response and a Chrome trace for rank 0
   whose CUDA kernel events hold the flash kernel 12 times a profiled
   step; the bounded run's own gates stay as they were.

Any failed check exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


def _full(t):
    """A DTensor's whole tensor (FSDP2's sharded parameters and
    gradients); any other tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t




def train_route(tokens, cfg, use_plain: bool, mesh=None, timed: bool = False) -> dict:
    """The full-width train step of one route from the seed's weights on
    ``tokens`` (``COMPARE_STEPS`` batches on the card): the first batch's
    gradients, the loss of each step, each parameter's update after them
    and the flash launches in the steps.  ``use_plain`` runs attention
    through ``flash_attention_plain`` on the card, differentiated by
    autograd; a ``mesh`` shards the parameters with FSDP2
    (``init_train_state(mesh=)``).  With ``timed``, the step is then timed
    (``cuda_ms``, 5 steps after 3 warm-ups)."""
    from contextlib import nullcontext

    from traceml_tpu_torch.dev.workload import build_train_state, cuda_ms
    from traceml_tpu_torch.models.transformer import loss_fn, make_train_step
    from traceml_tpu_torch.ops import attention as attention_mod
    from traceml_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    model, optimizer = build_train_state(cfg, SEED, mesh=mesh)
    start = {n: _full(p.detach()).clone() for n, p in model.named_parameters()}
    plain = mock.patch.object(attention_mod, "flash_attention", flash_attention_plain)
    with plain if use_plain else nullcontext():
        loss_fn(model, tokens[0]).backward()
        grads = {n: _full(p.grad) for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        step = make_train_step(model, optimizer)
        flash_attention.launches = 0
        out = {"losses": [step(t)["loss"].item() for t in tokens], "grads": grads,
               "launches": flash_attention.launches}
        out["updates"] = {n: _full(p.detach()) - start[n] for n, p in model.named_parameters()}
        if timed:  # after the updates are taken: these steps move the weights further
            out["step_ms"] = cuda_ms(lambda: step(tokens[0]), 5)
    return out


def compare_train_routes(tag: str, name_k: str, k: dict, name_p: str, p: dict) -> None:
    """Route ``name_k`` (``train_route``'s result ``k``) against
    ``name_p``: the first step's gradients, each step's loss and each
    parameter's update, by checks that scale with the output."""
    from traceml_tpu_torch.dev.attention_check import scaled_errors

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


def train_compare_phase(batches, routes, tag: str = "train") -> None:
    """The full-width train step through one route against another from
    the same weights on the same batches (``train_route``,
    ``compare_train_routes``).  ``routes`` is ``((name, cfg, plain),
    (name, cfg, plain))``, the route under test first."""
    tokens = [b.cuda() for b in batches[:COMPARE_STEPS]]
    (name_k, cfg_k, plain_k), (name_p, cfg_p, plain_p) = routes
    compare_train_routes(tag, name_k, train_route(tokens, cfg_k, plain_k), name_p,
                         train_route(tokens, cfg_p, plain_p))


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
               codec=None, join: str = None, argv_tail=None) -> dict:
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
    call's ``code_manifest.json`` is held to ``check_code_manifest``.
    ``argv_tail`` replaces the script's arguments (``--steps`` and
    ``--delay-ms`` of the ``dev/`` scripts) for a script that takes
    others (the scenario library)."""
    logs = RUN_DIR / (join or name)
    if join is None:
        shutil.rmtree(logs, ignore_errors=True)
    before = {p for p in logs.iterdir() if p.is_dir()} if logs.is_dir() else set()
    argv = [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", mode,
            "--logs-dir", str(logs), "--run-name", join or name, "--sampler-interval", repr(interval_s),
            *launcher_args, str(REPO / "traceml_tpu_torch" / "dev" / script),
            "--", *(argv_tail if argv_tail is not None
                    else ["--steps", str(steps), "--delay-ms", repr(delay_ms), *script_args])]
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    started_at, t0 = time.time(), time.perf_counter()
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
    got = {"summary": summary, "html": html_gate, "manifest": manifest, "code_manifest": code,
           "ingest": ingest, "transport": check_transport(name, session, ingest, transport, codec),
           "system_manifest": read("system_manifest.json", required=expect_ok),
           "rows": rows, "tables": tables, "stdout": out, "stderr": err, "wall_s": wall_s, "steps": steps,
           "mode": mode, "session": session, "interval_s": interval_s, "started_at": started_at}
    if rows:
        log("time", f"run {name}: " + json.dumps(run_timeline(got)))
    return got


def flash_launches(name: str, run: dict) -> int:
    """The flash kernel's launches in a ``run``: the sum of the
    ``flash_attention.launches N`` lines its ranks printed, one or more."""
    counts = [int(v) for v in re.findall(r"^flash_attention\.launches (\d+)$", run["stdout"], re.MULTILINE)]
    check(bool(counts), f"run {name}: no flash_attention.launches line")
    return sum(counts)


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
    got["full_gc_in_loop"] = int(words[-1]) if "collections in the loop" in loss_lines[-1] else None
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


HOST_PACE_EVERY_S = 0.5
HOST_PACE_LOOP = 20000  # additions a sample: about a millisecond of one core


class HostPace:
    """How fast the host ran beside a ``run``: a thread of this process
    times a fixed pure-Python loop every ``HOST_PACE_EVERY_S`` s.  Read
    only, gates nothing: it says whether two runs that differ saw the same
    host.  (The card's machine counts no idle time in ``/proc/stat``, so
    the cores' busy and stolen shares cannot be read there.)"""

    def __init__(self) -> None:
        self.samples = []
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._sample, name="host-pace", daemon=True)

    def _sample(self) -> None:
        while not self.done.wait(HOST_PACE_EVERY_S):
            t0 = time.perf_counter()
            total = 0
            for i in range(HOST_PACE_LOOP):
                total += i
            self.samples.append((time.perf_counter() - t0) * 1e3)

    def __enter__(self) -> "HostPace":
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.done.set()
        self.thread.join()

    def result(self) -> dict:
        return {"loop_ms": spread(self.samples) if self.samples else None, "samples": len(self.samples)}


def train_run_phase(cfg, train: dict) -> dict:
    """``python -m traceml_tpu_torch run`` of ``dev/train_script.py``:
    healthy with a 0.1 s sender tick, healthy again (``train_healthy_2``)
    and with a host input delay of 3x the in-process train step at the
    default tick, the three under one logs dir and run name (the healthy
    run's), so that the baseline store judges the second against the
    first and the delayed one against both.  Each is held to
    ``check_train_run``, with the verdict of the MFU's band (healthy) or
    INPUT_BOUND; the healthy runs' NVML utilization at least
    ``UTIL_HEALTHY_MIN_PCT``.  Each run's ``host`` is what ``HostPace``
    read beside it.  Returns each run's numbers by name."""
    delay_ms = 3.0 * train["step_ms"]
    runs = {}
    for name, delay, interval_s, verdict, join in (
            ("train_healthy", 0.0, 0.1, mfu_verdict, None),
            ("train_healthy_2", 0.0, 0.1, mfu_verdict, "train_healthy"),
            ("train_input_delay", delay_ms, 1.0, "INPUT_BOUND", "train_healthy")):
        log("run", f"{name}: input delay {delay:.3f} ms")
        with HostPace() as pace:
            run = launch_run(name, delay, interval_s, script="train_script.py", join=join)
        got = check_train_run(name, run, cfg, verdict)
        got["host"] = pace.result()
        log("run", f"{name}: the host beside the run {json.dumps(got['host'])}")
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
    hosts = {name: runs[name]["host"] for name in ("train_healthy", "train_healthy_2")}
    check(p["verdict"] not in COMPARE_BLOCKING and not step_findings,
          f"compare healthy vs healthy_2: {p['verdict']}, step-time findings {step_findings}; "
          f"the host beside each run {json.dumps(hosts)}")
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
    metrics = ((p.get("sections") or {}).get("step_time") or {}).get("metrics") or {}
    out["compare"] = {
        "healthy_vs_healthy_2": {"verdict": p["verdict"], "step_delta_rel": p["step_delta_rel"],
                                 "phase_shares": {k[len("share."):]: [m.get("baseline"), m.get("candidate")]
                                                  for k, m in metrics.items() if k.startswith("share.")},
                                 "findings": [f["kind"] for f in p["findings"]], "wall_s": same["wall_s"],
                                 "host": hosts},
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
PROFILE_STEPS = 5  # the steps `profile` asks the bounded run to trace
PROFILE_TIMEOUT_S = 120


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


class ProbeGroup:
    """Several probes beside one ``launch_run`` call, each on its own
    thread, ended together (``launch_run`` takes one probe)."""

    def __init__(self, *probes) -> None:
        self.probes = probes
        self.done = threading.Event()
        self.run_ended_at = None

    def run(self, logs: Path) -> None:
        threads = [threading.Thread(target=p.run, args=(logs,), daemon=True) for p in self.probes]
        for t in threads:
            t.start()
        self.done.wait()
        for p in self.probes:
            p.run_ended_at = self.run_ended_at
            p.done.set()
        for t in threads:
            t.join(timeout=60)


class ProfileProbe:
    """``python -m traceml_tpu_torch profile <session> --steps
    PROFILE_STEPS`` against a ``run`` while it trains, from a thread
    beside ``launch_run``: it waits for the session's dir, then calls the
    command as a user would (it writes the request and waits for the
    response).  It keeps the command's exit code, output and wall time;
    ``check_profile_capture`` gates them."""

    def __init__(self) -> None:
        self.done = threading.Event()
        self.run_ended_at = None
        self.error = None
        self.result = None

    def run(self, logs: Path) -> None:
        try:
            deadline = time.monotonic() + 120
            session = None
            while session is None and time.monotonic() < deadline and not self.done.is_set():
                found = [p for p in logs.glob("*/manifest.json")]
                session = found[0].parent if found else None
                if session is None:
                    time.sleep(0.2)
            check(session is not None, "profile probe: no session dir appeared")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "traceml_tpu_torch", "profile", str(session), "--steps", str(PROFILE_STEPS),
                 "--timeout", str(PROFILE_TIMEOUT_S)],
                cwd=REPO, capture_output=True, text=True, timeout=PROFILE_TIMEOUT_S + 60,
                env=dict(os.environ, PYTHONPATH=str(REPO)))
            self.result = {"session": session, "rc": proc.returncode, "stdout": proc.stdout,
                           "stderr": proc.stderr, "wall_s": time.perf_counter() - t0}
        except Exception as exc:
            self.error = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))


def check_profile_capture(name: str, probe: ProfileProbe, layers: int) -> dict:
    """The ``profile`` command's gates: exit 0 with "trace captured", an
    ``ok`` response of ``PROFILE_STEPS`` steps, not truncated, from rank 0,
    and one Chrome trace for the run's one rank whose CUDA kernel events
    hold the flash kernel ``layers`` times a profiled step.  Reported: the
    command's wall time, the profiled steps' kernel time a step, the
    trace's size and its kernels a step."""
    check(probe.error is None, f"run {name}: the profile probe failed: {probe.error}")
    got = probe.result
    check(got is not None, f"run {name}: the profile command did not run")
    check(got["rc"] == 0 and "trace captured" in got["stdout"],
          f"run {name}: profile exited {got['rc']}: {got['stdout'][-500:]} {got['stderr'][-1500:]}")
    resp = json.loads((got["session"] / "control" / "profile_response.json").read_text())
    check(resp["ok"] and resp["steps"] == PROFILE_STEPS and not resp["truncated"] and resp["rank"] == 0,
          f"run {name}: profile response {resp}")
    traces = sorted(Path(resp["trace_dir"]).glob("rank_*/trace.json"))
    check([t.parent.name for t in traces] == ["rank_0"], f"run {name}: traces {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    flash = [e for e in kernels if "flash_fwd" in e.get("name", "")]
    check(len(flash) == layers * PROFILE_STEPS,
          f"run {name}: the trace holds {len(flash)} flash kernel events, not {layers} x {PROFILE_STEPS}")
    out = {"wall_s": got["wall_s"], "steps": resp["steps"], "trace_bytes": traces[0].stat().st_size,
           "kernels_per_step": len(kernels) / PROFILE_STEPS, "flash_per_step": len(flash) / PROFILE_STEPS,
           "kernel_ms_per_step": sum(e.get("dur", 0.0) for e in kernels) / 1e3 / PROFILE_STEPS,
           "flash_ms_mean": statistics.fmean(e["dur"] for e in flash) / 1e3,
           "trace_dir": resp["trace_dir"]}
    log("profile", f"{name}: " + json.dumps(out))
    return out


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
    probe, profile = IngestProbe(), ProfileProbe()
    run = launch_run(name, 0.0, interval, script="train_script.py", steps=BOUNDED_STEPS, mode="cli",
                     script_args=("--stderr-marker",), probe=ProbeGroup(probe, profile),
                     launcher_args=("--trace-max-steps", str(BOUNDED_CAP), "--summary-window-rows",
                                    str(BOUNDED_WINDOW), "--disk-backup", "--no-capture-stderr"))
    check(probe.error is None, f"run {name}: the ingest probe failed: {probe.error}")
    capture = check_profile_capture(name, profile, cfg.n_layers)
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
        "session": str(session), "profile_capture": capture,
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


SEQ_PARALLEL_MESH = {"fsdp": 1, "context": 1}  # one H100: both axes of size 1, every sharded code path taken
SEQ_PARALLEL_STEP_REL = 1.10  # the sharded run's steady step against train_healthy's
STAT_GATHER_EVERY = 10  # --ici-stats N: 6 gathers in the 60-step run


@contextlib.contextmanager
def one_rank_nccl_group():
    """A one-rank NCCL process group in this process (``_dist_env``'s
    rendezvous), destroyed on exit with the mesh ``make_mesh`` recorded,
    so the phases after it run as before."""
    import torch.distributed as dist

    from traceml_tpu_torch.utils.topology import reset_recorded_mesh_for_tests

    env = _dist_env()
    with mock.patch.dict(os.environ, env):
        dist.init_process_group("nccl", init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()
            reset_recorded_mesh_for_tests()


def process_state(idle_s: float = 1.0) -> dict:
    """This process as ``/proc`` shows it: its OS threads by name (Python's
    and the libraries' own), the cores they use over ``idle_s`` seconds
    idle by name, its CPU affinity and a fresh child's (which inherits
    it), its live child processes, and whether a process group is live.
    What an in-process phase leaves behind shows here: a thread that
    spins, a narrowed affinity the ``run`` children inherit, a process
    that outlives its phase."""
    import collections

    import torch.distributed as dist

    def ticks() -> dict:
        out = {}
        for tid in os.listdir("/proc/self/task"):
            try:
                raw = Path(f"/proc/self/task/{tid}/stat").read_text()
            except OSError:  # the thread ended
                continue
            fields = raw[raw.rindex(")") + 2:].split()
            out[tid] = (raw[raw.index("(") + 1:raw.rindex(")")], int(fields[11]) + int(fields[12]))
        return out

    before, t0 = ticks(), time.perf_counter()
    time.sleep(idle_s)
    after, wall = ticks(), time.perf_counter() - t0
    hz = os.sysconf("SC_CLK_TCK")
    busy: dict = collections.Counter()
    for tid, (name, t) in after.items():
        if tid in before and t > before[tid][1]:
            busy[name] += (t - before[tid][1]) / hz / wall
    children = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            raw = Path(f"/proc/{pid}/stat").read_text()
        except OSError:
            continue
        if int(raw[raw.rindex(")") + 2:].split()[1]) == os.getpid():
            children.append(f"{pid} {raw[raw.index('(') + 1:raw.rindex(')')]}")
    child = subprocess.run([sys.executable, "-c", "import os; print(len(os.sched_getaffinity(0)))"],
                           capture_output=True, text=True, timeout=60)
    return {"threads": len(after), "by_name": dict(collections.Counter(n for n, _ in after.values())),
            "busy_cores": {n: round(v, 4) for n, v in busy.items()}, "affinity": len(os.sched_getaffinity(0)),
            "child_affinity": int(child.stdout.strip()), "children": children,
            "process_group": dist.is_available() and dist.is_initialized()}


def seq_parallel_train_phase(cfg) -> dict:
    """The sharded train step in process, in a one-rank NCCL group with
    ``make_mesh(SEQ_PARALLEL_MESH)``, each route against its reference
    (``train_route``, ``compare_train_routes``: ``COMPARE_STEPS`` AdamW
    steps, the train gates): ``attention_impl="ulysses"`` (the flash
    kernel after the head scatter) against ``"dense"`` (the kernel
    route); ``"ring"`` (einsum blocks, no kernel) against the plain route;
    the FSDP2-sharded step (``init_train_state(mesh=)``) against the
    unsharded dense one.  Flash launches in each route's steps: 12 a step
    under Ulysses, dense and FSDP2, 0 under ring and plain.  Reported: each route's step ms, and what the
    Ulysses exchanges it skips at one rank would cost
    (``ulysses_exchange_cost``)."""
    from traceml_tpu_torch.dev.measure_seq_parallel import ulysses_exchange_cost
    from traceml_tpu_torch.dev.workload import TRAIN_TOKENS, host_batches
    from traceml_tpu_torch.parallel.mesh import make_mesh

    tokens = [b.cuda() for b in host_batches(cfg, SEED + 1, seq=TRAIN_TOKENS)[:COMPARE_STEPS]]
    with one_rank_nccl_group():
        mesh = make_mesh(SEQ_PARALLEL_MESH, device_type="cuda")

        def sp(impl):
            return dataclasses.replace(cfg, attention_impl=impl, context_axis="context", mesh=mesh)

        routes = {"dense": train_route(tokens, cfg, False, timed=True)}
        routes["ulysses"] = train_route(tokens, sp("ulysses"), False, timed=True)
        compare_train_routes("ulysses", "ulysses", routes["ulysses"], "dense", routes["dense"])
        routes["ring"] = train_route(tokens, sp("ring"), False, timed=True)
        routes["plain"] = train_route(tokens, cfg, True)
        compare_train_routes("ring", "ring", routes["ring"], "plain", routes["plain"])
        routes["fsdp"] = train_route(tokens, cfg, False, mesh=mesh, timed=True)
        compare_train_routes("fsdp", "fsdp", routes["fsdp"], "unsharded", routes["dense"])
        exchange = ulysses_exchange_cost(mesh)
    per_step = {route: r["launches"] / COMPARE_STEPS for route, r in routes.items()}
    log("seq_parallel", "flash launches a step " + json.dumps(per_step) + "; step ms "
        + json.dumps({route: r["step_ms"] for route, r in routes.items() if "step_ms" in r})
        + "; the Ulysses exchange through NCCL at one rank (skipped on the path) " + json.dumps(exchange))
    want = {"dense": cfg.n_layers, "ulysses": cfg.n_layers, "ring": 0, "plain": 0, "fsdp": cfg.n_layers}
    check(per_step == want, f"flash launches a step {per_step}, not {want}")
    return {"step_ms": {route: r.get("step_ms") for route, r in routes.items()}, "exchange": exchange}


#: the MoE block at the full-width DecoderLM's widths, as dev/moe_pipeline_script.py's default
MOE_EXPERTS, MOE_HIDDEN, MOE_FFN, MOE_X = 8, 1024, 2816, (8, 1024, 1024)
MOE_STEPS = 3  # Adam steps held expert-sharded route against unsharded block
PIPELINE_WIDTH, PIPELINE_MICRO = 1024, (4, 8, 1024)  # linear stages; 4 microbatches of (8, 1024)
PIPELINE_STEPS = 3  # SGD steps held pipelined route against the sequential stack
PIPELINE_HOST_STEPS = 50  # steps timed on the host clock, one sync after them
# one rank of each axis: the routes run the same f32 ops as their
# references (the collectives are skipped), so only the launch order of
# equal work could move a bit; the sequential-stack bounds are the JAX test's
PARALLEL_REL = 1e-5
PIPELINE_RTOL, PIPELINE_ATOL = 2e-4, 2e-5
MOE_PIPELINE_RUN_STEPS = 30  # each workload's steps under run


def _moe_route(mesh, x, y) -> dict:
    """``MOE_STEPS`` Adam steps of the MoE block from ``moe_state_dict(SEED)``:
    placed by ``init_expert_parallel`` over ``mesh``, or built unsharded
    when ``mesh`` is None.  The losses and aux losses, each parameter's
    update and the step's device ms (``cuda_ms``, after the updates)."""
    from traceml_tpu_torch.dev.workload import cuda_ms
    from traceml_tpu_torch.models.moe import MoEBlock, init_expert_parallel, make_moe_train_step, moe_state_dict

    whole = {n: t.cuda() for n, t in moe_state_dict(MOE_EXPERTS, MOE_HIDDEN, MOE_FFN, SEED).items()}
    if mesh is None:
        block = MoEBlock(MOE_EXPERTS, MOE_HIDDEN, MOE_FFN)
        block.load_state_dict(whole)
    else:
        block = init_expert_parallel(MOE_EXPERTS, MOE_HIDDEN, MOE_FFN, mesh, state_dict=whole)["model"]
    _, step = make_moe_train_step(block)
    metrics = [step(x, y) for _ in range(MOE_STEPS)]
    out = {"losses": [m["loss"].item() for m in metrics], "aux": [m["aux"].item() for m in metrics],
           "updates": {n: _full(p.detach()) - whole[n] for n, p in block.named_parameters()}}
    out["step_ms"] = cuda_ms(lambda: step(x, y), 5)
    return out


def _pipeline_route(mesh, x, y) -> dict:
    """The pipelined forward of one ``linear_stage_apply`` stage
    (``init_linear_stages(1, PIPELINE_WIDTH, SEED)``) over ``mesh`` on the
    microbatches ``x``, its gradients, ``PIPELINE_STEPS`` SGD steps' losses
    and the step's ms: ``cuda_ms`` of 5 steps (the host queues them behind
    the card's spin; a step whose host work outlasts it reads more than
    the card's) and on the host clock over ``PIPELINE_HOST_STEPS`` steps;
    with ``mesh`` None the same through the sequential stack (the stage
    applied to each microbatch)."""
    from traceml_tpu_torch.dev.workload import cuda_ms
    from traceml_tpu_torch.parallel.pipeline import (init_linear_stages, linear_stage_apply, make_pipeline_fn,
                                                     make_pipeline_train_step, shard_stage_params,
                                                     stack_stage_params)

    stacked = stack_stage_params(init_linear_stages(1, PIPELINE_WIDTH, SEED))
    if mesh is None:
        params = {n: torch.nn.Parameter(t.clone()) for n, t in stacked.items()}

        def forward(p, micro):
            return linear_stage_apply({n: t[0] for n, t in p.items()}, micro)

        optimizer = torch.optim.SGD(list(params.values()), lr=0.05)

        def step(p, opt, micro, target):
            loss = ((forward(p, micro) - target) ** 2).mean()
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            return {"loss": loss.detach()}
    else:
        params = shard_stage_params(stacked, mesh)
        forward = make_pipeline_fn(linear_stage_apply, mesh, x.shape[0])
        init, step = make_pipeline_train_step(linear_stage_apply, mesh, x.shape[0], learning_rate=0.05)
        optimizer = init(params)
    out = forward(params, x)
    ((out - y) ** 2).mean().backward()
    grads = {n: _full(p.grad).clone() for n, p in params.items()}
    for p in params.values():
        p.grad = None
    losses = [step(params, optimizer, x, y)["loss"].item() for _ in range(PIPELINE_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PIPELINE_HOST_STEPS):
        step(params, optimizer, x, y)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / PIPELINE_HOST_STEPS * 1e3
    return {"out": out.detach(), "grads": grads, "losses": losses, "host_ms": host_ms,
            "step_ms": cuda_ms(lambda: step(params, optimizer, x, y), 5)}


def parallel_workloads_phase(cfg) -> dict:
    """Tensor, expert and pipeline parallelism in process, in a one-rank
    NCCL group (``one_rank_nccl_group``): the full-width DecoderLM's AdamW
    step (``COMPARE_STEPS`` steps) tensor-parallel on
    ``make_mesh({"tensor": 1})`` and with FSDP2 on ``{"fsdp": 1, "tensor":
    1}`` against the unsharded dense route (``compare_train_routes``, the
    train gates; 12 flash launches a step);
    the MoE block at the DecoderLM's widths (``MOE_EXPERTS`` experts,
    hidden 1024, ffn 2816, x (8, 1024, 1024) f32) on ``{"expert": 1}``
    against the unsharded block, ``MOE_STEPS`` Adam steps (the losses and
    aux losses within ``PARALLEL_REL`` relative, each parameter's update
    within ``PARALLEL_REL`` relative Frobenius); the pipeline on
    ``{"stage": 1}`` with ``linear_stage_apply`` at width 1024 and 4
    microbatches of (8, 1024) against the sequential stack (the output
    within the JAX test's rtol 2e-4 / atol 2e-5, the gradients and
    ``PIPELINE_STEPS`` SGD losses within ``PARALLEL_REL``).  Logs each
    route's step ms (the pipeline's on the host clock too) and this
    process before and after the phase (``process_state``), which must
    leave no process group, no child process and the CPU affinity as it
    was; returns the tensor routes' flash launches."""
    from traceml_tpu_torch.dev.workload import TRAIN_TOKENS, host_batches

    before = process_state()
    tokens = [b.cuda() for b in host_batches(cfg, SEED + 1, seq=TRAIN_TOKENS)[:COMPARE_STEPS]]
    with one_rank_nccl_group():
        out = _parallel_workloads(cfg, tokens, train_route(tokens, cfg, False, timed=True))
    torch.cuda.empty_cache()
    after = process_state()
    log("parallel", "this process before the phase " + json.dumps(before) + "; after " + json.dumps(after))
    check(not after["process_group"] and after["children"] == before["children"]
          and after["affinity"] == after["child_affinity"] == before["affinity"],
          f"the phase left a process group, a child process or a narrowed affinity: {before} -> {after}")
    return out


def _parallel_workloads(cfg, tokens, dense: dict) -> dict:
    from traceml_tpu_torch.parallel.mesh import make_mesh

    tensor_mesh = make_mesh({"tensor": 1}, device_type="cuda")
    routes = {"tensor": train_route(tokens, dataclasses.replace(cfg, mesh=tensor_mesh), False, timed=True)}
    compare_train_routes("tensor", "tensor", routes["tensor"], "dense", dense)
    fsdp_mesh = make_mesh({"fsdp": 1, "tensor": 1}, device_type="cuda")
    routes["tensor_fsdp"] = train_route(tokens, dataclasses.replace(cfg, mesh=fsdp_mesh), False, mesh=fsdp_mesh,
                                        timed=True)
    compare_train_routes("tensor_fsdp", "tensor_fsdp", routes["tensor_fsdp"], "dense", dense)
    per_step = {name: r["launches"] / COMPARE_STEPS for name, r in routes.items()}
    log("parallel", "tensor: flash launches a step " + json.dumps(per_step) + "; step ms "
        + json.dumps({**{name: r["step_ms"] for name, r in routes.items()}, "dense": dense["step_ms"]}))
    check(per_step == {"tensor": cfg.n_layers, "tensor_fsdp": cfg.n_layers},
          f"flash launches a step {per_step}, not {cfg.n_layers}")
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(SEED + 3)
    x = torch.randn(MOE_X, generator=gen).cuda()
    y = torch.roll(x, 1, dims=-1)
    moe = {"expert": _moe_route(make_mesh({"expert": 1}, device_type="cuda"), x, y), "unsharded": _moe_route(None, x, y)}
    e, u = moe["expert"], moe["unsharded"]
    moe_rel = {"loss": max(abs(a - b) / abs(b) for a, b in zip(e["losses"], u["losses"])),
               "aux": max(abs(a - b) / abs(b) for a, b in zip(e["aux"], u["aux"])),
               "update": max((e["updates"][n] - u["updates"][n]).norm().item() / u["updates"][n].norm().item()
                             for n in u["updates"])}
    moe_flops = 3 * 2 * 2 * math.prod(MOE_X[:2]) * MOE_HIDDEN * MOE_FFN * MOE_EXPERTS  # fwd + bwd einsums
    log("parallel", "moe " + json.dumps({"losses": e["losses"], "aux": e["aux"], "rel": moe_rel, "tol": PARALLEL_REL,
                                         "step_ms": {k: r["step_ms"] for k, r in moe.items()},
                                         "expert_tflops": moe_flops / (e["step_ms"] / 1e3) / 1e12}))
    check(all(math.isfinite(v) for v in e["losses"]) and e["losses"][-1] < e["losses"][0],
          f"MoE losses {e['losses']} not finite and falling")
    check(all(v <= PARALLEL_REL for v in moe_rel.values()), f"MoE expert route vs unsharded: {moe_rel}")
    del moe, e, u, x, y
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(SEED + 4)
    micro = torch.randn(PIPELINE_MICRO, generator=gen).cuda()
    target = 0.5 * micro
    pp = {"stage": _pipeline_route(make_mesh({"stage": 1}, device_type="cuda"), micro, target),
          "sequential": _pipeline_route(None, micro, target)}
    s_, q = pp["stage"], pp["sequential"]
    out_ok = torch.allclose(s_["out"], q["out"], rtol=PIPELINE_RTOL, atol=PIPELINE_ATOL)
    pp_rel = {"grad": max((s_["grads"][n] - q["grads"][n]).norm().item() / q["grads"][n].norm().item()
                          for n in q["grads"] if q["grads"][n].norm().item() > 0),
              "loss": max(abs(a - b) / abs(b) for a, b in zip(s_["losses"], q["losses"]))}
    log("parallel", "pipeline " + json.dumps({"out_allclose": out_ok, "rel": pp_rel, "losses": s_["losses"],
                                              "step_ms": {k: r["step_ms"] for k, r in pp.items()},
                                              "host_ms": {k: r["host_ms"] for k, r in pp.items()}}))
    check(out_ok, "pipeline output vs the sequential stack: not allclose")
    check(all(v <= PARALLEL_REL for v in pp_rel.values()), f"pipeline vs the sequential stack: {pp_rel}")
    return {"launches": {name: r["launches"] for name, r in routes.items()}}


def seq_parallel_run_phase(cfg, train_healthy: dict) -> dict:
    """``train_seq_parallel``: ``run`` of ``train_script.py`` at full width
    in a one-rank NCCL group with ``--mesh-shape fsdp=1,context=1
    --attention-impl ulysses --fsdp --ici-stats 10``: Ulysses attention
    over the context axis (the flash kernel after the head scatter), the
    parameters and AdamW's state sharded by FSDP2, the stat all-gather
    every 10 steps.  Gates: the healthy train run's (device clock, the
    MFU's band, FLOPs and tokens, 12 x 60 launches, NVML); the mesh in the
    database; 6 gathered matrices of shape (1, 12) whose rows' ``step_ms``
    equal the stored rows' of the same steps within f32 rounding; the
    steady step at most ``SEQ_PARALLEL_STEP_REL`` x ``train_healthy``'s.
    Reported: the host ms each gather waited for the step's device work
    and the ms of the collective with its copy (the sync point)."""
    from traceml_tpu_torch.utils import timing as T

    name = "train_seq_parallel"
    log("run", f"{name}: this process before the run " + json.dumps(process_state()))
    run = launch_run(name, 0.0, 0.1, script="train_script.py", env_extra=_dist_env(), script_args=(
        "--mesh-shape", ",".join(f"{k}={v}" for k, v in SEQ_PARALLEL_MESH.items()), "--attention-impl", "ulysses",
        "--fsdp", "--ici-stats", str(STAT_GATHER_EVERY), "--tokens"))
    got = check_train_run(name, run, cfg, mfu_verdict)
    check_healthy_utilization(name, got)
    eff = got["efficiency"] or {}
    tokens = eff.get("tokens_per_sec_median")
    want_tokens = BATCH * SEQ / (got["steady_state_ms"] / 1e3)
    check(eff.get("tokens_per_step") == BATCH * SEQ and tokens is not None
          and abs(tokens - want_tokens) / want_tokens <= FLOPS_REL_TOL,
          f"run {name}: tokens_per_step {eff.get('tokens_per_step')}, tokens/s {tokens} vs {want_tokens}")
    mesh = check_mesh(name, run)
    lines = [l for l in run["stdout"].splitlines() if l.startswith("stat_gather ")]
    check(len(lines) == 1, f"run {name}: {len(lines)} stat_gather lines")
    stat = json.loads(lines[0].split(" ", 1)[1])
    stored = {step: json.loads(ev)[T.STEP_TIME]["device_ms"] for step, _, ev in run["rows"]}
    gathered = {step: ms for r, step, ms in stat["rows"] if r == 0}
    steps = list(range(STAT_GATHER_EVERY, run["steps"] + 1, STAT_GATHER_EVERY))
    check(stat["gathers"] == len(steps) and stat["shape"] == [1, 12] and sorted(gathered) == steps
          and len(stat["rows"]) == len(steps), f"run {name}: stat gathers {stat}")
    off = {step: (gathered[step], stored[step]) for step in steps
           if not math.isclose(gathered[step], stored[step], rel_tol=2.0 ** -23)}
    check(not off, f"run {name}: gathered step_ms vs the stored rows' (gathered, stored): {off}")
    ratio = got["steady_state_ms"] / train_healthy["steady_state_ms"]
    numbers = {"wait_ms": spread(stat["wait_ms"]), "gather_ms": spread(stat["gather_ms"]),
               "gathered_step_ms": [gathered[s] for s in steps], "diagnosis": stat["diagnosis"]}
    log("run", f"{name}: steady step {got['steady_state_ms']:.4f} ms vs train_healthy "
               f"{train_healthy['steady_state_ms']:.4f} ms: {ratio:.4f}x (gate {SEQ_PARALLEL_STEP_REL}x); "
               f"stat gathers {json.dumps(numbers)}; tokens/s {tokens}; mesh {json.dumps(mesh)}")
    check(ratio <= SEQ_PARALLEL_STEP_REL, f"run {name}: steady step {ratio:.4f}x train_healthy's")
    return {**got, "step_ratio": ratio, "stat_gather": numbers}


def moe_pipeline_run_phase() -> dict:
    """``moe_pipeline``: ``run`` of ``dev/moe_pipeline_script.py`` in a
    one-rank NCCL group: ``MOE_PIPELINE_RUN_STEPS`` traced steps of the
    MoE block on ``{"expert": 1}`` at the DecoderLM's widths (steps 1 to
    N), then as many of the pipeline on ``{"stage": 1}`` (N + 1 to 2N).
    Gates: exit 0, the manifest completed/ok, ``final_summary.json`` with
    an OK step-time section, one stored row a step for both workloads,
    each workload's losses finite and falling, 0 flash launches (no kernel
    of the port's is on these paths), the HTML and transport gates of
    every ``run``; the MoE's rows all on the device clock (its step is
    paced by the card).  The pipeline's step is a few ms of host work, so
    the overhead governor records a device marker every few steps only
    (its budget, ``utils/overhead_governor.py``): its device-clock rows
    are reported, not gated.  Reported: each workload's device step from
    the stored rows, its loop and set-up seconds and the call's wall
    time."""
    from traceml_tpu_torch.utils import timing as T

    name, n = "moe_pipeline", MOE_PIPELINE_RUN_STEPS
    run = launch_run(name, 0.0, 0.1, script="moe_pipeline_script.py", steps=n, env_extra=_dist_env())
    summary, manifest = run["summary"], run["manifest"]
    check((manifest["status"], manifest["telemetry_status"]) == ("completed", "ok"),
          f"run {name}: manifest {manifest['status']}/{manifest['telemetry_status']}")
    st = summary["sections"]["step_time"]
    check(st["status"] == "OK", f"run {name}: step_time section {st['status']}")
    steps = [r[0] for r in run["rows"]]
    check(steps == list(range(1, 2 * n + 1)), f"run {name}: stored steps {steps[:3]}..., {len(steps)} rows")
    launches = flash_launches(name, run)
    check(launches == 0, f"run {name}: {launches} flash launches, not 0")
    out = {"clock": st["global"]["clock"], "verdict": summary["primary_diagnosis"]["kind"], "wall_s": run["wall_s"]}
    for i, workload in enumerate(("moe", "pipeline")):
        rows = run["rows"][i * n:(i + 1) * n]
        device = [json.loads(r[2])[T.STEP_TIME]["device_ms"] for r in rows]
        on_device = [v for r, v in zip(rows, device) if r[1] == "device" and v is not None]
        if workload == "moe":
            check(len(on_device) == n, f"run {name}: {n - len(on_device)} MoE step rows not on the device clock")
        lines = re.findall(rf"moe_pipeline_script: {workload} over 1 rank\(s\): {n} steps in ([0-9.]+) s wall "
                           r"\(set-up ([0-9.]+) s\); loss first ([0-9.eE+-]+) last ([0-9.eE+-]+) finite=True",
                           run["stdout"])
        check(len(lines) == 1 and float(lines[0][3]) < float(lines[0][2]),
              f"run {name}: {workload} losses {lines} not finite and falling")
        out[workload] = {"loop_s": float(lines[0][0]), "setup_s": float(lines[0][1]),
                         "loss_first_last": [float(v) for v in lines[0][2:]], "device_rows": len(on_device),
                         "step_device_ms": spread(on_device) if on_device else None}
    log("run", f"{name}: {json.dumps(out)}")
    return {**out, "flash_launches": launches}


VIT_BATCH = 256
VIT_STEPS = 30
VIT_LR = 1e-3
STRAGGLER_SLEEP_S = 0.12  # dev/demo/scenarios.py's compute_straggler
# the share of the sleep the device-clock compute must read: the CUDA
# event's stamp maps onto the host clock within about a millisecond
# (119.1 ms seen for the 120 ms sleep); a region that ended before the
# sleep would read its few ms of kernels
STRAGGLER_SPAN_MIN = 0.95
STRAGGLER_STEPS = 8
#: (name, script under dev/, its arguments, ranks): every run at once
SCENARIO_RUNS = (
    ("vit_stress_none", "scenarios/vit_stress.py", ["60", "none"], 1),
    ("vit_stress_input_bound", "scenarios/vit_stress.py", ["60", "input_bound"], 1),
    ("scenario_healthy", "demo/scenarios.py", ["healthy", "60"], 1),
    ("scenario_input_bound", "demo/scenarios.py", ["input_bound", "60"], 1),
    ("scenario_input_straggler", "demo/scenarios.py", ["input_straggler", "60"], 4),
    ("scenario_recompile", "demo/scenarios.py", ["recompile", "60"], 1),
    ("scenario_checkpoint_stall", "demo/scenarios.py", ["checkpoint_stall", "40"], 1),
    ("scenario_memory_creep", "demo/scenarios.py", ["memory_creep", "80"], 1),
)
RECOMPILE_MIN_STEPS = 4  # steps with compile events after the warm-up
#: inductor compiles in the rank itself, not in a pool of one worker
#: process a core that would load every core beside the other runs
SCENARIO_ENV = {"scenario_recompile": {"TORCHINDUCTOR_COMPILE_THREADS": "1"}}
#: the device-clock verdicts most moved by other processes on the card
#: (one GPU time-slices its processes): they run first, beside the
#: recompile run's compiles alone
SCENARIO_FIRST = ("vit_stress_none", "vit_stress_input_bound", "scenario_recompile")


def vit_train_phase() -> dict:
    """``VIT_STEPS`` traced AdamW steps of the ViT at ``ViTConfig()``'s
    widths in process (``make_vit_train_step`` under ``wrap_step_fn``),
    on ``VIT_BATCH`` random images over 4 batches, cycled, so the loss can
    fall.  Gates: the loss falls, every row on the device clock with a
    positive step time, no ``compile`` phase, 0 flash launches."""
    import numpy as np

    import traceml_tpu_torch as tm
    from traceml_tpu_torch.models.vit import ViT, ViTConfig, make_vit_train_step
    from traceml_tpu_torch.sdk.initial import shutdown_patches
    from traceml_tpu_torch.utils import timing as T

    cfg = ViTConfig()
    shutdown_patches()
    tm.init(mode="auto")
    model = ViT(cfg)
    init, train_step = make_vit_train_step(model, learning_rate=VIT_LR)
    init(SEED)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED + 3)
    batches = [(torch.from_numpy(rng.normal(size=(VIT_BATCH, cfg.image_size, cfg.image_size, 3)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, cfg.n_classes, VIT_BATCH))) for _ in range(4)]
    step = tm.wrap_step_fn(lambda batch: train_step(*batch))
    run = traced_loop(step, batches, VIT_STEPS, 0.0)
    rows, mem = run["rows"], run["memory"]
    first, last = run["first"]["loss"].item(), run["last"]["loss"].item()
    device_ms = [r["events"][T.STEP_TIME]["device_ms"] for r in rows
                 if r["events"][T.STEP_TIME].get("device_ms") is not None]
    out = {"n_params": n_params, "batch": VIT_BATCH, "steps": VIT_STEPS, "loss_first": first, "loss_last": last,
           "step_device_ms": spread(device_ms) if device_ms else None,
           "step_peak_bytes": max((m["step_peak_bytes"] for m in mem), default=0),
           "launches": run["launches"], "wall_s": run["wall_s"]}
    log("vit", f"ViTConfig() image {cfg.image_size} patch {cfg.patch_size} hidden {cfg.hidden} layers "
               f"{cfg.n_layers} heads {cfg.n_heads} ffn {cfg.ffn_hidden} classes {cfg.n_classes}, bf16: "
               + json.dumps(out))
    check(len(rows) == VIT_STEPS, f"vit: {len(rows)} step rows for {VIT_STEPS} steps")
    check(all(r["clock"] == "device" and (r["events"][T.STEP_TIME].get("device_ms") or 0) > 0 for r in rows),
          "vit: a step row is not on the device clock")
    check(not any(T.COMPILE_TIME in r["events"] for r in rows), "vit: a compile phase in an eager loop")
    check(run["launches"] == 0, f"vit: {run['launches']} flash launches, not 0")
    check(math.isfinite(last) and last < first, f"vit: loss did not fall: first {first}, last {last}")
    check(out["step_peak_bytes"] > n_params * 16, f"vit: step peak {out['step_peak_bytes']} below params + "
                                                  "grads + AdamW state")
    del model, step
    return out


def straggler_span_phase() -> dict:
    """The compute straggler's injection on the card: a step function
    that sleeps ``STRAGGLER_SLEEP_S`` after its work is enqueued, inside
    ``wrap_step_fn``'s region.  The region's CUDA event is recorded after
    the sleep, so its device-clock span must cover it: every row on the
    device clock with at least ``STRAGGLER_SPAN_MIN`` of
    ``STRAGGLER_SLEEP_S`` as compute."""
    import numpy as np

    import traceml_tpu_torch as tm
    from traceml_tpu_torch.models.mlp import TinyMLP, make_mlp_train_step
    from traceml_tpu_torch.utils import timing as T
    from traceml_tpu_torch.utils.overhead_governor import get_governor, reset_governor_for_tests

    model = TinyMLP(hidden=256, depth=3)
    init, train_step = make_mlp_train_step(model)
    init(SEED)
    rng = np.random.default_rng(SEED)
    batches = [(torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)),
                torch.from_numpy(rng.normal(size=(64, 1)).astype(np.float32)))]

    def slow(batch):
        loss = train_step(*batch)
        time.sleep(STRAGGLER_SLEEP_S)
        return loss

    # the lab runs this scenario in a process of its own, so it starts from
    # the overhead governor such a process has: the marker stride that the
    # ViT's 10-20 ms steps left behind holds for up to 8 more steps, and a
    # first step it does not sample carries no compute marker
    left = {"stride": get_governor().marker_stride, "probe_us": get_governor().probe_cost_ema * 1e6}
    reset_governor_for_tests()
    run = traced_loop(tm.wrap_step_fn(slow, estimate_flops=False), batches, STRAGGLER_STEPS, 0.0)
    compute = [r["events"][T.COMPUTE_TIME].get("device_ms") for r in run["rows"]]
    log("scenario", f"compute straggler span: compute device ms {compute}, clocks "
                    f"{sorted({r['clock'] for r in run['rows']})}, late markers "
                    f"{sum(r.get('late_markers', 0) for r in run['rows'])}; the governor left before it {left}")
    check(len(compute) == STRAGGLER_STEPS and all(r["clock"] == "device" for r in run["rows"]),
          "compute straggler: a row not on the device clock")
    check(all(v is not None and v >= STRAGGLER_SPAN_MIN * STRAGGLER_SLEEP_S * 1e3 for v in compute),
          f"compute straggler: device compute {compute} ms does not span the {STRAGGLER_SLEEP_S} s sleep")
    return {"compute_device_ms": compute}


class ScenarioRuns:
    """``SCENARIO_RUNS`` as ``launch_run`` calls on threads (each a
    launcher process), started in waves: ``start(names)`` launches those
    calls, ``wait(names)`` waits for them, ``finish()`` waits for every
    call started and returns each call's result and the wall time from
    the first start."""

    def __init__(self) -> None:
        from concurrent.futures import ThreadPoolExecutor

        self.pool = ThreadPoolExecutor(len(SCENARIO_RUNS))
        self.futures = {}
        self.t0 = None

    def start(self, names) -> None:
        def one(job):
            name, script, argv, nprocs = job
            return launch_run(name, 0.0, 0.25, script=script, argv_tail=argv,
                              launcher_args=("--nprocs", str(nprocs)), env_extra=SCENARIO_ENV.get(name))

        self.t0 = self.t0 or time.perf_counter()
        for job in SCENARIO_RUNS:
            if job[0] in names:
                self.futures[job[0]] = self.pool.submit(one, job)

    def wait(self, names) -> None:
        for name in names:
            self.futures[name].result()

    def finish(self) -> dict:
        try:
            runs = {name: future.result() for name, future in self.futures.items()}
        finally:
            self.pool.shutdown(wait=True)
        wall = time.perf_counter() - self.t0
        for name, run in runs.items():
            run["flash_launches"] = flash_launches(name, run)
            check(run["flash_launches"] == 0, f"run {name}: {run['flash_launches']} flash launches, not 0")
            manifest = run["manifest"]
            check((manifest["status"], manifest["telemetry_status"]) == ("completed", "ok"),
                  f"run {name}: manifest {manifest['status']}/{manifest['telemetry_status']}")
        timelines = {name: run_timeline(run) for name, run in runs.items()}
        log("scenario", f"{len(runs)} runs in {wall:.2f} s wall from the first start; each: "
                        + json.dumps(timelines))
        return {"runs": runs, "wall_s": wall, "timelines": timelines}


def run_timeline(run: dict) -> dict:
    """Where a ``run``'s wall time went, on the host's clock: from the
    launch to the first stored step's stamp (``setup_s``: the launcher,
    the aggregator, each rank's imports, device and model, and the first
    step), the stamps' span (``loop_s``, of which ``compile_s`` in
    compile events), and from the last stamp to the launcher's exit
    (``tail_s``: the last steps' shipping and the finalize)."""
    from traceml_tpu_torch.utils import timing as T

    conn = sqlite3.connect(run["session"] / "telemetry.sqlite")
    try:
        first, last = conn.execute("SELECT MIN(timestamp), MAX(timestamp) FROM step_time_samples").fetchone()
    finally:
        conn.close()
    compile_ms = sum((json.loads(events).get(T.COMPILE_TIME) or {}).get("cpu_ms") or 0.0
                     for _, _, events in run["rows"])
    return {"wall_s": run["wall_s"], "setup_s": first - run["started_at"], "loop_s": last - first,
            "compile_s": compile_ms / 1e3, "tail_s": run["started_at"] + run["wall_s"] - last}


def _scenario_gate(name: str, run: dict, detector) -> dict:
    from traceml_tpu_torch.dev.precision_harness import _collect_fault_findings

    summary = run["summary"]
    hit, observed = detector(summary)
    st = summary["sections"]["step_time"]
    out = {"hit": hit, "observed": observed, "primary": summary["primary_diagnosis"]["kind"],
           "issues": sorted({i["kind"] for i in st.get("issues") or []}),
           "findings": [f["kind"] for f in _collect_fault_findings(summary)],
           "clock": (st.get("global") or {}).get("clock"), "wall_s": run["wall_s"]}
    log("scenario", f"{name}: " + json.dumps(out))
    check(hit, f"run {name}: the harness's detector missed ({observed})")
    return out


def vit_stress_run_phase(scenarios: dict) -> dict:
    """``vit_stress`` under ``run``: with no fault no fault-kind finding
    anywhere, with ``input_bound`` INPUT_BOUND as the primary diagnosis."""
    from traceml_tpu_torch.dev.precision_harness import _healthy, _primary_is

    runs = scenarios["runs"]
    none = _scenario_gate("vit_stress_none", runs["vit_stress_none"], _healthy)
    check(none["findings"] == [], f"run vit_stress_none: fault findings {none['findings']}")
    slow = _scenario_gate("vit_stress_input_bound", runs["vit_stress_input_bound"], _primary_is("INPUT_BOUND"))
    return {"none": none, "input_bound": slow}


def scenario_lab_phase(scenarios: dict) -> dict:
    """The demo scenarios under ``run`` on the card, each held by the
    precision harness's detector of it; ``input_straggler`` also sees four
    ranks, ``recompile`` runs under inductor with compile events after the
    warm-up on at least ``RECOMPILE_MIN_STEPS`` stored steps."""
    from traceml_tpu_torch.dev.precision_harness import SCENARIOS
    from traceml_tpu_torch.diagnostics.step_time.policy import SUMMARY_POLICY
    from traceml_tpu_torch.utils import timing as T

    runs = scenarios["runs"]
    out = {}
    for scenario in ("healthy", "input_bound", "input_straggler", "recompile", "checkpoint_stall", "memory_creep"):
        name = f"scenario_{scenario}"
        out[scenario] = _scenario_gate(name, runs[name], SCENARIOS[scenario][2])
    topo = runs["scenario_input_straggler"]["summary"]["meta"]["topology"]
    check(topo["world_size"] == 4 and sorted(topo["ranks_seen"]) == [0, 1, 2, 3],
          f"run scenario_input_straggler: topology {topo}")
    recompile = runs["scenario_recompile"]
    compiled = [step for step, _, events in recompile["rows"]
                if T.COMPILE_TIME in json.loads(events) and step > SUMMARY_POLICY.compile_warmup_steps]
    line = [ln for ln in recompile["stdout"].splitlines() if ln.startswith("scenario recompile:")]
    out["recompile"].update({"compile_steps_after_warmup": compiled, "line": line})
    log("scenario", f"recompile: compile events on steps {compiled} after the warm-up; {line}")
    check(len(compiled) >= RECOMPILE_MIN_STEPS, f"run scenario_recompile: compile events on steps {compiled}")
    check(line and "backend inductor" in line[0], f"run scenario_recompile: not under inductor: {line}")
    ckpt = runs["scenario_checkpoint_stall"]["summary"]["sections"]["step_time"]["global"]["phases"]["checkpoint"]
    growth = runs["scenario_memory_creep"]["summary"]["sections"]["step_memory"]["global"]["per_rank"]["0"]
    out["checkpoint_stall"]["checkpoint_mean_ms"] = ckpt["mean_ms"]
    out["memory_creep"]["growth_bytes"] = growth["growth_bytes"]
    return out


LIGHTNING_STEPS = 30
RAY_STEPS = 60  # the summary's step-time verdict needs 50 aligned steps


@contextlib.contextmanager
def stand_in_module(name: str, **attrs):
    """``name`` (and its parents) in ``sys.modules`` as plain modules
    holding ``attrs``, for the extent of the block, unless the real
    package imports; yields whether a stand-in was used."""
    import importlib
    import types

    try:
        importlib.import_module(name)
        yield False
        return
    except ImportError:
        pass
    parts = name.split(".")
    added = []
    for i in range(1, len(parts) + 1):
        mod_name = ".".join(parts[:i])
        if mod_name not in sys.modules:
            sys.modules[mod_name] = types.ModuleType(mod_name)
            added.append(mod_name)
        if i > 1:
            setattr(sys.modules[".".join(parts[:i - 1])], parts[i - 1], sys.modules[mod_name])
    for key, value in attrs.items():
        setattr(sys.modules[name], key, value)
    try:
        yield True
    finally:
        for mod_name in added:
            sys.modules.pop(mod_name, None)


def lightning_callback_phase(cfg) -> dict:
    """``LIGHTNING_STEPS`` steps of the full-width AdamW step ((8, 1025)
    tokens) in process through the port's ``TraceMLCallback``, driven by a
    minimal loop that calls the hooks in Lightning 2.x's
    automatic-optimization order (``on_before_zero_grad`` before the
    backward) on a stand-in ``lightning.pytorch.Callback`` when Lightning
    is not installed; the callback's ``setup`` inits in manual mode and a
    runtime ships the rows.  Gates: one row a step, every row on the
    device clock with one forward, one backward and one optimizer region,
    each with a device time, their sum no more than the step's; 12 flash
    launches a step; the loss falling."""
    import types

    import traceml_tpu_torch as tm
    from traceml_tpu_torch.dev.workload import TRAIN_TOKENS, build_train_state, host_batches
    from traceml_tpu_torch.models.transformer import loss_fn
    from traceml_tpu_torch.ops.flash_attention import flash_attention
    from traceml_tpu_torch.runtime.lifecycle import get_active_runtime
    from traceml_tpu_torch.runtime.settings import TraceMLSettings
    from traceml_tpu_torch.sdk.initial import shutdown_patches
    from traceml_tpu_torch.sdk.state import get_state
    from traceml_tpu_torch.utils import timing as T

    class Callback:  # the base's hooks, as no-ops
        def setup(self, trainer, pl_module, stage=None):
            pass

    batches = host_batches(cfg, SEED + 1, seq=TRAIN_TOKENS)
    model, optimizer = build_train_state(cfg, SEED)
    with stand_in_module("lightning.pytorch", Callback=Callback) as stand_in:
        from traceml_tpu_torch.integrations import lightning as L

        L._cached_callback_cls = None
        log("lightning", "Lightning is not installed: a stand-in lightning.pytorch.Callback base"
            if stand_in else "the installed lightning.pytorch.Callback base")
        shutdown_patches()
        cb = L.TraceMLCallback()
        L._cached_callback_cls = None
    trainer = types.SimpleNamespace(sanity_checking=False)
    cb.setup(trainer, model, stage="fit")
    check(get_state().patch_mode == "manual", f"lightning: setup left patch mode {get_state().patch_mode}")
    tokens = batches[0].cuda()
    loss_fn(model, tokens).backward()  # the warm-up step, outside the trace
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    tm.start_runtime(TraceMLSettings(sampler_interval_sec=0.5))
    rt = get_active_runtime()
    get_state().last_step_exit = None
    torch.cuda.synchronize()
    flash_attention.launches = 0
    losses = []
    t0 = time.perf_counter()
    for i in range(LIGHTNING_STEPS):
        tokens = batches[i % len(batches)].cuda(non_blocking=True)
        cb.on_train_batch_start(trainer, model, tokens, i)
        loss = loss_fn(model, tokens)  # training_step
        cb.on_before_zero_grad(trainer, model, optimizer)
        optimizer.zero_grad(set_to_none=True)
        cb.on_before_backward(trainer, model, loss)
        loss.backward()
        cb.on_after_backward(trainer, model)
        cb.on_before_optimizer_step(trainer, model, optimizer)
        optimizer.step()
        cb.on_train_batch_end(trainer, model, loss.detach(), tokens, i)
        losses.append(loss.detach())
    cb.on_train_end(trainer, model)
    cb.teardown(trainer, model, stage="fit")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = flash_attention.launches
    time.sleep(1.0)  # one tick samples the finished steps
    rows = rt.sampler("step_time").db.tail("step_time")
    tm.stop_runtime()
    shutdown_patches()
    first, last = losses[0].item(), losses[-1].item()
    phases = {name: phase_medians(rows, name) for name in ("STEP_TIME", "FORWARD_TIME", "BACKWARD_TIME",
                                                           "OPTIMIZER_STEP")}
    over = []
    for r in rows:
        ev = r["events"]
        parts = [ev.get(k, {}).get("device_ms") for k in (T.FORWARD_TIME, T.BACKWARD_TIME, T.OPTIMIZER_STEP)]
        if None not in parts and sum(parts) > ev[T.STEP_TIME]["device_ms"] * (1 + 1e-9) + 1e-6:
            over.append((r["step"], sum(parts), ev[T.STEP_TIME]["device_ms"]))
    out = {"steps": LIGHTNING_STEPS, "launches": launches, "wall_s": wall_s, "loss_first": first,
           "loss_last": last, "stand_in_base": stand_in, "phases": phases}
    log("lightning", json.dumps(out))
    check(launches == cfg.n_layers * LIGHTNING_STEPS,
          f"lightning: {launches} flash launches, not {cfg.n_layers} x {LIGHTNING_STEPS}")
    check(len(rows) == LIGHTNING_STEPS, f"lightning: {len(rows)} step rows for {LIGHTNING_STEPS} steps")
    for r in rows:
        ev = r["events"]
        check(r["clock"] == "device", f"lightning: step {r['step']} on the {r['clock']} clock")
        for key in (T.STEP_TIME, T.FORWARD_TIME, T.BACKWARD_TIME, T.OPTIMIZER_STEP):
            check(key in ev and ev[key]["count"] == 1 and (ev[key].get("device_ms") or 0) > 0,
                  f"lightning: step {r['step']} {key}: {ev.get(key)}")
        check(T.COMPUTE_TIME not in ev, f"lightning: step {r['step']} has a compute phase")
    check(not over, f"lightning: the regions sum past the step: {over[:3]}")
    check(math.isfinite(last) and last < first, f"lightning: loss did not fall: first {first}, last {last}")
    del model, optimizer
    return out


def ray_loop_phase(cfg) -> dict:
    """The port's ``traceml_train_loop`` on a stand-in ``ray`` module
    (Ray is not installed) whose actors live in this process: as rank 0
    it makes the aggregator actor, resolves its endpoint, starts the
    runtime, inits the patches and runs ``RAY_STEPS`` full-width AdamW
    steps on the card under ``trace_step`` with the step's FLOPs
    declared; then it stops the runtime and has the actor finalize, and
    kills it.  Gates: the loop's result; the actor made, finalized and
    killed once; ``final_summary.json`` with ``RAY_STEPS`` steps, every
    stored row on the device clock, the verdict of the MFU's band; 12
    flash launches a step."""
    import types

    import traceml_tpu_torch as tm
    from traceml_tpu_torch.dev.workload import TRAIN_TOKENS, build_train_state, host_batches
    from traceml_tpu_torch.models.transformer import make_train_step
    from traceml_tpu_torch.ops.flash_attention import flash_attention
    from traceml_tpu_torch.runtime.settings import TraceMLSettings
    from traceml_tpu_torch.sdk.initial import shutdown_patches

    registry, killed = {}, []

    class Ref:
        def __init__(self, value):
            self.value = value

    class Handle:  # an actor: each method's .remote() runs it here
        def __init__(self, impl):
            self._impl = impl

        def __getattr__(self, attr):
            fn = getattr(self._impl, attr)
            return types.SimpleNamespace(remote=lambda *a, **k: Ref(fn(*a, **k)))

    class Remote:
        def __init__(self, cls):
            self._cls, self._name = cls, None

        def options(self, name=None, **kw):
            self._name = name
            return self

        def remote(self, *args, **kwargs):
            handle = registry[self._name] = Handle(self._cls(*args, **kwargs))
            return handle

    def get_actor(name):
        if name not in registry:
            raise ValueError(f"no actor {name}")
        return registry[name]

    def kill(handle):
        killed.append(handle)
        for k in [k for k, v in registry.items() if v is handle]:
            del registry[k]

    stub = dict(remote=Remote, get=lambda ref, timeout=None: ref.value, get_actor=get_actor, kill=kill,
                util=types.SimpleNamespace(get_node_ip_address=lambda: "127.0.0.1"),
                get_runtime_context=lambda: types.SimpleNamespace(get_job_id=lambda: "chip_smoke"))
    logs = RUN_DIR / "ray_loop"
    shutil.rmtree(logs, ignore_errors=True)
    settings = TraceMLSettings(session_id="ray_loop", logs_dir=logs, mode="summary", expected_world_size=1,
                               sampler_interval_sec=0.5, finalize_timeout_sec=60.0, run_name="ray_loop")
    batches = host_batches(cfg, SEED + 1, seq=TRAIN_TOKENS)
    model, optimizer = build_train_state(cfg, SEED)
    step = make_train_step(model, optimizer)
    analytic = analytic_train_flops(cfg, BATCH, TRAIN_TOKENS - 1)

    def user_loop(config):
        tm.set_step_flops(analytic)
        tm.set_step_tokens(BATCH * (TRAIN_TOKENS - 1))
        torch.cuda.synchronize()
        flash_attention.launches = 0
        first = last = None
        for i in range(config["steps"]):
            tokens = batches[i % len(batches)].cuda(non_blocking=True)
            with tm.trace_step():
                last = step(tokens)["loss"]
            first = last if first is None else first
        torch.cuda.synchronize()
        return {"launches": flash_attention.launches, "loss_first": first.item(), "loss_last": last.item()}

    step(batches[0].cuda())  # the warm-up step, outside the trace
    shutdown_patches()
    with stand_in_module("ray", **stub) as stand_in:
        from traceml_tpu_torch.integrations.ray import actor_name_for, traceml_train_loop

        log("ray", "Ray is not installed: a stand-in ray module, its actors in this process" if stand_in
            else "the installed ray module")
        check(stand_in, "ray: the phase drives the stand-in module; an installed ray would start a cluster")
        t0 = time.perf_counter()
        result = traceml_train_loop(user_loop, settings=settings, device="cuda")({"steps": RAY_STEPS})
        wall_s = time.perf_counter() - t0
        name = actor_name_for(settings)
    shutdown_patches()
    summary = json.loads((logs / "ray_loop" / "final_summary.json").read_text())
    conn = sqlite3.connect(logs / "ray_loop" / "telemetry.sqlite")
    try:
        clocks = [c for (c,) in conn.execute("SELECT clock FROM step_time_samples ORDER BY step")]
    finally:
        conn.close()
    st = summary["sections"]["step_time"]
    kind = summary["primary_diagnosis"]["kind"]
    out = {"steps": RAY_STEPS, "launches": result["launches"], "wall_s": wall_s, "actor": name,
           "loss_first": result["loss_first"], "loss_last": result["loss_last"], "verdict": kind,
           "n_steps": st["global"]["n_steps"], "mfu_median": st["global"]["efficiency"]["mfu_median"],
           "steady_step_ms": st["global"]["steady_state"]["median_ms"]}
    log("ray", json.dumps(out))
    check(len(killed) == 1 and not registry, f"ray: actor {name}: {len(killed)} kills, left {list(registry)}")
    check(result["launches"] == cfg.n_layers * RAY_STEPS,
          f"ray: {result['launches']} flash launches, not {cfg.n_layers} x {RAY_STEPS}")
    check(st["global"]["n_steps"] == RAY_STEPS and clocks == ["device"] * RAY_STEPS,
          f"ray: {st['global']['n_steps']} steps in the summary, {len(clocks)} rows on clocks {sorted(set(clocks))}")
    check(kind == mfu_verdict(summary), f"ray: verdict {kind}, not {mfu_verdict(summary)}")
    check(result["loss_last"] < result["loss_first"], f"ray: loss first {result['loss_first']} "
                                                      f"last {result['loss_last']}")
    del model, optimizer, step
    return out


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
    started = time.perf_counter()
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
    seq_parallel_train_phase(cfg)
    torch.cuda.empty_cache()
    log("time", f"seq parallel train phase {time.perf_counter() - t0:.2f} s")
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
    sp_run = seq_parallel_run_phase(cfg, train_healthy)
    kernel["launches"] += sp_run["flash_launches"]
    kernel["launches_by_path"]["train_seq_parallel_run"] = sp_run["flash_launches"]
    log("time", f"seq parallel run phase {time.perf_counter() - t0:.2f} s")
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
    t0 = time.perf_counter()
    parallel = parallel_workloads_phase(cfg)
    for route, path in (("tensor", "train_tensor_parallel"), ("tensor_fsdp", "train_tensor_fsdp")):
        kernel["launches"] += parallel["launches"][route]
        kernel["launches_by_path"][path] = parallel["launches"][route]
    log("time", f"parallel workloads phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    moe_pipeline = moe_pipeline_run_phase()
    kernel["launches"] += moe_pipeline["flash_launches"]
    kernel["launches_by_path"]["moe_pipeline_run"] = moe_pipeline["flash_launches"]
    log("time", f"moe pipeline run phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    vit = vit_train_phase()
    straggler_span_phase()
    torch.cuda.empty_cache()
    scenario = ScenarioRuns()
    scenario.start(SCENARIO_FIRST)
    scenario.wait(SCENARIO_FIRST[:2])
    scenario.start({job[0] for job in SCENARIO_RUNS} - set(SCENARIO_FIRST))
    scenarios = scenario.finish()
    vit_stress_run_phase(scenarios)
    scenario_lab_phase(scenarios)
    # 0 on each: the ViT's attention is the einsum reference, as in JAX
    by_path = {"vit_train": vit["launches"],
               "vit_stress_run": sum(r["flash_launches"] for n, r in scenarios["runs"].items()
                                     if n.startswith("vit_stress")),
               "scenario_lab_run": sum(r["flash_launches"] for n, r in scenarios["runs"].items()
                                       if n.startswith("scenario_"))}
    kernel["launches"] += sum(by_path.values())
    kernel["launches_by_path"].update(by_path)
    log("time", f"vit and scenario lab phases {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    by_path = {"lightning_callback": lightning_callback_phase(cfg)["launches"]}
    torch.cuda.empty_cache()
    by_path["ray_loop"] = ray_loop_phase(cfg)["launches"]
    torch.cuda.empty_cache()
    kernel["launches"] += sum(by_path.values())
    kernel["launches_by_path"].update(by_path)
    log("time", f"lightning and ray phases {time.perf_counter() - t0:.2f} s")
    log("time", f"total {time.perf_counter() - started:.2f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
