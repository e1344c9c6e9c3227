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
5. Run phase: the product's entry point, ``python -m traceml_tpu_torch run
   --mode summary traceml_tpu_torch/dev/forward_script.py``, twice as a
   subprocess: healthy with the sender ticking every 0.1 s (ten times the
   default rate, so it ships about a dozen batches while the loop runs),
   then with the same input delay at the default 1 s tick.  The launcher
   spawns the aggregator and one rank; the rank runs the same full-width
   forward loop through the kernel and ships its rows over TCP; the
   aggregator stores them in SQLite and writes ``final_summary.json``.
   Gates: the summary's step-time section on the device clock with at
   least 50 steps, its step-memory section with a positive peak, one
   ``step_time_samples`` row per traced step, the manifest ``completed``
   with telemetry ``ok``, no dropped rows or decode errors, 12 × 60 flash
   launches in the rank, COMPUTE_BOUND healthy and INPUT_BOUND with the
   delay (in the summary and on the launcher's stdout).  Reported: the
   step device times under ``run`` (median, mean, p90, max) against the
   in-process loop's, which runs no sender; the sender's busy ticks, its
   collect and encode cost per busy tick, its flush cost per timed send
   and its codec, the aggregator's finalization
   time and each call's wall time.  The sessions are kept under
   ``traceml_logs/chip_smoke/``.

Any failed check exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import json
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


def traced_loop(model, batches, steps: int, delay_s: float) -> dict:
    """``steps`` traced forward steps under a fresh runtime; returns the
    runtime's rows, the kernel launches and the loop's wall time."""
    import traceml_tpu_torch as tm
    from traceml_tpu_torch.ops.flash_attention import flash_attention
    from traceml_tpu_torch.runtime.lifecycle import get_active_runtime
    from traceml_tpu_torch.runtime.settings import TraceMLSettings

    def host_batches():
        for i in range(steps):
            if delay_s:
                time.sleep(delay_s)
            yield batches[i % len(batches)]

    def forward(tokens):
        with torch.inference_mode():
            return model(tokens)

    tm.start_runtime(TraceMLSettings(sampler_interval_sec=0.5))
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

    tm.init(mode="auto")
    run = traced_loop(model, batches, STEPS, 0.0)
    rows, mem = run["rows"], run["memory"]
    check(run["launches"] == cfg.n_layers * STEPS,
          f"flash launches {run['launches']} != {cfg.n_layers} x {STEPS}")
    check(len(rows) == STEPS, f"{len(rows)} step rows for {STEPS} steps")
    check(all(r["clock"] == "device" for r in rows), "a step row is not on the device clock")
    for key in (T.STEP_TIME, T.COMPUTE_TIME, T.H2D_TIME):
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
    return {"launches": run["launches"], "n_layers": cfg.n_layers, "delay_ms": delay_s * 1e3,
            "step_ms": spread(r["events"][T.STEP_TIME]["device_ms"] for r in rows)}


def launch_run(name: str, delay_ms: float, interval_s: float) -> dict:
    """One ``python -m traceml_tpu_torch run`` call; returns its session's
    artifacts, the launcher's output and the call's wall time."""
    logs = RUN_DIR / name
    shutil.rmtree(logs, ignore_errors=True)
    argv = [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary",
            "--logs-dir", str(logs), "--run-name", name, "--sampler-interval", repr(interval_s),
            str(REPO / "traceml_tpu_torch" / "dev" / "forward_script.py"),
            "--", "--steps", str(STEPS), "--delay-ms", repr(delay_ms)]
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
    try:
        rows = conn.execute("SELECT step, clock, events_json FROM step_time_samples ORDER BY step").fetchall()
    finally:
        conn.close()
    return {"summary": read("final_summary.json"), "manifest": read("manifest.json"),
            "ingest": read("ingest_stats.json"), "rows": rows, "stdout": out, "wall_s": wall_s}


def check_run(name: str, run: dict, n_layers: int, verdict: str) -> dict:
    """The run phase's gates on one call; returns its reported numbers."""
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
    steps = [r[0] for r in run["rows"]]
    check(steps == list(range(1, STEPS + 1)), f"run {name}: step_time_samples hold steps {steps[:3]}..., "
                                              f"{len(steps)} rows for {STEPS} steps")
    launch_lines = [l for l in run["stdout"].splitlines() if l.startswith("flash_attention.launches ")]
    launches = int(launch_lines[-1].split()[1]) if launch_lines else None
    check(launches == n_layers * STEPS, f"run {name}: rank reports {launches} flash launches, "
                                        f"not {n_layers} x {STEPS}")
    kind = summary["primary_diagnosis"]["kind"]
    log("run", f"{name}: verdict {kind} ({summary['primary_diagnosis']['severity']}): "
               f"{summary['primary_diagnosis'].get('summary')}")
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
    }


def run_phase(main: dict) -> None:
    """``python -m traceml_tpu_torch run`` on the card, healthy with a fast
    sender tick and with the main path's input delay at the default tick,
    held to the gates of ``check_run``."""
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    for name, delay_ms, interval_s, verdict in (("healthy", 0.0, 0.1, "COMPUTE_BOUND"),
                                                ("input_delay", main["delay_ms"], 1.0, "INPUT_BOUND")):
        got = check_run(name, launch_run(name, delay_ms, interval_s), main["n_layers"], verdict)
        log("run", f"{name} (delay {delay_ms:.3f} ms, sender tick {interval_s} s) " + json.dumps(got))
        if name == "healthy":
            run_ms, ref_ms = got["step_device_ms"], main["step_ms"]
            log("run", "step device ms under run (stored rows) vs in-process (no sender): " + ", ".join(
                f"{k} {run_ms[k]:.4f} vs {ref_ms[k]:.4f} ({run_ms[k] / ref_ms[k]:.4f}x)" for k in run_ms)
                + f"; {got['producer']['busy_ticks']} busy sender ticks")


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
    main_path = main_path_phase()
    kernel["launches"] = main_path["launches"]
    torch.cuda.empty_cache()  # the rank processes below hold their own model
    log("time", f"main path and fault phases {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    run_phase(main_path)
    log("time", f"run phase {time.perf_counter() - t0:.2f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
