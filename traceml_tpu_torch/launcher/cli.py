"""``python -m traceml_tpu_torch`` command line.

Counterpart of ``traceml_tpu/launcher/cli.py`` with the ``run``, ``view``,
``compare``, ``inspect`` and ``profile`` subcommands (``watch``,
``fleet-router`` and ``lint`` come later).  ``run``'s ``--mode`` takes the
three JAX modes: ``cli`` (the live display, the default), ``summary``
(the verdict on stdout at the end) and ``dashboard`` (the browser
dashboard, its URL on stdout).  A long run stays bounded with
``--trace-max-steps N`` (recording stops after step N while the script
trains on), ``--summary-window-rows W`` (the session database keeps
1.5 W raw rows per table and rank and folds older ones into the 10 s and
1 m rollup tiers), ``--disk-backup`` (each rank also appends what it
ships to ``rank_N/data``) and ``--no-capture-stderr`` (rank stderr stays
out of the live display).  ``view`` prints a finished run's summary,
``compare`` judges a candidate run against a baseline run (a verdict
from INSUFFICIENT_DATA to EQUIVALENT, ranked findings; ``--output P``
writes the payload to P and the text beside it), ``inspect`` decodes the disk backups (``--domain rollup``: the stitched
history of the tiers), ``profile`` has a RUNNING session record a
``torch.profiler`` trace of its next ``--steps`` steps on every rank (or
``--ranks``) and prints where it went (exit 1 when the job does not
answer within ``--timeout`` or answers with an error).

A multi-node run starts one ``run`` per node, each with ``--nnodes N
--node-rank I --aggregator-port P`` and the same ``TRACEML_SESSION_ID``:
node 0 owns the aggregator (bound on ``0.0.0.0``) and writes the report;
every other node's ranks dial ``--aggregator-host`` (node 0's address)
over TCP.

    python -m traceml_tpu_torch run [--mode cli|summary|dashboard] [options] script.py [-- script args]
    python -m traceml_tpu_torch run --nnodes 2 --node-rank 0|1 --aggregator-host H --aggregator-port P ...
    python -m traceml_tpu_torch view <session dir | final_summary.json> [--format text|json]
    python -m traceml_tpu_torch compare <baseline> <candidate> [--output P]
    python -m traceml_tpu_torch inspect <rank data dir | .msgpack | session dir> [--limit N] [--domain D]
    python -m traceml_tpu_torch profile <session dir> [--steps 5] [--timeout 60] [--ranks 0,1]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m traceml_tpu_torch",
        description=(
            "Training observability for PyTorch on NVIDIA GPUs: run a "
            "training script under tracing, split every step into phases, "
            "diagnose bottlenecks, and write a final summary."
        ),
    )
    sub = p.add_subparsers(dest="command", required=True)
    run = sub.add_parser("run", help="launch a training script under tracing")
    run.add_argument("script", help="path to the training script")
    run.add_argument("script_args", nargs=argparse.REMAINDER, default=[])
    run.add_argument("--mode", choices=("cli", "summary", "dashboard"), default=None,
                     help="display mode: cli (the live display, the default), summary, or "
                          "dashboard (the browser dashboard; its URL is printed)")
    run.add_argument("--run-name", dest="run_name", default=None)
    run.add_argument("--logs-dir", dest="logs_dir", default=None)
    run.add_argument("--nprocs", type=int, default=1, help="rank processes to start on this node")
    run.add_argument("--nnodes", type=int, default=1, help="nodes of a multi-node run (one launcher each)")
    run.add_argument("--node-rank", dest="node_rank", type=int, default=0,
                     help="this node's index; node 0 owns the aggregator and the report")
    run.add_argument("--aggregator-host", dest="aggregator_host", default=None,
                     help="the address the ranks dial (the owner node's address in a multi-node run)")
    run.add_argument("--aggregator-port", dest="aggregator_port", type=int, default=None,
                     help="the aggregator's port (required with --nnodes > 1)")
    run.add_argument("--sampler-interval", dest="sampler_interval_sec", type=float, default=None)
    run.add_argument("--trace-max-steps", dest="trace_max_steps", type=int, default=None,
                     help="stop recording after this many steps (the script trains on)")
    run.add_argument("--summary-window-rows", dest="summary_window_rows", type=int, default=None,
                     help="per-table, per-rank row window of the session database (1.5x is kept; "
                          "older rows fold into the rollup tiers)")
    run.add_argument("--finalize-timeout", dest="finalize_timeout_sec", type=float, default=None)
    run.add_argument("--disk-backup", dest="disk_backup", action="store_true", default=None,
                     help="each rank also appends what it ships to <session>/rank_N/data")
    run.add_argument("--no-capture-stderr", dest="capture_stderr", action="store_false", default=None,
                     help="leave rank stderr out of the live display and stdout.log")
    run.add_argument("--disable-traceml", dest="disable", action="store_true", default=False)

    view = sub.add_parser("view", help="print a stored final summary")
    view.add_argument("path", help="final_summary.json (or session dir)")
    view.add_argument("--format", choices=("text", "json"), default="text")

    cmp_ = sub.add_parser("compare", help="compare two final summaries")
    cmp_.add_argument("baseline", help="final_summary.json (or session dir) of the baseline run")
    cmp_.add_argument("candidate", help="final_summary.json (or session dir) of the candidate run")
    cmp_.add_argument("--output", default=None, help="write the payload here (and the text beside it)")

    insp = sub.add_parser("inspect", help="decode per-rank disk backups")
    insp.add_argument("path", help="a rank data dir, .msgpack file, or session dir")
    insp.add_argument("--limit", type=int, default=20)
    insp.add_argument(
        "--domain", default=None,
        help="only rows of this table (e.g. step_time); 'rollup' prints the stitched "
             "history of the session's rollup tiers, 'topology' its captured mesh",
    )

    prof = sub.add_parser("profile", help="capture a torch.profiler trace from a RUNNING session")
    prof.add_argument("session_dir", help="path to <logs>/<session>")
    prof.add_argument("--steps", type=int, default=5, help="steps to trace")
    prof.add_argument("--timeout", type=float, default=60.0)
    prof.add_argument("--ranks", default=None, help="comma-separated global ranks (default: all)")
    return p


def _profile(args: argparse.Namespace) -> int:
    from traceml_tpu_torch.sdk.profile_capture import request_profile_and_wait

    try:
        ranks = [int(r) for r in args.ranks.split(",")] if args.ranks else None
    except ValueError:
        print(f"traceml profile: --ranks must be comma-separated integers, got {args.ranks!r}",
              file=sys.stderr)
        return 2
    resp = request_profile_and_wait(Path(args.session_dir), steps=args.steps, timeout=args.timeout,
                                    ranks=ranks)
    if resp is None:
        print("[TraceML] no response — is the job stepping? (capture engages at step boundaries)",
              file=sys.stderr)
        return 1
    if not resp.get("ok"):
        print(f"[TraceML] profile failed: {resp.get('error')}", file=sys.stderr)
        return 1
    print(f"[TraceML] trace captured: {resp.get('trace_dir')}")
    print("  open rank_<r>/trace.json with chrome://tracing or the Perfetto UI")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "view":
        from traceml_tpu_torch.reporting.view.command import run_view

        return run_view(Path(args.path), fmt=args.format)
    if args.command == "compare":
        from traceml_tpu_torch.reporting.compare.command import run_compare

        return run_compare(Path(args.baseline), Path(args.candidate),
                           output=Path(args.output) if args.output else None)
    if args.command == "inspect":
        from traceml_tpu_torch.launcher.inspect_cmd import run_inspect

        return run_inspect(Path(args.path), limit=args.limit, domain=args.domain)
    if args.command == "profile":
        return _profile(args)
    from traceml_tpu_torch.launcher.commands import launch_process

    cli = {
        k: getattr(args, k)
        for k in ("mode", "run_name", "logs_dir", "nprocs", "nnodes", "node_rank", "aggregator_host",
                  "aggregator_port", "sampler_interval_sec", "trace_max_steps", "summary_window_rows",
                  "finalize_timeout_sec", "disk_backup", "capture_stderr", "disable")
    }
    script_args = list(args.script_args or [])
    if script_args[:1] == ["--"]:
        script_args = script_args[1:]
    return launch_process(args.script, script_args, **cli)
