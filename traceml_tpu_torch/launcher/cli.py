"""``python -m traceml_tpu_torch`` command line.

Counterpart of ``traceml_tpu/launcher/cli.py`` with the ``run``
subcommand (``view``, ``compare``, ``inspect``, ``watch`` and ``fleet``
come later).  ``--mode`` takes the three JAX modes: ``cli`` (the live
display, the default), ``summary`` (the verdict on stdout at the end) and
``dashboard`` (the browser dashboard, its URL on stdout).

    python -m traceml_tpu_torch run [--mode cli|summary|dashboard] [options] script.py [-- script args]
"""

from __future__ import annotations

import argparse
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
    run.add_argument("--nprocs", type=int, default=1, help="rank processes to start")
    run.add_argument("--sampler-interval", dest="sampler_interval_sec", type=float, default=None)
    run.add_argument("--finalize-timeout", dest="finalize_timeout_sec", type=float, default=None)
    run.add_argument("--disable-traceml", dest="disable", action="store_true", default=False)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    from traceml_tpu_torch.launcher.commands import launch_process

    cli = {
        k: getattr(args, k)
        for k in ("mode", "run_name", "logs_dir", "nprocs", "sampler_interval_sec",
                  "finalize_timeout_sec", "disable")
    }
    script_args = list(args.script_args or [])
    if script_args[:1] == ["--"]:
        script_args = script_args[1:]
    return launch_process(args.script, script_args, **cli)
