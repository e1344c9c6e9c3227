"""Training-rank child-process entry.

Counterpart of ``traceml_tpu/runtime/executor.py``.  The launcher starts
each rank as::

    python -m traceml_tpu_torch.runtime.executor

with the script, its arguments and every setting carried by
``TRACEML_*`` variables.  The executor starts the runtime agent, runs the
user script through ``runpy.run_path`` with its argv and directory, and
guarantees: a crash log in ``<session>/rank_<r>/runtime_error.log``, an
exit code normalized as the interpreter would, and the runtime stopped
(its telemetry drained and published, ``rank_finished`` sent) however
the script ends.  A runtime that fails to start degrades to a no-op and
the script still runs.

**No auto-init.**  The JAX executor calls ``init(mode="auto")`` before the
script to apply its patches.  This port has no patches yet, and its
``init`` fixes the trace's device (CUDA unless the caller asks for the
CPU), so calling it here would either raise on a host without CUDA or fix
the device before the script's own ``init(device=...)`` could choose it.
So the executor starts only the runtime; the script's first ``init``
sets the device, and nothing on the runtime's side reads the device
before a traced step asks for it (the step-memory tracker is created on
first use, from ``state.device``).
"""

from __future__ import annotations

import os
import runpy
import shlex
import sys
import traceback
from pathlib import Path
from typing import List

from traceml_tpu_torch.runtime import lifecycle
from traceml_tpu_torch.runtime.settings import (
    ENV_SCRIPT,
    ENV_SCRIPT_ARGS,
    TraceMLSettings,
    settings_from_env,
)
from traceml_tpu_torch.utils.error_log import get_error_log


def run_user_script(script: str, args: List[str]) -> int:
    """``runpy`` with argv swapped in; returns the exit code."""
    old_argv = sys.argv
    sys.argv = [script] + args
    script_dir = str(Path(script).resolve().parent)
    path_added = script_dir not in sys.path
    if path_added:
        sys.path.insert(0, script_dir)
    try:
        runpy.run_path(script, run_name="__main__")
        return 0
    except SystemExit as exc:
        code = exc.code
        if code is None:
            return 0
        if isinstance(code, int):
            return code
        # SystemExit("message"): the interpreter prints it and exits 1
        print(code, file=sys.stderr)
        return 1
    finally:
        sys.argv = old_argv
        if path_added:
            try:
                sys.path.remove(script_dir)
            except ValueError:
                pass


def main() -> int:
    script = os.environ.get(ENV_SCRIPT)
    raw_args = os.environ.get(ENV_SCRIPT_ARGS, "")
    args = shlex.split(raw_args) if raw_args else []
    if not script:
        print("[TraceML] executor: TRACEML_SCRIPT not set", file=sys.stderr)
        return 2
    settings = settings_from_env()
    try:
        rank = int(os.environ.get("RANK", 0))
    except ValueError:
        rank = 0
    get_error_log().set_path(settings.rank_dir(rank) / "error.log")
    lifecycle.start_runtime(settings)
    exit_code = 0
    try:
        exit_code = run_user_script(script, args)
    except BaseException as exc:  # crash log, then normalize the exit code
        _write_crash_log(settings, rank, exc)
        if isinstance(exc, KeyboardInterrupt):
            exit_code = 130
        else:
            traceback.print_exc()
            exit_code = 1
    finally:
        lifecycle.stop_runtime()
    return exit_code


def _write_crash_log(settings: TraceMLSettings, rank: int, exc: BaseException) -> None:
    try:
        path = settings.rank_dir(rank) / "runtime_error.log"
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a", encoding="utf-8") as fh:
            fh.write("".join(traceback.format_exception(type(exc), exc, exc.__traceback__)))
    except OSError:
        pass


if __name__ == "__main__":
    sys.exit(main())
