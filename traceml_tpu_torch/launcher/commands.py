"""Launch orchestration.

Counterpart of ``traceml_tpu/launcher/commands.py`` for the ``cli`` (the
default, as in JAX for a single-node run), ``summary`` and ``dashboard``
modes on one node (no yaml config or multi-node launch yet).  The settings carry ``--trace-max-steps``,
``--summary-window-rows``, ``--disk-backup`` and ``--no-capture-stderr``
to every child, resolved as in JAX (CLI > ``TRACEML_<KEY>`` > default),
and the transport tier's fields from the environment
(``TRACEML_TRANSPORT``, ``TRACEML_TRANSPORT_COMPRESS``,
``TRACEML_SHM_RING_BYTES``, ``TRACEML_SHM_DIR``, ``TRACEML_UDS_PATH``; the
port reads no YAML config).

``run``: resolve the settings (CLI > env > defaults), write the run
manifest and the code manifest (``code_manifest.json``, the static scan
of the script; traced or not, as in JAX; the manifest records the scan's
``code_manifest_ms``), start the aggregator and wait for its ready file, start N rank
processes (the executor entry, with the ``RANK``/``WORLD_SIZE`` contract),
supervise them, stop the aggregator gracefully (SIGTERM → it settles,
draws the live display's last frame in ``cli`` or stops the dashboard's
server in ``dashboard``, writes SQLite and the
final summary), then, in ``summary`` mode, enforce ``final_summary.json``
and print the verdict.  An aggregator that fails to start degrades the
run (training goes on untraced) instead of failing it.  One that dies
mid-run is restarted, as in JAX, up to ``TRACEML_AGG_MAX_RESTARTS`` times
(default 3) on the port it had bound, where the ranks' clients redial and
replay their spools; the manifest then reads ``telemetry_status:
"restarted"`` and ``aggregator_restarts``.  Once the restarts are spent,
or a restart fails, the run degrades.  In ``dashboard`` mode the
restarted aggregator serves the page on the HTTP port its display binds
and prints the new URL, as the JAX one does.  The manifest records
``finalize_sec``: from the last rank's exit to the aggregator's exit,
with the summary written.  On every way out, once the aggregator is gone,
the launcher removes the ranks' shm ring segments (they live outside the
session directory, in ``/dev/shm`` by default) with their descriptors,
and the session's Unix socket, which a killed aggregator leaves behind.
"""

from __future__ import annotations

import os
import shlex
import signal
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from traceml_tpu_torch.launcher import manifest as mf
from traceml_tpu_torch.launcher.process import (
    SupervisedChild,
    python_argv,
    spawn,
    spawn_supervised,
    terminate,
    wait_for_ready_file,
)
from traceml_tpu_torch.runtime.session import generate_session_id
from traceml_tpu_torch.runtime.settings import (
    ENV_AGG_PORT,
    ENV_DISABLE,
    ENV_SCRIPT,
    ENV_SCRIPT_ARGS,
    AggregatorEndpoint,
    TraceMLSettings,
    settings_to_env,
)
from traceml_tpu_torch.sdk import protocol
from traceml_tpu_torch.transport.select import server_transport_config
from traceml_tpu_torch.transport.shm_ring import scan_ring_descriptors

SUPPORTED_MODES = ("cli", "summary", "dashboard")

# bounded aggregator crash-resume: how many times the launcher respawns a
# dead aggregator (on its original port, so the ranks' redials land)
# before the run degrades to untraced
ENV_AGG_MAX_RESTARTS = "TRACEML_AGG_MAX_RESTARTS"
DEFAULT_AGG_MAX_RESTARTS = 3


def _max_restarts() -> int:
    try:
        return int(os.environ.get(ENV_AGG_MAX_RESTARTS, "").strip() or DEFAULT_AGG_MAX_RESTARTS)
    except ValueError:
        return DEFAULT_AGG_MAX_RESTARTS


def resolve_settings(cli: Dict[str, Any]) -> TraceMLSettings:
    """CLI > ``TRACEML_<KEY>`` env > defaults, folded into the settings
    the launcher serializes into the children's environment."""

    def pick(key: str, default: Any = None) -> Any:
        if cli.get(key) is not None:
            return cli[key]
        env_val = os.environ.get(f"TRACEML_{key.upper()}")
        return env_val if env_val is not None else default

    def pick_bool(key: str, default: bool) -> bool:
        v = pick(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("1", "true", "yes", "on")

    run_name = pick("run_name")
    max_steps = pick("trace_max_steps")
    return TraceMLSettings(
        session_id=pick("session_id") or generate_session_id(run_name),
        logs_dir=Path(pick("logs_dir", "./traceml_logs")),
        mode=str(pick("mode", "cli")),
        aggregator=AggregatorEndpoint(
            connect_host=str(pick("aggregator_host", "127.0.0.1")),
            bind_host=str(pick("aggregator_bind_host", "127.0.0.1")),
            port=int(pick("aggregator_port", 0) or 0),
        ),
        sampler_interval_sec=float(pick("sampler_interval_sec", 1.0)),
        trace_max_steps=int(max_steps) if max_steps else None,
        disabled=bool(cli.get("disable", False)),
        disk_backup=pick_bool("disk_backup", False),
        capture_stderr=pick_bool("capture_stderr", True),
        run_name=run_name,
        expected_world_size=int(cli.get("nprocs") or 1),
        finalize_timeout_sec=float(pick("finalize_timeout_sec", 300.0)),
        summary_window_rows=int(pick("summary_window_rows", 10000)),
        transport=str(pick("transport", "auto")),
        transport_compress=str(pick("transport_compress", "auto")),
        shm_ring_bytes=int(pick("shm_ring_bytes", 4194304)),
        shm_dir=pick("shm_dir") or None,
        uds_path=pick("uds_path") or None,
    )


def _cleanup_ring_segments(session_dir: Path) -> None:
    """Remove the ranks' ring segments and their descriptors: nothing else
    would ever reap a file in ``/dev/shm``."""
    for desc in scan_ring_descriptors(session_dir):
        for name in (desc.get("path"), desc.get("_descriptor")):
            if name:
                try:
                    Path(name).unlink()
                except OSError:
                    pass


def _start_aggregator(
    settings: TraceMLSettings, base_env: Dict[str, str], crash_logs: List[str]
) -> Tuple[Optional[SupervisedChild], int]:
    """The aggregator process and the port its ready file names, or
    ``(None, 0)`` when it failed to start."""
    child = spawn_supervised(
        python_argv("traceml_tpu_torch.aggregator.aggregator_main"), label="aggregator", env=base_env
    )
    ready = wait_for_ready_file(settings.session_dir / "aggregator_ready.json", timeout=60.0)
    if ready is not None and child.poll() is None:
        return child, int(ready["port"])
    print("[TraceML] aggregator failed to start; running untraced")
    if child.poll() is not None:
        log = child.write_crash_log(settings.session_dir)
        if log is not None:
            crash_logs.append(str(log))
    terminate(child.proc, grace_sec=2)
    return None, 0


def _restart_aggregator(session_dir: Path, base_env: Dict[str, str], port: int) -> Optional[SupervisedChild]:
    """Respawn the aggregator after a crash, on the port the dead one
    had bound (the ranks keep dialing it; ``SO_REUSEADDR`` makes the
    rebind safe).  The stale ready file goes first: it still names the
    dead pid, and waiting on it would succeed at once.  The new process
    reopens the session's database (re-seeding the dedup maxima) and
    re-seeds the finished ranks and their liveness from
    ``rank_status.json``."""
    ready_path = session_dir / "aggregator_ready.json"
    try:
        ready_path.unlink()
    except OSError:
        pass
    env = dict(base_env)
    env[ENV_AGG_PORT] = str(port)
    # a fault plan's counters are per process: a restarted aggregator
    # would parse the inherited plan anew and a kill9 rule would fire
    # again on the replayed backlog.  The plan described the incarnation
    # it killed; restarts run clean.  Cleared to "", not popped: spawn
    # merges over os.environ, where the launcher's own copy would return.
    env["TRACEML_FAULT_PLAN"] = ""
    child = spawn_supervised(
        python_argv("traceml_tpu_torch.aggregator.aggregator_main"), label="aggregator", env=env
    )
    ready = wait_for_ready_file(ready_path, timeout=20.0)
    if ready is None or child.poll() is not None:
        terminate(child.proc, grace_sec=2)
        return None
    return child


def launch_process(script: str, script_args: Optional[List[str]] = None, **cli: Any) -> int:
    """The ``run`` implementation; returns the exit code."""
    script_path = Path(script).resolve()
    if not script_path.is_file():
        print(f"[TraceML] script not found: {script_path}")
        return 2
    settings = resolve_settings(cli)
    if settings.mode not in SUPPORTED_MODES and not settings.disabled:
        print(f"[TraceML] unknown --mode {settings.mode}; use one of {', '.join(SUPPORTED_MODES)}")
        return 2
    nprocs = int(cli.get("nprocs") or 1)
    session_dir = settings.session_dir
    session_dir.mkdir(parents=True, exist_ok=True)
    mf.write_run_manifest(
        session_dir,
        session_id=settings.session_id,
        script=str(script_path),
        mode=settings.mode,
        world_size=nprocs,
    )
    t0 = time.perf_counter()
    try:
        mf.write_code_manifest(session_dir, script_path)
    except Exception:
        pass  # the scan is best-effort, as in JAX: it never stops a run
    code_manifest_ms = (time.perf_counter() - t0) * 1e3

    if settings.disabled:
        # tracing disabled: run the script untouched
        code = spawn([sys.executable, str(script_path)] + list(script_args or [])).wait()
        mf.update_run_manifest(
            session_dir, status=mf.STATUS_COMPLETED if code == 0 else mf.STATUS_FAILED, exit_code=code,
            code_manifest_ms=code_manifest_ms,
        )
        return code

    base_env = settings_to_env(settings)
    crash_logs: List[str] = []

    # 1. the aggregator
    agg_child, agg_port = _start_aggregator(settings, base_env, crash_logs)
    telemetry_ok = agg_child is not None
    if not telemetry_ok:
        mf.update_run_manifest(
            session_dir, telemetry_status="degraded", **({"crash_logs": crash_logs} if crash_logs else {})
        )

    # 2. the rank processes
    rank_env = dict(base_env)
    rank_env[ENV_AGG_PORT] = str(agg_port)
    if not telemetry_ok:
        rank_env[ENV_DISABLE] = "1"
    rank_env[ENV_SCRIPT] = str(script_path)
    if script_args:
        rank_env[ENV_SCRIPT_ARGS] = " ".join(shlex.quote(a) for a in script_args)
    procs: List[SupervisedChild] = []
    for rank in range(nprocs):
        env = dict(rank_env)
        env.update({
            "RANK": str(rank),
            "WORLD_SIZE": str(nprocs),
            "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(nprocs),
            "NODE_RANK": "0",
        })
        procs.append(spawn_supervised(
            python_argv("traceml_tpu_torch.runtime.executor"), label=f"rank_{rank}", env=env
        ))
    mf.update_run_manifest(session_dir, status=mf.STATUS_RUNNING, code_manifest_ms=code_manifest_ms)

    # SIGTERM to the launcher tears the tree down like Ctrl-C does
    # (ranks terminated, aggregator finalized, manifest stamped)
    def _sigterm(_signum, _frame):
        raise KeyboardInterrupt

    try:
        old_sigterm = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        old_sigterm = None  # not the main thread: the embedder owns signals

    # 3. supervise
    exit_code = 0
    stopped_by_us: set = set()  # pids WE terminated: victims, not crashes
    ranks_done_at: Optional[float] = None
    agg_restarts = 0
    agg_max_restarts = _max_restarts()
    try:
        while True:
            alive = [p for p in procs if p.poll() is None]
            for p in procs:
                if p.poll() not in (0, None) and p.proc.pid not in stopped_by_us:
                    if exit_code == 0:
                        exit_code = p.returncode
                    log = p.write_crash_log(session_dir)
                    if log is not None and str(log) not in crash_logs:
                        print(f"[TraceML] {p.label} {p.describe_exit()}; stderr tail: {log}")
                        crash_logs.append(str(log))
            if agg_child is not None and agg_child.poll() is not None:
                # the aggregator died mid-run: bounded restarts on the
                # same port (the ranks spool and redial), then degrade
                log = agg_child.write_crash_log(session_dir)
                if log is not None:
                    crash_logs.append(str(log))
                agg_child = None
                if agg_restarts < agg_max_restarts:
                    agg_restarts += 1
                    print(f"[TraceML] aggregator exited mid-run; restarting "
                          f"({agg_restarts}/{agg_max_restarts}) on port {agg_port}", flush=True)
                    agg_child = _restart_aggregator(session_dir, base_env, agg_port)
                if agg_child is not None:
                    mf.update_run_manifest(session_dir, telemetry_status="restarted",
                                           aggregator_restarts=agg_restarts)
                else:
                    telemetry_ok = False
                    print("[TraceML] aggregator exited early; telemetry degraded")
                    mf.update_run_manifest(session_dir, telemetry_status="degraded")
            if not alive:
                ranks_done_at = time.monotonic()
                break
            if exit_code != 0:
                # a rank failed: stop the rest
                for p in alive:
                    stopped_by_us.add(p.proc.pid)
                    terminate(p.proc)
                ranks_done_at = time.monotonic()
                break
            time.sleep(0.1)
    except KeyboardInterrupt:
        exit_code = 130
        for p in procs:
            stopped_by_us.add(p.proc.pid)
            terminate(p.proc)
    finally:
        # our SIGTERM handler stays until the manifest is stamped: a
        # second signal during finalization cuts it short instead of
        # killing the launcher with status "running"
        try:
            if agg_child is not None:
                # graceful stop: SIGTERM → the aggregator finalizes
                try:
                    terminate(agg_child.proc, grace_sec=max(10.0, settings.finalize_timeout_sec))
                except KeyboardInterrupt:
                    exit_code = exit_code or 130
                    terminate(agg_child.proc, grace_sec=2.0)
                if ranks_done_at is not None:
                    mf.update_run_manifest(session_dir, finalize_sec=time.monotonic() - ranks_done_at)
            if crash_logs:
                mf.update_run_manifest(session_dir, crash_logs=crash_logs)
            _cleanup_ring_segments(session_dir)
            uds_path = server_transport_config(settings)["uds_path"]
            if uds_path:
                try:
                    os.unlink(uds_path)  # a stopped aggregator removed it; a killed one did not
                except OSError:
                    pass
        finally:
            if old_sigterm is not None:
                signal.signal(signal.SIGTERM, old_sigterm)

    status = mf.STATUS_COMPLETED if exit_code == 0 else mf.STATUS_FAILED
    mf.update_run_manifest(session_dir, status=status, exit_code=exit_code)

    # 4. summary-mode enforcement: the verdict on stdout (in cli mode the
    #    display's last frame is on stdout instead, as in JAX)
    if telemetry_ok and settings.mode == "summary":
        summary_path = protocol.get_final_summary_json_path(session_dir)
        if not summary_path.exists():
            print(f"[TraceML] WARNING: expected summary missing: {summary_path}")
            mf.update_run_manifest(session_dir, telemetry_status="degraded")
        else:
            txt = protocol.get_final_summary_txt_path(session_dir)
            if txt.exists():
                print(txt.read_text())
            print(f"[TraceML] final summary: {summary_path}")
    return exit_code
