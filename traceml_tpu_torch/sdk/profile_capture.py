"""On-demand ``torch.profiler`` capture: a trace from a RUNNING job.

Counterpart of ``traceml_tpu/sdk/profile_capture.py``, with
``torch.profiler`` in place of the XLA profiler.  The file protocol is
the JAX package's, byte for byte, so either package's operator side can
talk to the other's job: an operator (or ``python -m traceml_tpu_torch
profile <session_dir>``) drops ``control/profile_request.json``; each
rank's :class:`ProfileCaptureService`, driven by the SDK's per-step flush
callback on the training thread, notices it, profiles the next N steps
(``torch.profiler.profile`` with CPU activity, and CUDA activity when the
trace runs on a card) and exports a Chrome trace to
``<session>/profiles/<stamp>/rank_<r>/trace.json``; the primary rank
writes ``control/profile_response.json``.

* **Fail-open**: a profiler that fails to start, stop or export answers
  with an error response; nothing raises into training.
* **Cheap when idle**: one ``os.stat`` of the request every
  ``check_every`` steps; no thread.
* **Step-aligned**: the capture starts at a step's flush and stops N
  flushes later, so the trace holds N whole steps.  The export runs on
  the training thread at the stop edge: that step waits for it.
* **Multi-rank**: each rank profiles its own process; the request may
  name ``ranks``.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

from traceml_tpu_torch.sdk.protocol import control_dir
from traceml_tpu_torch.utils.atomic_io import atomic_write_json, read_json
from traceml_tpu_torch.utils.error_log import get_error_log

PROFILE_REQUEST_FILE = "profile_request.json"
PROFILE_RESPONSE_FILE = "profile_response.json"
TRACE_FILE = "trace.json"
_DEFAULT_STEPS = 5
_MAX_STEPS = 200  # bound the artifact even against a typo'd request


class TorchProfiler:
    """``start_trace(dir)`` / ``stop_trace()`` over ``torch.profiler``, the
    two calls the service makes (the XLA profiler's shape).  The stop
    exports the Chrome trace into the started directory."""

    def __init__(self) -> None:
        self._prof: Any = None
        self._dir: Optional[Path] = None

    def start_trace(self, trace_dir: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        self._prof, self._dir = prof, Path(trace_dir)

    def stop_trace(self) -> None:
        prof, trace_dir = self._prof, self._dir
        self._prof = self._dir = None
        if prof is None:
            raise RuntimeError("no profile in progress")
        prof.stop()
        prof.export_chrome_trace(str(trace_dir / TRACE_FILE))


#: the profiler the services drive (tests put a stand-in here)
profiler: Any = TorchProfiler()


def profile_request_path(session_dir: Path) -> Path:
    return control_dir(session_dir) / PROFILE_REQUEST_FILE


def profile_response_path(session_dir: Path) -> Path:
    return control_dir(session_dir) / PROFILE_RESPONSE_FILE


def write_profile_request(session_dir: Path, steps: int = _DEFAULT_STEPS, ranks=None) -> float:
    """Operator side: ask the running job for a trace.  Returns the
    request's timestamp (the key of :func:`read_profile_response`).

    ``ranks`` is None (all ranks) or a NON-EMPTY list of rank ids: an
    empty list would name no captor, and the request could only time
    out, so it is refused here."""
    if ranks is not None:
        ranks = [int(r) for r in ranks]
        if not ranks:
            raise ValueError("ranks must be None (all ranks) or a non-empty list")
    ts = time.time()
    atomic_write_json(
        profile_request_path(session_dir),
        {"requested_at": ts, "steps": int(steps), "ranks": ranks},
    )
    return ts


def read_profile_response(session_dir: Path, for_request: Optional[float] = None) -> Optional[Dict[str, Any]]:
    """The response to ``for_request`` (the timestamp of
    :func:`write_profile_request`, echoed verbatim by the service: an
    exact match, so neither clock skew nor a previous response can answer
    a new request), or any response when ``for_request`` is None."""
    resp = read_json(profile_response_path(session_dir))
    if not resp:
        return None
    if for_request is not None and resp.get("requested_at") != for_request:
        return None
    return resp


class ProfileCaptureService:
    """A rank's request watcher and capture state machine.

    Wire it up by appending :meth:`on_step_flushed` to
    ``TraceState.on_step_flushed`` (the runtime does, in ``start()``).
    All work happens on the training thread at step flushes: starting or
    stopping the profiler from another thread would tear a step.
    """

    def __init__(self, session_dir: Path, rank: int = 0, check_every: int = 5,
                 world_size: Optional[int] = None) -> None:
        self._session_dir = Path(session_dir)
        self._rank = int(rank)
        self._check_every = max(1, int(check_every))
        self._world_size = int(world_size) if world_size else None
        self._flushes = 0
        self._handled_mtime = 0.0
        self._remaining = 0
        self._trace_dir: Optional[Path] = None
        self._request: Dict[str, Any] = {}
        self._steps = 0
        self._primary = 0

    # -- the per-step hook (training thread) ---------------------------
    def on_step_flushed(self, step: int) -> None:
        try:
            if self._remaining > 0:
                self._remaining -= 1
                if self._remaining == 0:
                    self._finish(ok=True)
                return
            self._flushes += 1
            if self._flushes % self._check_every:
                return
            self._maybe_start()
        except Exception as exc:  # never raise into the training loop
            get_error_log().warning("profile capture hook failed", exc)
            self._remaining = 0

    # -- internals -----------------------------------------------------
    def _handled_marker_path(self) -> Path:
        return control_dir(self._session_dir) / f".profile_handled_rank_{self._rank}.json"

    def _maybe_start(self) -> None:
        req_path = profile_request_path(self._session_dir)
        try:
            mtime = os.stat(req_path).st_mtime
        except OSError:
            return
        if mtime <= self._handled_mtime:
            return
        self._handled_mtime = mtime
        req = read_json(req_path) or {}
        # a per-rank handled marker: a request this rank handled in an
        # earlier life of the session dir (restart, resume) must not
        # replay as an unsolicited capture.  Per rank, not the shared
        # response: the primary may answer before a slower rank starts.
        # An unhandled request is honoured whatever its age: the
        # operator may file it before the first step.
        marker = self._handled_marker_path()
        prior = read_json(marker)
        if prior is not None and prior.get("requested_at") == req.get("requested_at"):
            return
        try:
            atomic_write_json(marker, {"requested_at": req.get("requested_at")})
        except Exception:
            pass  # at worst a restart replays one capture
        steps = min(_MAX_STEPS, max(1, int(req.get("steps") or _DEFAULT_STEPS)))
        ranks = req.get("ranks")
        if ranks is not None:
            try:
                ranks = [int(r) for r in ranks]
            except (TypeError, ValueError):
                ranks = []
            live = [r for r in ranks if self._world_size is None or 0 <= r < self._world_size]
            if not live:
                # no rank will capture it: rank 0 answers with an error
                # rather than leave the operator to time out
                if self._rank == 0:
                    self._respond(
                        ok=False,
                        error=f"ranks {ranks!r} names no live rank (world_size={self._world_size})",
                        trace_dir=None, req=req, steps=steps, primary=0,
                    )
                return
            if self._rank not in live:
                return
            self._primary = min(live)
        else:
            self._primary = 0
        # the stamp comes from the REQUEST's time, not each rank's clock:
        # ranks straddling a second would scatter one capture over two dirs
        req_ts = float(req.get("requested_at") or time.time())
        stamp = time.strftime("%Y%m%d_%H%M%S", time.localtime(req_ts))
        trace_dir = self._session_dir / "profiles" / stamp / f"rank_{self._rank}"
        try:
            trace_dir.mkdir(parents=True, exist_ok=True)
            profiler.start_trace(str(trace_dir))
        except Exception as exc:
            get_error_log().warning("profile capture start failed", exc)
            self._respond(ok=False, error=repr(exc), trace_dir=None, req=req, steps=steps,
                          primary=self._primary)
            return
        self._request = req
        self._trace_dir = trace_dir
        self._remaining = steps
        self._steps = steps

    def _finish(self, ok: bool, truncated: bool = False) -> None:
        error = None
        try:
            profiler.stop_trace()
        except Exception as exc:
            get_error_log().warning("profile capture stop failed", exc)
            ok, error = False, f"stop_trace failed: {exc!r}"
        self._respond(ok=ok, error=error, trace_dir=self._trace_dir, req=self._request,
                      truncated=truncated, steps=self._steps, primary=self._primary)
        self._trace_dir = None
        self._request = {}

    def close(self) -> None:
        """Shutdown (the runtime's stop): finish a capture in flight, so
        the profiler never runs through teardown and the operator gets an
        answer (a truncated trace of the steps that ran, not a timeout)."""
        if self._remaining > 0:
            self._remaining = 0
            self._finish(ok=True, truncated=True)

    def _respond(self, ok, error, trace_dir, req, truncated=False, steps: Optional[int] = None,
                 primary: int = 0) -> None:
        # one response a request, by the primary PARTICIPATING rank (the
        # caller takes it from the live ranks, so a request naming dead
        # ranks still gets its answer)
        if self._rank != primary:
            return
        try:
            atomic_write_json(
                profile_response_path(self._session_dir),
                {
                    # echoed verbatim: the operator's exact-match key
                    "requested_at": req.get("requested_at"),
                    "completed_at": time.time(),
                    "ok": bool(ok),
                    # the CLAMPED step count captured, not the request's
                    "steps": steps if steps is not None else req.get("steps"),
                    "error": error,
                    "trace_dir": str(trace_dir.parent) if trace_dir else None,
                    "truncated": bool(truncated),
                    "rank": self._rank,
                },
            )
        except Exception as exc:
            get_error_log().warning("profile capture respond failed", exc)


def request_profile_and_wait(session_dir: Path, steps: int = _DEFAULT_STEPS, timeout: float = 60.0,
                             poll_interval: float = 0.25, ranks=None) -> Optional[Dict[str, Any]]:
    """Operator side: request, then poll until the job answers (the job
    must be stepping: the capture engages at step flushes)."""
    ts = write_profile_request(session_dir, steps=steps, ranks=ranks)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        resp = read_profile_response(session_dir, for_request=ts)
        if resp is not None:
            return resp
        time.sleep(poll_interval)
    return None
