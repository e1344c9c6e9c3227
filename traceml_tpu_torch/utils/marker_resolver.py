"""Background device-marker resolver.

Counterpart of ``traceml_tpu/utils/marker_resolver.py``, with CUDA event
markers as handles.  This daemon polls pending
:class:`~traceml_tpu_torch.utils.timing.DeviceMarker`s (``event.query()``,
non-blocking, no device sync) while work is in flight and parks when
idle.  A CUDA marker is stamped with its event's own GPU timestamp, so the
poll cadence decides how soon a step row can be emitted, not its accuracy.
``stop()`` joins the thread.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.overhead_governor import get_governor
from traceml_tpu_torch.utils.timing import DeviceMarker

_DEFAULT_INTERVAL = 0.002  # 2 ms poll while young markers are pending
_IDLE_TIMEOUT = 0.25  # park after this long with nothing pending
_FINE_WINDOW_S = 0.020  # markers younger than this get the fine cadence
_MAX_BACKOFF_S = 0.025  # cadence ceiling for long-running markers


def _poll_batch(pending: List[DeviceMarker]) -> tuple:
    """Poll a batch of markers and feed the governor ONE probe-cost
    sample: the batch MINIMUM per-poll duration — robust to the polling
    thread being descheduled mid-poll (a starved poller measures its own
    starvation, not the probe); the governor takes the least of its last
    few such minima (``observe_probe_min``), since with one marker
    pending a batch has one poll to take the minimum of.  No-op polls of
    already-resolved markers and exception-path polls are excluded from
    the sample.  Returns (#resolved-by-this-batch, min_probe_dt | None).
    Shared by sweep_inline (main thread) and the resolver loop."""
    resolved = 0
    best = None
    for m in pending:
        was_resolved = m.resolved
        t0 = time.perf_counter()
        try:
            if m.poll():
                resolved += 1
        except Exception:
            continue  # poll() fails open; a raise says nothing of cost
        if was_resolved:
            continue  # fast-path no-op poll: not a probe-cost sample
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best = dt
    # this is THE signal that detects expensive probes and turns inline
    # sweeping off / stretches the marker stride
    if best is not None:
        get_governor().observe_probe_min(best)
    return resolved, best


#: consecutive inline-sweep wins before step-end submits go quiet
_QUIET_AFTER_WINS = 3


class MarkerResolver:
    def __init__(self, poll_interval: float = _DEFAULT_INTERVAL) -> None:
        self._interval = poll_interval
        self._pending: List[DeviceMarker] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Adaptive quiet mode: in a bracketed hot loop, sweep_inline()
        # at each step boundary stamps the step-end marker before this
        # thread ever touches it — so waking the thread per submit only
        # buys two context-switch preemptions of the training thread per
        # step (measured ~2-3% of a 12 ms step on a 1-core host, the
        # short-step bench lane).  After a few consecutive inline wins,
        # step-end submits stop waking the thread; the idle-timeout scan
        # (≤ _IDLE_TIMEOUT) remains the backstop for a loop that stalls,
        # and any marker the THREAD ends up resolving decays the counter
        # so non-bracketed loops get the eager wake back immediately.
        self._inline_wins = 0

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="traceml-marker-resolver", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
        self._thread = None

    def submit(self, marker: DeviceMarker) -> None:
        if marker.resolved or marker.submitted:
            return
        marker.submitted = True
        with self._lock:
            self._pending.append(marker)
        quiet = (
            getattr(marker, "step_end_hint", False)
            and self._inline_wins >= _QUIET_AFTER_WINS
        )
        if not quiet:
            self._wake.set()
        # Lazy-start so merely importing the sdk never spawns threads.
        if self._thread is None or not self._thread.is_alive():
            self.start()

    def sweep_inline(self, max_n: int = 64) -> int:
        """Opportunistic poll on the CALLER thread; returns #resolved.

        Called at step boundaries (trace_step.__enter__): in a hot
        training loop the GIL can starve the resolver thread for tens of
        ms, so the main thread stamps the previous step's markers itself
        — the stamp error is then bounded by one inter-step gap instead
        of the resolver's scheduling luck.  Cost: a handful of local
        ``is_ready()`` calls, microseconds.
        """
        if not self._pending:  # tracelint: unguarded(emptiness probe on the hot step path; a racing append is swept next step)
            return 0
        # (unlocked fast path: hot loops with the governor subsampling
        # usually have no pending markers)
        with self._lock:
            pending = list(self._pending[:max_n])
        if not pending:
            return 0
        resolved, _ = _poll_batch(pending)
        if resolved:
            self._inline_wins = min(self._inline_wins + resolved, 50)
            with self._lock:
                self._pending = [m for m in self._pending if not m.resolved]
        return resolved

    def _delay_for(self, age_s: float, step_end_hint: bool = False) -> float:
        """Per-marker poll schedule.

        Every resolver wakeup PREEMPTS the training thread on a
        saturated host (context switch + cache pollution — measured
        ~2-4% of a 190 ms step at a 30-wakeup/step schedule on a
        1-core host), so wakeups are spent where a stamp can land:

        * **step-end markers** (``step_end_hint``: the fused
          compute/envelope marker) in the long-lifetime regime
          (governor's marker-lifetime EMA ≥ 20 ms — the observed
          dispatch→readiness duration of previous step-end markers, NOT
          the step envelope, which also contains pre-dispatch host
          time): sleep straight to ~85% of the expected lifetime, then
          poll at 2% of it — ≤ ~8 wakeups/step, relative stamp error
          ≤ 2%, and in bracketed loops sweep_inline() at the next step
          boundary stamps first anyway;
        * **intra-step phase markers** (h2d, collective, user regions)
          and the short-step/unknown regime: fine cadence — poll every
          2 ms while young, back off to 10% of age (relative error
          ≤10%, absolute ≤25 ms).  Phase markers resolve quickly, so
          the fine window costs a handful of wakeups, and delaying them
          to step end would collapse the intra-step device edges
          (regression caught by the straggler scenario E2Es).
        """
        if step_end_hint:
            ema = get_governor().marker_lifetime_ema
            if ema is not None:
                # sleep straight toward the expected completion window at
                # ANY lifetime scale — short steps included (a ~12 ms step
                # fine-polled at 2 ms costs ~6 main-thread preemptions per
                # step on a 1-core host, the dominant tracer cost in the
                # short-step bench lane); in bracketed loops
                # sweep_inline() at the next boundary stamps first anyway
                if age_s < 0.85 * ema:
                    return max(self._interval, 0.85 * ema - age_s)
                # capped like the non-hint path: a marker wedged behind a
                # stall (blocking checkpoint, retrace) must not push its
                # own poll cadence — and hence its stamp error —
                # unboundedly (the stalled lifetime is EMA-rejected, so
                # the schedule cannot self-correct mid-stall)
                return min(
                    _MAX_BACKOFF_S,
                    max(self._interval, 0.02 * ema, 0.1 * (age_s - ema)),
                )
        if age_s < _FINE_WINDOW_S:
            return self._interval
        return min(_MAX_BACKOFF_S, max(self._interval, 0.1 * age_s))

    def _run(self) -> None:
        import time as _time

        try:
            while not self._stop.is_set():
                with self._lock:
                    pending = list(self._pending)
                if not pending:
                    fired = self._wake.wait(timeout=_IDLE_TIMEOUT)
                    if fired:
                        self._wake.clear()
                    continue
                thread_resolved, _ = _poll_batch(pending)
                if thread_resolved:
                    # inline sweeping is NOT keeping up (unbracketed
                    # loop, stall) — restore eager wakes
                    self._inline_wins = max(
                        0, self._inline_wins - 2 * thread_resolved
                    )
                now = _time.perf_counter()
                with self._lock:
                    # Identity-based prune: concurrent submits and
                    # sweep_inline() prunes both mutate _pending, so a
                    # slice-by-stale-length merge would drop markers.
                    self._pending = [m for m in self._pending if not m.resolved]
                    unresolved = list(self._pending)
                if unresolved:
                    delay = min(
                        self._delay_for(
                            now - m.dispatched_at,
                            getattr(m, "step_end_hint", False),
                        )
                        for m in unresolved
                    )
                else:
                    delay = self._interval
                # expensive-probe floor: keep this thread's probe duty
                # cycle within the overhead budget
                delay = max(delay, get_governor().resolver_min_delay())
                # waiting on _wake (not _stop) lets a fresh submit
                # re-tighten the cadence mid-backoff
                fired = self._wake.wait(timeout=delay)
                if fired:
                    self._wake.clear()
        except Exception as exc:  # pragma: no cover
            get_error_log().error("marker resolver crashed", exc)


_resolver = MarkerResolver()


def get_marker_resolver() -> MarkerResolver:
    return _resolver
