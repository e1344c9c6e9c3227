"""Adaptive tracer-overhead governor.

Counterpart of ``traceml_tpu/utils/overhead_governor.py``.  It measures
the tracer's own per-marker cost (the EMA of ``event.query()`` probes)
against the observed step duration and adapts the device-marker sampling
stride so tracer-attributable time stays under a budget (default 1%,
``TRACEML_OVERHEAD_BUDGET``):

* stride 1 (every step) whenever the budget affords it;
* stride N>1 for tiny steps: CUDA markers are recorded every Nth step
  only.  Unsampled steps still get full host envelopes and phase
  regions, so the window degrades to the host clock for them;
* inline sweeps (main-thread ``query()`` at step boundaries) are turned
  off when a single probe costs more than ``inline_probe_ceiling``.

The port feeds the probe EMA through ``observe_probe_min``: the least of
the last ``_PROBE_WINDOW`` poll batches' minima, not each batch's.  On
an H100 a batch's minimum is 2-4 µs at the median, but about one in a
hundred is over 100 µs and a few are milliseconds (the poller lost the
GIL or the driver mid-poll; ``dev/measure_main_path.py``'s governor
trace).  With one marker pending a batch's minimum is its only poll, so
one such sample lifted the EMA past 1% of a 20 ms or 130 ms step and the
governor dropped the device markers of the next steps.  A runtime whose
every probe is slow still moves the windowed minimum within a step or
two.

On CUDA a marker's stamp is the event's own GPU timestamp, so the poll
cadence bounds how soon a row is emitted, not how exact it is.
"""

from __future__ import annotations

import collections
import os

_DEF_BUDGET = 0.01           # tracer share of wall clock
_DEF_INLINE_CEILING = 100e-6  # s; inline sweeps off above this per-probe cost
_FIXED_MARKER_COST = 15e-6   # s; host-side flatten+submit+wake per marker
_PROBES_PER_MARKER = 3.0     # inline sweep + resolver polls, typical
_EMA_ALPHA = 0.2
_MAX_STRIDE = 256
# per-probe samples above this are either scheduling artifacts (a
# descheduled poller measuring its own GIL starvation) or a runtime
# whose probes are catastrophically slow.  CLAMPED, not ignored: the
# two cases are indistinguishable from one sample, and the safe failure
# direction is over-throttling (coarser observation) — discarding would
# leave the governor blind to a genuinely slow runtime, freezing the
# stride/inline policy in its maximum-overhead configuration.  A
# clamped 20 ms sample already drives every knob to full backoff.
_PROBE_SAMPLE_CEILING = 20e-3
_MAX_RESOLVER_DELAY = 0.1  # cap: stamp quality must bound EMA poisoning
_PROBE_WINDOW = 16  # poll batches whose least minimum is one EMA sample


def _env_budget() -> float:
    try:
        return float(os.environ.get("TRACEML_OVERHEAD_BUDGET", _DEF_BUDGET))
    except ValueError:
        return _DEF_BUDGET


class OverheadGovernor:
    """Per-process adaptive sampling policy for device markers."""

    def __init__(
        self,
        budget: float | None = None,
        inline_probe_ceiling: float = _DEF_INLINE_CEILING,
    ) -> None:
        if budget is None:
            budget = _env_budget()
        self.budget = max(1e-4, float(budget))
        self.inline_probe_ceiling = float(inline_probe_ceiling)
        # optimistic prior: local-backend probe cost.  The first sweeps
        # correct it within a handful of steps.
        self.probe_cost_ema = 2e-6
        self.step_ema: float | None = None
        # lifetime (dispatch → readiness) of step-end markers: the
        # resolver's sleep-to-expected-completion schedule keys off
        # THIS, not the step envelope — the envelope includes
        # pre-dispatch host time (input wait), which a marker's device
        # work does not (input-straggler regression: sleeping to 85% of
        # a 242 ms envelope stamped a 60 ms compute at ~206 ms)
        self.marker_lifetime_ema: float | None = None
        self._tick = 0
        self._stride = 1
        self._obs = 0
        self._recent_probes: collections.deque = collections.deque(maxlen=_PROBE_WINDOW)

    # -- observations (any thread; lock-free on purpose) ---------------
    # EMA updates race benignly under the GIL (a lost update nudges the
    # EMA by one sample), and the hot path runs once per training step —
    # a lock here would cost more than the statistic is worth.
    def observe_probe(self, total_s: float, n_probes: int) -> None:
        """Feed the measured duration of a batch of is_ready() probes.

        Callers should pass the MINIMUM per-poll duration they saw in a
        batch (robust to a poller thread being descheduled mid-poll);
        samples above the artifact ceiling are CLAMPED to it before
        entering the EMA (see _PROBE_SAMPLE_CEILING — a descheduling
        artifact should register as "expensive", not be unboundedly
        believed)."""
        if n_probes <= 0 or total_s < 0:
            return
        per = min(total_s / n_probes, _PROBE_SAMPLE_CEILING)
        self.probe_cost_ema += _EMA_ALPHA * (per - self.probe_cost_ema)

    def observe_probe_min(self, best_s: float) -> None:
        """Feed one poll batch's minimum probe duration; the EMA takes the
        least of the last ``_PROBE_WINDOW`` of them (module docstring).
        Appends from two threads race benignly, like the EMA's."""
        if best_s < 0:
            return
        recent = self._recent_probes
        recent.append(best_s)
        self.observe_probe(min(tuple(recent)), 1)

    def observe_marker_lifetime(self, dur_s: float) -> None:
        """Resolution time of a step-end marker (non-late stamps only —
        a shutdown drain's stamp says nothing about device duration).

        Outlier-gated like observe_probe: a single stalled step
        (blocking checkpoint, retrace) can resolve at seconds; feeding
        it would push the resolver's sleep-to-completion schedule past
        every subsequent step's true readiness, and — because the first
        poll then never lands before 0.85×EMA — the inflated EMA would
        sustain itself.  A lifetime beyond 2× the step EMA is a stall,
        not the steady state."""
        if dur_s <= 0:
            return
        se = self.step_ema
        if se is not None and dur_s > 2.0 * se:
            return
        le = self.marker_lifetime_ema
        self.marker_lifetime_ema = (
            dur_s if le is None else le + _EMA_ALPHA * (dur_s - le)
        )

    def observe_step(self, dur_s: float) -> None:
        if dur_s <= 0:
            return
        se = self.step_ema
        self.step_ema = dur_s if se is None else se + _EMA_ALPHA * (dur_s - se)
        # stride recompute is decimated: the EMAs move slowly and the
        # policy only needs to track them at coarse cadence
        self._obs += 1
        if self._obs % 8 == 0:
            self._stride = self._compute_stride()

    # -- policy --------------------------------------------------------
    def _compute_stride(self) -> int:
        step = self.step_ema
        if step is None or step <= 0:
            return 1
        per_marker = _FIXED_MARKER_COST + _PROBES_PER_MARKER * self.probe_cost_ema
        affordable = self.budget * step
        if per_marker <= affordable:
            return 1
        stride = int(per_marker / affordable) + 1
        return min(_MAX_STRIDE, stride)

    @property
    def marker_stride(self) -> int:
        return self._stride

    def begin_step(self) -> bool:
        """Advance the per-step tick; True ⇒ sample device markers this
        step.  Called once per outermost trace_step."""
        self._tick += 1
        s = self._stride
        return s <= 1 or (self._tick % s) == 0

    def allow_inline_sweep(self) -> bool:
        return self.probe_cost_ema <= self.inline_probe_ceiling

    def resolver_min_delay(self) -> float:
        """Floor for the background resolver's poll cadence: keep the
        resolver thread itself under ~budget of one core by spacing
        polls ≥ probe_cost/budget apart (a 0.3 ms RPC probe at 1%
        budget → ≥30 ms cadence; a 2 µs local probe → no effect).
        Capped so a transiently poisoned EMA cannot collapse stamp
        quality below one poll per _MAX_RESOLVER_DELAY."""
        return min(_MAX_RESOLVER_DELAY, self.probe_cost_ema / self.budget)


_governor = OverheadGovernor()


def get_governor() -> OverheadGovernor:
    return _governor


def reset_governor_for_tests(**kwargs) -> OverheadGovernor:
    global _governor
    _governor = OverheadGovernor(**kwargs)
    return _governor
