"""Step-time diagnosis: the port against the JAX package on the same rows.

Numpy-made rank rows (one scenario per case) go through
``traceml_tpu.diagnostics.step_time.api.diagnose_rank_rows`` and the port's
counterpart.  Kinds, severities, ranks and evidence must be equal, and
scores within 1e-9; actions and summaries equal once the JAX texts are put
through the advice table of ``test_torch_advice.py`` (the port names
PyTorch/CUDA remedies).
"""

import numpy as np
import pytest

from tests.test_torch_advice import ACTIONS, port_advice, port_summary
from traceml_tpu.diagnostics.step_time.api import diagnose_rank_rows as jax_diagnose
from traceml_tpu_torch.diagnostics.step_time.api import diagnose_rank_rows
from traceml_tpu_torch.utils import timing as T


def _rows(rng, n_steps, *, step_ms, input_ms, compute_ms, compute_device=None,
          clock="device", noise=0.5):
    """Rows of one rank.  ``compute_device`` (default ``compute_ms``) is the
    compute phase's device time; the envelope's device time is the step."""
    rows = []
    for i in range(n_steps):
        jitter = rng.normal(0.0, noise, 3)
        step = max(1.0, step_ms + jitter[0])
        inp = max(0.0, input_ms + jitter[1])
        comp = max(0.0, compute_ms + jitter[2])
        dev = comp if compute_device is None else max(0.0, compute_device + jitter[2])
        rows.append({
            "step": i + 1,
            "timestamp": 1000.0 + i,
            "clock": clock,
            "events": {
                T.STEP_TIME: {"cpu_ms": step, "device_ms": step, "count": 1},
                T.DATALOADER_NEXT: {"cpu_ms": inp, "device_ms": None, "count": 1},
                T.H2D_TIME: {"cpu_ms": 0.05, "device_ms": 0.02, "count": 1},
                T.COMPUTE_TIME: {"cpu_ms": comp, "device_ms": dev, "count": 1},
            },
        })
    return rows


def _healthy(rng):
    return {0: _rows(rng, 60, step_ms=100.0, input_ms=2.0, compute_ms=95.0)}


def _input_bound(rng):
    return {0: _rows(rng, 60, step_ms=100.0, input_ms=55.0, compute_ms=43.0)}


def _compute_straggler(rng):
    rows = {r: _rows(rng, 60, step_ms=100.0, input_ms=3.0, compute_ms=94.0) for r in range(4)}
    rows[2] = _rows(rng, 60, step_ms=160.0, input_ms=3.0, compute_ms=154.0)
    return rows


def _low_occupancy(rng):
    # host-clock rows (the window reads host times) whose device spans
    # cover under a tenth of the step: the device idles
    return {0: _rows(rng, 60, step_ms=100.0, input_ms=4.0, compute_ms=90.0,
                     compute_device=8.0, clock="host")}


def _too_few_steps(rng):
    return {0: _rows(rng, 10, step_ms=100.0, input_ms=60.0, compute_ms=38.0)}


SCENARIOS = {
    "healthy": (_healthy, "COMPUTE_BOUND"),
    "input_bound": (_input_bound, "INPUT_BOUND"),
    "compute_straggler": (_compute_straggler, "COMPUTE_STRAGGLER"),
    "low_occupancy": (_low_occupancy, "LOW_DEVICE_UTILIZATION"),
    "too_few_steps": (_too_few_steps, "INSUFFICIENT_STEP_TIME_DATA"),
}


@pytest.mark.parametrize("mode", ["summary", "live"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_diagnosis_equals_jax(scenario, mode):
    build, expected = SCENARIOS[scenario]
    rank_rows = build(np.random.default_rng(sorted(SCENARIOS).index(scenario)))
    ours = diagnose_rank_rows(rank_rows, mode=mode)
    theirs = jax_diagnose(rank_rows, mode=mode)
    if mode == "summary":
        assert ours.diagnosis.kind == expected
    assert [i.kind for i in ours.issues] == [i.kind for i in theirs.issues]
    for a, b in zip(ours.issues, theirs.issues):
        assert (a.severity, a.status, a.phase, a.ranks, a.metric) == (
            b.severity, b.status, b.phase, b.ranks, b.metric)
        assert a.summary == port_summary(b.summary)
        assert a.action == ACTIONS.get(b.action, b.action)
        assert a.evidence == b.evidence
        assert a.score == pytest.approx(b.score, abs=1e-9)
        assert (a.confidence is None) == (b.confidence is None)
        if a.confidence is not None:
            assert a.confidence == pytest.approx(b.confidence, abs=1e-9)
    assert ours.to_dict() == port_advice(theirs.to_dict())
