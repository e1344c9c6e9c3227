"""Rank liveness: the port's tracker, rules and heartbeat against the JAX
package's.

* ``RankLivenessTracker``: the same observe / mark-finished sequence on
  a fake clock (explicit timestamps) through both trackers; every state
  and every snapshot equal, the thresholds from the same environment
  variables, and ``seed`` restoring the same states.
* ``diagnose_rank_status``: the JAX test's snapshots
  (``tests/aggregator/test_liveness.py``: healthy, lost, died
  mid-stride, never seen, stale world, missing snapshot) through both;
  every issue's kind, severity, metric, score, ranks, confidence and
  evidence equal, the actions compared through the JAX → port table of
  ``tests/test_torch_advice.py``.
* The sender's heartbeat interval: ``TRACEML_HEARTBEAT_INTERVAL_SEC``
  (default 3.0, floor 0.25) read by the port's publisher and by the JAX
  runtime; on the same fake clock both send the same heartbeats on the
  same idle ticks.
"""

import math
from unittest import mock

import numpy as np
import pytest

from tests.test_torch_advice import port_advice
from traceml_tpu.aggregator import liveness as jax_liveness
from traceml_tpu.diagnostics.liveness import diagnose_rank_status as jax_diagnose
from traceml_tpu_torch.aggregator import liveness
from traceml_tpu_torch.diagnostics.liveness import diagnose_rank_status


def _feed(tracker, ops):
    for op, rank, ts, progress in ops:
        if op == "finish":
            tracker.mark_finished(rank, ts=ts)
        else:
            tracker.observe(rank, ts=ts, progress=progress)


def _ops(seed):
    """A seeded sequence over 5 ranks: heartbeats, step envelopes (with
    late, reordered timestamps), finish markers, some ranks going silent."""
    rng = np.random.default_rng(seed)
    ops, t = [], 1000.0
    silent_from = {r: float(rng.uniform(1000.0, 1100.0)) for r in range(5)}
    for _ in range(300):
        t += float(rng.uniform(0.0, 0.8))
        rank = int(rng.integers(0, 5))
        if t > silent_from[rank] and rank % 2:
            continue
        ts = t - float(rng.uniform(0.0, 2.0)) if rng.random() < 0.1 else t
        kind = rng.choice(["seen", "progress", "finish"], p=[0.45, 0.5, 0.05])
        ops.append(("finish" if kind == "finish" else "observe", rank, ts, kind == "progress"))
    return ops, t


@pytest.mark.parametrize("seed", range(6))
def test_tracker_snapshots_equal_jax(seed):
    ops, end = _ops(seed)
    ours = liveness.RankLivenessTracker(stale_after=10.0, lost_after=30.0)
    theirs = jax_liveness.RankLivenessTracker(stale_after=10.0, lost_after=30.0)
    _feed(ours, ops)
    _feed(theirs, ops)
    for now in (end, end + 9.9, end + 10.0, end + 29.9, end + 30.0, end + 500.0):
        assert ours.snapshot(now=now) == theirs.snapshot(now=now)
        for rank in range(6):
            assert ours.state_of(rank, now=now) == theirs.state_of(rank, now=now)
    snap = theirs.snapshot(now=end + 20.0)
    seeded, jax_seeded = liveness.RankLivenessTracker(10.0, 30.0), jax_liveness.RankLivenessTracker(10.0, 30.0)
    seeded.seed(snap)
    jax_seeded.seed(snap)
    assert seeded.snapshot(now=end + 20.0) == jax_seeded.snapshot(now=end + 20.0)


@pytest.mark.parametrize("env", [{}, {"TRACEML_LIVENESS_STALE_SEC": "1", "TRACEML_LIVENESS_LOST_SEC": "3"},
                                 {"TRACEML_LIVENESS_STALE_SEC": "40", "TRACEML_LIVENESS_LOST_SEC": "3"},
                                 {"TRACEML_LIVENESS_STALE_SEC": "x"}])
def test_thresholds_from_the_environment_as_jax(env, monkeypatch):
    for name in ("TRACEML_LIVENESS_STALE_SEC", "TRACEML_LIVENESS_LOST_SEC"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ours, theirs = liveness.RankLivenessTracker(), jax_liveness.RankLivenessTracker()
    assert (ours.stale_after, ours.lost_after) == (theirs.stale_after, theirs.lost_after)
    assert (liveness.ENV_STALE_SEC, liveness.ENV_LOST_SEC) == (jax_liveness.ENV_STALE_SEC,
                                                               jax_liveness.ENV_LOST_SEC)


def _snap(ranks, now=1000.0, stale=10.0, lost=30.0, world=None):
    return {"ts": now, "session_id": "s", "expected_world_size": world if world is not None else len(ranks),
            "thresholds": {"stale_after_sec": stale, "lost_after_sec": lost}, "ranks": ranks}


def _rank(state, last_seen, last_progress=None, finished=False):
    return {"state": state, "first_seen": 0.0, "last_seen": last_seen, "last_progress": last_progress,
            "finished": finished}


SNAPSHOTS = {
    "healthy": _snap({"0": _rank("active", 999.0, 999.0), "1": _rank("finished", 998.0, 998.0, True)}),
    "lost": _snap({"0": _rank("active", 999.0, 999.0), "1": _rank("lost", 900.0, 850.0)}),
    "died_mid_stride": _snap({"0": _rank("active", 999.0, 999.0), "1": _rank("lost", 900.0, 898.0)}),
    "never_seen": _snap({"0": _rank("active", 999.0, 999.0)}, world=4),
    "stale_world": _snap({"0": _rank("stale", 985.0, 985.0), "1": _rank("stale", 985.0, 985.0),
                          "2": _rank("active", 999.0, 999.0)}),
    "killed_single_rank": _snap({"0": _rank("lost", 990.0, 989.5)}, stale=1.0, lost=3.0),
    "missing": None,
}
KINDS = {
    "healthy": {"HEALTHY"}, "lost": {"RANK_LOST"}, "died_mid_stride": {"RANK_LOST", "LIKELY_PREEMPTED"},
    "never_seen": {"RANK_LOST"}, "stale_world": {"WORLD_STALE"},
    "killed_single_rank": {"RANK_LOST", "LIKELY_PREEMPTED"}, "missing": {"NO_LIVENESS_DATA"},
}


@pytest.mark.parametrize("case", sorted(SNAPSHOTS))
def test_diagnosis_equals_jax(case):
    ours, theirs = diagnose_rank_status(SNAPSHOTS[case]), jax_diagnose(SNAPSHOTS[case])
    assert {i.kind for i in ours.issues} == KINDS[case]
    assert [i.to_dict() for i in ours.issues] == port_advice([i.to_dict() for i in theirs.issues])
    assert ours.diagnosis.to_dict() == port_advice(theirs.diagnosis.to_dict())
    assert ours.healthy == theirs.healthy


class _Client:
    kind = "tcp"
    reconnects = batches_sent = batches_dropped = 0

    def __init__(self):
        self.sent = []

    def send_batch(self, batch):
        self.sent.append(batch)
        return True


def _heartbeats(client):
    from traceml_tpu_torch.telemetry.control import RANK_HEARTBEAT, control_kind

    return sum(1 for batch in client.sent for msg in batch if control_kind(msg) == RANK_HEARTBEAT)


@pytest.mark.parametrize("value", [None, "0.5", "0.1", "7", "nan-ish"])
def test_heartbeats_on_idle_ticks_equal_the_jax_sender(value, monkeypatch):
    """Idle ticks every 0.1 s for 20 s of a fake clock: the port's
    publisher, which reads the environment itself, sends the heartbeats
    the JAX publisher sends when given the JAX runtime's reading."""
    from traceml_tpu.config import flags
    from traceml_tpu.runtime import sender as jax_sender
    from traceml_tpu.telemetry.envelope import SenderIdentity as JaxIdentity
    from traceml_tpu_torch.runtime import sender
    from traceml_tpu_torch.telemetry.envelope import SenderIdentity

    monkeypatch.delenv("TRACEML_HEARTBEAT_INTERVAL_SEC", raising=False)
    if value is not None:
        monkeypatch.setenv("TRACEML_HEARTBEAT_INTERVAL_SEC", value)
    clock = [5000.0]
    with mock.patch.object(sender.time, "monotonic", lambda: clock[0]):
        ours_client, theirs_client = _Client(), _Client()
        ours = sender.TelemetryPublisher([], ours_client, SenderIdentity(session_id="s", hostname="h", pid=1))
        theirs = jax_sender.TelemetryPublisher(
            [], theirs_client, JaxIdentity(session_id="s", hostname="h", pid=1),
            heartbeat_interval_s=flags.HEARTBEAT_INTERVAL_SEC.get_float(3.0))
        per_tick = []
        for _ in range(200):
            clock[0] += 0.1
            ours.publish()
            theirs.publish()
            per_tick.append((_heartbeats(ours_client), _heartbeats(theirs_client)))
    assert all(a == b for a, b in per_tick), per_tick
    expected = {None: 3.0, "0.5": 0.5, "0.1": 0.25, "7": 7.0, "nan-ish": 3.0}[value]
    assert sender.heartbeat_interval_from_env() == expected
    ticks_per_beat = math.ceil(round(expected / 0.1, 6))  # the first idle tick sends one
    assert per_tick[-1][0] == pytest.approx(200 / ticks_per_beat, abs=1.0)
