"""Chaos end to end on the CPU: deterministic faults (``TRACEML_FAULT_PLAN``,
``traceml_tpu_torch/dev/chaos.py``) through the REAL pipeline of the port:
the launcher, two rank executors running ``dev/train_script.py --device
cpu --tiny`` and the aggregator, over the default transport (each rank's
shm ring) unless a case pins ``TRACEML_TRANSPORT``.

The port of JAX ``tests/launcher/test_chaos_e2e.py::
test_aggregator_kill9_restart_no_loss_no_duplicates`` (pinned to ``tcp``,
as JAX pins it) and ``::test_aggregator_kill9_restart_over_shm_ring``,
with their assertions: an aggregator SIGKILLed mid-run, by payload count,
is restarted once on its pinned port, the ranks replay their spools (over
the ring, the consumer-generation flip fails one send each) and the
writer drops the duplicates by ``seq``, so the database holds exactly the
(rank, step) set of a fault-free run of the same script, every row once;
the run is ``completed`` / ``restarted`` / ``aggregator_restarts: 1``, the
launcher says ``restarting``, and the final summary has seen both ranks.
The shm case also shows the run rode the ring (shm frames, every rank's
hello ``shm``, no ring-full drop).  Two more cases: with
``TRACEML_AGG_MAX_RESTARTS=0`` the run completes, degraded, and training
is untouched; a ``client.send`` reset on rank 1 (a stream client's chaos
point, so pinned to ``tcp``) loses nothing and telemetry stays ``ok``.
No run leaves a ring segment, descriptor or socket of its session.

And the ring flush, in process against two aggregator processes: the
aggregator is killed with envelopes the client had sent (TCP accepted
them) but it had not committed; after its restart on the same port the
durable sender's replay puts every one of them in the database, once.

The train script sleeps 60 ms before each of its 60 steps, so the loop
outlasts the restart and the clients' redial backoff on a loaded host.
"""

import json
import os
import re
import signal
import sqlite3
import subprocess
import sys
import time
from pathlib import Path

import pytest

from test_torch_sqlite import step_rows
from traceml_tpu_torch.telemetry.control import build_rank_finished
from traceml_tpu_torch.telemetry.envelope import SenderIdentity, rows_to_columns
from traceml_tpu_torch.transport.select import default_uds_path
from traceml_tpu_torch.transport.shm_ring import ring_segment_path
from traceml_tpu_torch.transport.spool import DurableSender, ReplaySpool
from traceml_tpu_torch.transport.tcp_transport import TCPClient

REPO = Path(__file__).resolve().parent.parent
TRAIN_SCRIPT = REPO / "traceml_tpu_torch" / "dev" / "train_script.py"
STEPS = 60
KILL_AFTER_40 = json.dumps([{"point": "aggregator.ingest", "action": "kill9", "after": 40}])


def _env(extra=None):
    env = dict(os.environ)
    env.pop("TRACEML_FAULT_PLAN", None)
    env.pop("TRACEML_AGG_MAX_RESTARTS", None)
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


def _run(root, name, extra_env=None):
    logs = root / f"logs_{name}"
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary", "--nprocs", "2",
         "--logs-dir", str(logs), "--run-name", name, "--sampler-interval", "0.25",
         "--finalize-timeout", "45", str(TRAIN_SCRIPT), "--",
         "--device", "cpu", "--tiny", "--steps", str(STEPS), "--delay-ms", "60"],
        env=_env(extra_env), capture_output=True, text=True, timeout=300, cwd=str(root),
    )
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-2000:]
    (session,) = [p for p in logs.iterdir() if p.is_dir()]
    assert_no_transport_files_left(session, ranks=2)
    return session, proc


def assert_no_transport_files_left(session, ranks):
    """The launcher removed every ring segment and descriptor of the
    session and its Unix socket."""
    left = [p for r in range(ranks) for p in (ring_segment_path(session, r), session / f"rank_{r}" / "shm_ring.json")
            if p.exists()]
    assert left == [] and not os.path.exists(default_uds_path(session)), left


def _step_coverage(session):
    """{(rank, step), ...} and the raw row count (more rows than pairs:
    a replayed envelope was inserted twice)."""
    conn = sqlite3.connect(session / "telemetry.sqlite")
    try:
        rows = conn.execute("SELECT global_rank, step FROM step_time_samples").fetchall()
    finally:
        conn.close()
    return {(r, s) for r, s in rows}, len(rows)


def _manifest(session):
    return json.loads((session / "manifest.json").read_text())


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    session, _ = _run(tmp_path_factory.mktemp("chaos"), "baseline")
    cov, rows = _step_coverage(session)
    assert rows == len(cov) == 2 * STEPS  # a fault-free run has no duplicates
    return cov


def _kill9_restart_case(tmp_path, baseline, transport):
    session, proc = _run(tmp_path, f"aggkill_{transport}",
                         {"TRACEML_FAULT_PLAN": KILL_AFTER_40, "TRACEML_TRANSPORT": transport})
    manifest = _manifest(session)
    assert manifest["status"] == "completed"
    assert manifest["telemetry_status"] == "restarted", manifest
    assert manifest["aggregator_restarts"] == 1
    assert "restarting" in proc.stdout, proc.stdout[-2000:]

    cov, rows = _step_coverage(session)
    assert rows == len(cov), f"{rows - len(cov)} duplicate (rank, step) rows"
    # everything in flight at the kill was spooled by the ranks and
    # replayed into the restarted aggregator
    assert cov == baseline, f"missing={sorted(baseline - cov)[:10]} extra={sorted(cov - baseline)[:10]}"
    summary = json.loads((session / "final_summary.json").read_text())
    assert sorted(summary["meta"]["topology"]["ranks_seen"]) == [0, 1]
    # the restarted incarnation bound the dead one's port; the replay
    # shows in the counters
    port = int(re.search(r"restarting \(1/3\) on port (\d+)", proc.stdout).group(1))
    assert json.loads((session / "aggregator_ready.json").read_text())["port"] == port
    stats = json.loads((session / "ingest_stats.json").read_text())
    assert stats["final"] and stats["finished_ranks"] == [0, 1]
    assert sum(p["transport"]["replayed_envelopes"] for p in stats["producers"].values()) > 0
    assert all(p["transport"]["reconnects"] >= 1 for p in stats["producers"].values())
    assert summary["sections"]["liveness"]["diagnosis"]["kind"] == "HEALTHY"
    return stats


def test_aggregator_kill9_restart_no_loss_no_duplicates(tmp_path, baseline):
    stats = _kill9_restart_case(tmp_path, baseline, "tcp")  # the golden arm, pinned as JAX pins it
    assert set(stats["transports"]["frames_by_kind"]) == {"tcp"}
    assert "shm" not in stats["transports"]  # no ring registry under tcp


def test_aggregator_kill9_restart_over_shm_ring(tmp_path, baseline):
    """The restarted aggregator re-attaches the rings (a consumer-generation
    flip, one failed send, the spool's replay) and coverage stays
    exactly-once; the run rode the ring, not a silent tcp fallback."""
    stats = _kill9_restart_case(tmp_path, baseline, "shm")
    transports = stats["transports"]
    assert transports["frames_by_kind"].get("shm", 0) > 0, transports
    assert {r: h["transport"] for r, h in transports["ranks"].items()} == {"0": "shm", "1": "shm"}, transports
    assert transports["shm"]["rings_attached"] >= 2 and transports["shm"]["quarantined"] == 0
    assert all(p["transport"]["ring_full_drops"] == 0 for p in stats["producers"].values())


def test_aggregator_kill9_without_restarts_degrades(tmp_path):
    session, proc = _run(tmp_path, "norestart", {"TRACEML_FAULT_PLAN": KILL_AFTER_40,
                                                 "TRACEML_AGG_MAX_RESTARTS": "0"})
    manifest = _manifest(session)
    assert (manifest["status"], manifest["telemetry_status"]) == ("completed", "degraded")
    assert "aggregator_restarts" not in manifest
    assert "restarting" not in proc.stdout and "telemetry degraded" in proc.stdout
    # training went on untouched: both ranks ran every step to a finite loss
    assert proc.stdout.count(f"train_script: {STEPS} steps in") == 2
    assert proc.stdout.count("finite=True") == 2


def test_client_send_reset_on_rank_1_loses_nothing(tmp_path, baseline):
    plan = json.dumps([{"point": "client.send", "action": "reset", "after": 10, "rank": 1}])
    # client.send is the stream clients' chaos point: pinned to tcp
    session, proc = _run(tmp_path, "reset", {"TRACEML_FAULT_PLAN": plan, "TRACEML_TRANSPORT": "tcp"})
    manifest = _manifest(session)
    assert (manifest["status"], manifest["telemetry_status"]) == ("completed", "ok")
    cov, rows = _step_coverage(session)
    assert rows == len(cov) and cov == baseline
    stats = json.loads((session / "ingest_stats.json").read_text())
    transport = stats["producers"]["1"]["transport"]
    # the reset batch and the ring of recent sends were spooled and replayed
    assert transport["spooled_envelopes"] > 1 and transport["replayed_envelopes"] == transport["spooled_envelopes"]
    assert transport["batches_dropped"] >= 1 and transport["spool_frames"] == 0
    assert stats["producers"]["0"]["transport"]["spooled_envelopes"] == 0
    assert stats["replay_duplicates"] >= 1  # the ring's committed part came back and was dropped


def _aggregator(session_dir, port, plan=""):
    env = _env({
        "TRACEML_SESSION_ID": session_dir.name, "TRACEML_LOGS_DIR": str(session_dir.parent),
        "TRACEML_MODE": "summary", "TRACEML_AGGREGATOR_PORT": str(port),
        "TRACEML_EXPECTED_WORLD_SIZE": "1", "TRACEML_FINALIZE_TIMEOUT_SEC": "10",
        "TRACEML_FAULT_PLAN": plan,
    })
    ready = session_dir / "aggregator_ready.json"
    if ready.exists():
        ready.unlink()
    proc = subprocess.Popen([sys.executable, "-m", "traceml_tpu_torch.aggregator.aggregator_main"], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and proc.poll() is None:
        if ready.exists():
            try:
                return proc, json.loads(ready.read_text())["port"]
            except (ValueError, KeyError):
                pass
        time.sleep(0.05)
    proc.kill()
    raise AssertionError(f"aggregator did not start: {proc.stderr.read().decode()[-2000:]}")


def _stored_steps(db):
    if not db.exists():
        return []
    conn = sqlite3.connect(db)
    try:
        return [r[0] for r in conn.execute("SELECT step FROM step_time_samples")]
    except sqlite3.Error:
        return []  # the table was never created
    finally:
        conn.close()


def _until(fn, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.1)
    return False


def test_ring_flush_replays_sent_but_uncommitted_envelopes(tmp_path):
    session_dir = tmp_path / "logs" / "ring"
    session_dir.mkdir(parents=True)
    meta = SenderIdentity(session_id="ring", global_rank=0, hostname="h", pid=1).to_meta()
    rows = step_rows(0, 60, 2.0, 18.0, clock="host")
    seqs = iter(range(100, 1000))

    def envelope(i):
        m = dict(meta, schema=2, sampler="step_time", timestamp=1.7e9, seq=next(seqs))
        return {"meta": m, "body": {"tables": {"step_time": rows_to_columns(rows[5 * i:5 * i + 5])}}}

    envelopes = [envelope(i) for i in range(12)]
    # the 5th payload it ingests kills the first aggregator
    first, port = _aggregator(session_dir, 0, json.dumps([{"point": "aggregator.ingest", "action": "kill9",
                                                           "after": 4}]))
    second = None
    client = TCPClient("127.0.0.1", port)
    sender = DurableSender(client, ReplaySpool(tmp_path / "spool"))
    db = session_dir / "telemetry.sqlite"
    try:
        assert sender.send(envelopes[0:3]) and sender.send(envelopes[3:6])  # TCP took all six
        assert first.wait(timeout=30) == -signal.SIGKILL
        # sent, taken by TCP, and not committed: the kill fell inside the
        # second batch, so its first envelope at least never reached SQLite
        assert len(_stored_steps(db)) < 30
        # the next sends find the link dead: the ring (every envelope sent
        # so far) and the failed batches go to the spool
        rest = iter(envelopes[6:])
        assert _until(lambda: not sender.send([next(rest)]), timeout=5)
        assert sender.stats()["spooled_envelopes"] >= 7

        second, port2 = _aggregator(session_dir, port)  # restarted on the pinned port
        assert port2 == port
        assert _until(lambda: sender.send([]), timeout=30)  # redial, replay the spool
        for env in rest:
            assert sender.send([env])
        assert sender.send([dict(build_rank_finished(meta), meta=dict(meta, seq=next(seqs)))])
        second.send_signal(signal.SIGTERM)
        assert second.wait(timeout=60) == 0
    finally:
        client.close()
        for proc in (first, second):
            if proc is not None and proc.poll() is None:
                proc.kill()
    assert sorted(_stored_steps(db)) == list(range(1, 61))  # every envelope, each once
    stats = json.loads((session_dir / "ingest_stats.json").read_text())
    assert stats["finished_ranks"] == [0]
    assert sender.stats()["replayed_envelopes"] == sender.stats()["spooled_envelopes"]
