"""On-demand ``torch.profiler`` capture (``sdk/profile_capture.py``).

The JAX package's fifteen cases (``tests/sdk/test_profile_capture.py``)
on the port: the operator drops ``control/profile_request.json``, each
rank's service profiles the next N steps at step flushes and the primary
rank answers in ``control/profile_response.json``; the real profiler runs
with CPU activity here.  Added for the port: a request written by JAX's
``write_profile_request`` is served by the port's service and its
response read back by JAX's ``read_profile_response`` (and the other way
round); the runtime wires the service to the step flushes and finishes a
capture at stop; the ``profile`` command against a running ``run``
(JAX's ``tests/launcher/test_profile_e2e.py``) and its argument errors.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
pytest.importorskip("torch")  # a checkout without torch still collects

from traceml_tpu_torch.sdk import profile_capture as pc
from traceml_tpu_torch.sdk.profile_capture import (
    ProfileCaptureService,
    profile_request_path,
    profile_response_path,
    read_profile_response,
    write_profile_request,
)

REPO = Path(__file__).resolve().parents[1]


def _drive(svc, steps):
    for s in range(steps):
        svc.on_step_flushed(s)


class _FakeProfiler:
    def __init__(self, calls=None, starts=None):
        self.calls = [] if calls is None else calls
        self.starts = [] if starts is None else starts

    def start_trace(self, d):
        self.calls.append(("start", d))
        self.starts.append(d)

    def stop_trace(self):
        self.calls.append(("stop",))


def test_idle_without_request(tmp_path):
    svc = ProfileCaptureService(tmp_path, rank=0, check_every=1)
    _drive(svc, 20)
    assert not profile_response_path(tmp_path).exists()


def test_capture_cycle_real_profiler(tmp_path):
    """The whole cycle with the real torch.profiler (CPU activity): a
    request, N profiled steps of real work, the response and a Chrome
    trace holding the steps' ops."""
    import torch

    svc = ProfileCaptureService(tmp_path, rank=0, check_every=1)
    ts = write_profile_request(tmp_path, steps=3)
    x = torch.ones(16, 16)
    for s in range(8):
        x = x @ x / 16.0
        svc.on_step_flushed(s)
    resp = read_profile_response(tmp_path, for_request=ts)
    assert resp is not None and resp["ok"], resp
    assert resp["steps"] == 3 and not resp["truncated"]
    trace = Path(resp["trace_dir"]) / "rank_0" / pc.TRACE_FILE
    events = json.loads(trace.read_text())["traceEvents"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert len(mm) == 3  # one a profiled step


def test_rank_filter(tmp_path):
    svc = ProfileCaptureService(tmp_path, rank=2, check_every=1)
    write_profile_request(tmp_path, steps=2, ranks=[0, 1])
    _drive(svc, 10)
    assert not profile_response_path(tmp_path).exists()
    assert not (tmp_path / "profiles").exists()


def test_non_primary_rank_stays_silent_on_response(tmp_path, monkeypatch):
    """Both ranks capture; only the primary writes the response."""
    fake = _FakeProfiler()
    monkeypatch.setattr(pc, "profiler", fake)
    svc1 = ProfileCaptureService(tmp_path, rank=1, check_every=1)
    svc0 = ProfileCaptureService(tmp_path, rank=0, check_every=1)
    time.sleep(0.02)
    write_profile_request(tmp_path, steps=1, ranks=[0, 1])
    _drive(svc1, 4)
    assert ("stop",) in fake.calls
    assert not profile_response_path(tmp_path).exists()
    _drive(svc0, 4)
    resp = json.loads(profile_response_path(tmp_path).read_text())
    assert resp["ok"] and resp["rank"] == 0


def test_ranks_share_one_trace_dir(tmp_path, monkeypatch):
    """The stamp comes from the request, not each rank's clock: all ranks
    land under ONE profiles/<stamp>/."""
    fake = _FakeProfiler()
    monkeypatch.setattr(pc, "profiler", fake)
    svcs = [ProfileCaptureService(tmp_path, rank=r, check_every=1) for r in range(3)]
    time.sleep(0.02)
    write_profile_request(tmp_path, steps=1)
    for svc in svcs:
        _drive(svc, 3)
    parents = {Path(d).parent for d in fake.starts}
    assert len(fake.starts) == 3 and len(parents) == 1, fake.starts


def test_same_request_not_replayed(tmp_path, monkeypatch):
    fake = _FakeProfiler()
    monkeypatch.setattr(pc, "profiler", fake)
    svc = ProfileCaptureService(tmp_path, rank=0, check_every=1)
    write_profile_request(tmp_path, steps=2)
    _drive(svc, 10)
    assert len(fake.starts) == 1
    time.sleep(0.02)
    write_profile_request(tmp_path, steps=2)
    os.utime(profile_request_path(tmp_path))
    _drive(svc, 10)
    assert len(fake.starts) == 2


def test_answered_request_not_replayed_after_restart(tmp_path, monkeypatch):
    """A request answered in an earlier life of the session dir does not
    replay on restart."""
    fake = _FakeProfiler()
    monkeypatch.setattr(pc, "profiler", fake)
    write_profile_request(tmp_path, steps=1)
    svc_old = ProfileCaptureService(tmp_path, rank=0, check_every=1)
    _drive(svc_old, 3)
    assert len(fake.starts) == 1
    assert profile_response_path(tmp_path).exists()
    svc_new = ProfileCaptureService(tmp_path, rank=0, check_every=1)
    _drive(svc_new, 10)
    assert len(fake.starts) == 1


def test_close_finishes_inflight_capture(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(pc, "profiler", _FakeProfiler(calls=calls))
    svc = ProfileCaptureService(tmp_path, rank=0, check_every=1)
    time.sleep(0.02)
    ts = write_profile_request(tmp_path, steps=100)
    _drive(svc, 5)
    assert [c[0] for c in calls] == ["start"]
    svc.close()
    assert [c[0] for c in calls] == ["start", "stop"]
    resp = read_profile_response(tmp_path, for_request=ts)
    assert resp is not None and resp["ok"] and resp["truncated"]
    svc.close()  # idempotent
    assert [c[0] for c in calls] == ["start", "stop"]


def test_response_matching_is_exact(tmp_path, monkeypatch):
    monkeypatch.setattr(pc, "profiler", _FakeProfiler())
    svc = ProfileCaptureService(tmp_path, rank=0, check_every=1)
    time.sleep(0.02)
    ts_a = write_profile_request(tmp_path, steps=1)
    _drive(svc, 3)
    assert read_profile_response(tmp_path, for_request=ts_a) is not None
    assert read_profile_response(tmp_path, for_request=ts_a + 0.5) is None


def test_broken_profiler_answers_error(tmp_path, monkeypatch):
    class _Broken:
        def start_trace(self, d):
            raise RuntimeError("unsupported runtime")

        def stop_trace(self):  # pragma: no cover
            pass

    monkeypatch.setattr(pc, "profiler", _Broken())
    svc = ProfileCaptureService(tmp_path, rank=0, check_every=1)
    ts = write_profile_request(tmp_path, steps=2)
    _drive(svc, 5)
    resp = read_profile_response(tmp_path, for_request=ts)
    assert resp is not None and not resp["ok"]
    assert "unsupported" in (resp["error"] or "")


def test_steps_bounded_against_typo(tmp_path, monkeypatch):
    monkeypatch.setattr(pc, "profiler", _FakeProfiler())
    svc = ProfileCaptureService(tmp_path, rank=0, check_every=1)
    ts = write_profile_request(tmp_path, steps=10_000_000)
    _drive(svc, 250)  # > _MAX_STEPS flushes
    resp = read_profile_response(tmp_path, for_request=ts)
    assert resp is not None and resp["ok"]


def test_empty_ranks_rejected_at_write(tmp_path):
    with pytest.raises(ValueError):
        write_profile_request(tmp_path, steps=2, ranks=[])
    assert not profile_request_path(tmp_path).exists()


def test_dead_ranks_get_error_response(tmp_path):
    svc = ProfileCaptureService(tmp_path, rank=0, check_every=1, world_size=2)
    ts = write_profile_request(tmp_path, steps=2, ranks=[5, 9])
    _drive(svc, 6)
    resp = read_profile_response(tmp_path, for_request=ts)
    assert resp is not None and not resp["ok"]
    assert "no live rank" in resp["error"]
    assert not (tmp_path / "profiles").exists()


def test_dead_primary_live_secondary_still_answers(tmp_path, monkeypatch):
    fake = _FakeProfiler()
    monkeypatch.setattr(pc, "profiler", fake)
    svc = ProfileCaptureService(tmp_path, rank=1, check_every=1, world_size=2)
    ts = write_profile_request(tmp_path, steps=1, ranks=[1, 7])
    _drive(svc, 4)
    resp = read_profile_response(tmp_path, for_request=ts)
    assert resp is not None and resp["ok"] and resp["rank"] == 1
    assert ("stop",) in fake.calls


def test_response_echoes_clamped_steps(tmp_path, monkeypatch):
    monkeypatch.setattr(pc, "profiler", _FakeProfiler())
    svc = ProfileCaptureService(tmp_path, rank=0, check_every=1)
    ts = write_profile_request(tmp_path, steps=10_000_000)
    _drive(svc, 250)
    resp = read_profile_response(tmp_path, for_request=ts)
    assert resp is not None and resp["ok"]
    assert resp["steps"] == 200  # _MAX_STEPS, not the typo'd request


# -- added for the port ----------------------------------------------------------------


def test_a_failed_stop_answers_error(tmp_path, monkeypatch):
    class _StopFails(_FakeProfiler):
        def stop_trace(self):
            raise OSError("disk full")

    monkeypatch.setattr(pc, "profiler", _StopFails())
    svc = ProfileCaptureService(tmp_path, rank=0, check_every=1)
    ts = write_profile_request(tmp_path, steps=1)
    _drive(svc, 4)
    resp = read_profile_response(tmp_path, for_request=ts)
    assert resp is not None and not resp["ok"] and "disk full" in resp["error"]


@pytest.mark.parametrize("direction", ["jax_operator", "port_operator"])
def test_protocol_interoperates_with_jax(tmp_path, monkeypatch, direction):
    """The control files are JAX's: JAX's operator side talks to the
    port's service, and the port's operator side to JAX's service."""
    from traceml_tpu.sdk import profile_capture as jpc

    if direction == "jax_operator":
        monkeypatch.setattr(pc, "profiler", _FakeProfiler())
        ts = jpc.write_profile_request(tmp_path, steps=2, ranks=[0])
        svc = ProfileCaptureService(tmp_path, rank=0, check_every=1, world_size=1)
        _drive(svc, 5)
        resp = jpc.read_profile_response(tmp_path, for_request=ts)
    else:
        import jax

        class _JaxFake:
            def start_trace(self, d):
                pass

            def stop_trace(self):
                pass

        monkeypatch.setattr(jax, "profiler", _JaxFake())
        ts = write_profile_request(tmp_path, steps=2, ranks=[0])
        svc = jpc.ProfileCaptureService(tmp_path, rank=0, check_every=1, world_size=1)
        _drive(svc, 5)
        resp = read_profile_response(tmp_path, for_request=ts)
    assert resp is not None and resp["ok"] and resp["steps"] == 2 and resp["rank"] == 0
    assert resp["requested_at"] == ts
    assert Path(resp["trace_dir"]).parent == tmp_path / "profiles"
    assert set(resp) == {"requested_at", "completed_at", "ok", "steps", "error", "trace_dir", "truncated",
                         "rank"}


def test_runtime_wires_the_service_and_closes_it(tmp_path, monkeypatch):
    """A started runtime answers a request at its step flushes; a stop
    in the middle of a capture answers with a truncated trace."""
    from traceml_tpu_torch.runtime.runtime import TraceMLRuntime
    from traceml_tpu_torch.runtime.settings import TraceMLSettings
    from traceml_tpu_torch.sdk import state as state_mod

    st = state_mod.reset_state_for_tests(device="cpu")
    calls = []
    monkeypatch.setattr(pc, "profiler", _FakeProfiler(calls=calls))
    rt = TraceMLRuntime(TraceMLSettings(session_id="prof", logs_dir=tmp_path, sampler_interval_sec=0.5))
    rt.start()
    try:
        ts = write_profile_request(rt.settings.session_dir, steps=50)
        for step in range(12):
            st.flush_step(step)
        assert [c[0] for c in calls] == ["start"]
    finally:
        rt.stop()
        state_mod.reset_state_for_tests(device="cpu")
    assert [c[0] for c in calls] == ["start", "stop"]
    resp = read_profile_response(rt.settings.session_dir, for_request=ts)
    assert resp["ok"] and resp["truncated"]
    assert rt._profile_service is None


def test_profile_cli_argument_errors(tmp_path, capsys):
    from traceml_tpu_torch.launcher.cli import main

    assert main(["profile", str(tmp_path), "--ranks", "0,x"]) == 2
    assert "--ranks must be comma-separated integers" in capsys.readouterr().err
    assert main(["profile", str(tmp_path), "--timeout", "0.3"]) == 1
    assert "no response" in capsys.readouterr().err


def test_profile_cli_against_live_run(tmp_path):
    """``python -m traceml_tpu_torch profile`` against a running ``run``
    of the tiny train script on the CPU: exit 0, an ``ok`` response and
    a Chrome trace of 3 steps, one ``aten::mm``-bearing forward a step."""
    logs = tmp_path / "logs"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    job = subprocess.Popen(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary", "--logs-dir", str(logs),
         "--run-name", "proftest", "--finalize-timeout", "45", "--sampler-interval", "0.25",
         str(REPO / "traceml_tpu_torch" / "dev" / "train_script.py"), "--",
         "--device", "cpu", "--tiny", "--steps", "400", "--delay-ms", "20"],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 60
        session = None
        while time.monotonic() < deadline and session is None:
            if logs.is_dir():
                dirs = [d for d in logs.iterdir() if d.is_dir()]
                if dirs:
                    session = dirs[0]
                    break
            time.sleep(0.25)
        assert session is not None, "session dir never appeared"
        proc = subprocess.run(
            [sys.executable, "-m", "traceml_tpu_torch", "profile", str(session), "--steps", "3",
             "--timeout", "120"],
            env=env, capture_output=True, text=True, timeout=150,
        )
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        assert "trace captured" in proc.stdout
        resp = json.loads((session / "control" / "profile_response.json").read_text())
        assert resp["ok"] and resp["steps"] == 3 and not resp["truncated"]
        trace = Path(resp["trace_dir"]) / "rank_0" / pc.TRACE_FILE
        events = json.loads(trace.read_text())["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events)
    finally:
        job.terminate()
        try:
            job.wait(timeout=60)
        except subprocess.TimeoutExpired:
            job.kill()
            job.wait(timeout=15)
