"""The Ray integration, against a stand-in ``ray`` module.

The JAX package's cases (the Ray half of
``tests/integrations/test_lightning_ray_ast.py``: the actor-hosted
aggregator reached by a real TCP client and finalized into a
``final_summary.json``, the settings' dict round trip) on the port.
Added for the port: ``actor_name_for`` gives the JAX name for the same
settings; ``traceml_train_loop`` end to end on the CPU (rank 0 makes the
actor, the worker resolves it, trains traced steps, rank 0 finalizes and
kills the actor); a worker of rank 1 makes no actor and waits for rank
0's; the loop runs without telemetry when no actor appears.
"""

import json
import sys
import types

import pytest
pytest.importorskip("torch")  # a checkout without torch still collects

from traceml_tpu_torch.sdk import state as state_mod
from traceml_tpu_torch.utils import timing as T


@pytest.fixture(autouse=True)
def fresh_state():
    st = state_mod.reset_state_for_tests(device="cpu")
    T.GLOBAL_STEP_QUEUE.drain()
    T.drain_step_memory_rows()
    yield st
    from traceml_tpu_torch.runtime import lifecycle

    lifecycle.stop_runtime()
    state_mod.reset_state_for_tests(device="cpu")
    T.GLOBAL_STEP_QUEUE.drain()
    T.drain_step_memory_rows()


@pytest.fixture()
def stub_ray(monkeypatch):
    ray = types.ModuleType("ray")
    registry = {}
    killed = []

    class _Ref:
        def __init__(self, value):
            self.value = value

    class _Method:
        def __init__(self, fn):
            self._fn = fn

        def remote(self, *a, **k):
            return _Ref(self._fn(*a, **k))

    class _Handle:
        def __init__(self, impl):
            self._impl = impl

        def __getattr__(self, name):
            return _Method(getattr(self._impl, name))

    class _RemoteCls:
        def __init__(self, cls):
            self._cls = cls
            self._name = None

        def options(self, name=None, **kw):
            self._name = name
            return self

        def remote(self, *args, **kwargs):
            handle = _Handle(self._cls(*args, **kwargs))
            if self._name:
                registry[self._name] = handle
            return handle

    def get_actor(name):
        if name not in registry:
            raise ValueError(f"no actor {name}")
        return registry[name]

    def kill(handle):
        killed.append(handle)
        for name, h in list(registry.items()):
            if h is handle:
                del registry[name]

    ray.remote = lambda cls: _RemoteCls(cls)
    ray.get = lambda ref, timeout=None: ref.value
    ray.get_actor = get_actor
    ray.kill = kill
    ray.util = types.SimpleNamespace(get_node_ip_address=lambda: "127.0.0.1")
    ray.get_runtime_context = lambda: types.SimpleNamespace(get_job_id=lambda: "02000000")
    ray._registry = registry
    ray._killed = killed
    monkeypatch.setitem(sys.modules, "ray", ray)
    yield ray


def _settings(tmp_path, session="rayrun", **kw):
    from traceml_tpu_torch.runtime.settings import TraceMLSettings

    base = dict(session_id=session, logs_dir=tmp_path, mode="summary", expected_world_size=1,
                finalize_timeout_sec=5.0, sampler_interval_sec=0.1)
    base.update(kw)
    return TraceMLSettings(**base)


def test_ray_actor_hosted_aggregator(stub_ray, tmp_path):
    from traceml_tpu_torch.integrations.ray import (
        actor_name_for,
        resolve_actor_endpoint,
        start_actor_aggregator,
    )
    from traceml_tpu_torch.telemetry.control import build_rank_finished
    from traceml_tpu_torch.transport.tcp_transport import TCPClient

    settings = _settings(tmp_path)
    name = actor_name_for(settings)
    assert name == "traceml_aggregator_rayrun"  # session-scoped
    actor = start_actor_aggregator(settings)
    assert actor is stub_ray.get_actor(name)
    assert start_actor_aggregator(settings) is actor  # fetched, not made twice
    endpoint = resolve_actor_endpoint(stub_ray, name=name, timeout=5)
    assert endpoint and endpoint["port"] > 0 and endpoint["host"] == "127.0.0.1"
    client = TCPClient(endpoint["host"], endpoint["port"])
    assert client.send_batch([build_rank_finished({"global_rank": 0, "rank": 0})])
    client.close()
    assert stub_ray.get(actor.finalize.remote()) is True
    assert (tmp_path / "rayrun" / "final_summary.json").exists()


def test_ray_settings_roundtrip(tmp_path):
    from traceml_tpu_torch.runtime.settings import AggregatorEndpoint, TraceMLSettings

    s = TraceMLSettings(session_id="x", logs_dir=tmp_path, mode="summary",
                        aggregator=AggregatorEndpoint(connect_host="10.0.0.9", port=777),
                        transport="tcp", shm_dir="/dev/shm/x")
    back = TraceMLSettings.from_dict(json.loads(json.dumps(s.to_dict())))
    assert back == s
    assert TraceMLSettings.from_dict(dict(s.to_dict(), unknown_key=1)) == s


@pytest.mark.parametrize("session", ["rayrun", "local"])
def test_actor_name_matches_jax(stub_ray, tmp_path, session):
    from traceml_tpu.integrations.ray import actor_name_for as jax_name
    from traceml_tpu.runtime.settings import TraceMLSettings as JaxSettings
    from traceml_tpu_torch.integrations.ray import actor_name_for

    ours = actor_name_for(_settings(tmp_path, session=session))
    theirs = jax_name(JaxSettings(session_id=session, logs_dir=tmp_path, mode="summary"))
    assert ours == theirs
    if session == "local":
        assert ours == "traceml_aggregator_local_02000000"  # scoped by the Ray job


def _user_loop(steps):
    import torch

    import traceml_tpu_torch as tm

    def loop(config):
        torch.manual_seed(0)
        model = torch.nn.Linear(16, 4)
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        x = torch.randn(32, 16)
        losses = []
        for _ in range(steps):
            with tm.trace_step():
                loss = model(x).pow(2).mean()
                loss.backward()
                opt.step()
                opt.zero_grad()
            losses.append(float(loss.detach()))
        return {"losses": losses, "config": config}

    return loop


def test_train_loop_end_to_end(stub_ray, tmp_path, monkeypatch):
    from traceml_tpu_torch.integrations.ray import traceml_train_loop

    monkeypatch.setenv("RANK", "0")
    settings = _settings(tmp_path, session="rayloop")
    wrapped = traceml_train_loop(_user_loop(12), settings=settings, device="cpu")
    out = wrapped({"lr": 0.05})
    assert out["config"] == {"lr": 0.05} and out["losses"][-1] < out["losses"][0]
    assert len(stub_ray._killed) == 1 and not stub_ray._registry  # finalized, then killed
    summary = json.loads((tmp_path / "rayloop" / "final_summary.json").read_text())
    assert summary["sections"]["step_time"]["global"]["n_steps"] == 12
    # the rank's ring was used, then reaped with the actor's aggregator
    from traceml_tpu_torch.transport.shm_ring import ring_segment_path

    ingest = json.loads((tmp_path / "rayloop" / "ingest_stats.json").read_text())
    assert ingest["transports"]["frames_by_kind"].get("shm", 0) > 0
    assert not ring_segment_path(tmp_path / "rayloop", 0, None).exists()


def test_worker_rank_waits_for_rank_zero_actor(stub_ray, tmp_path, monkeypatch):
    from traceml_tpu_torch.integrations.ray import actor_name_for, start_actor_aggregator, traceml_train_loop

    settings = _settings(tmp_path, session="rayworker")
    actor = start_actor_aggregator(settings, name=actor_name_for(settings))  # rank 0's
    monkeypatch.setenv("RANK", "1")
    before = dict(stub_ray._registry)
    out = traceml_train_loop(_user_loop(3), settings=settings, device="cpu")(None)
    assert len(out["losses"]) == 3
    assert stub_ray._registry == before and stub_ray._killed == []  # rank 1 made and killed nothing
    assert stub_ray.get(actor.finalize.remote()) is True


def test_loop_runs_without_an_actor(stub_ray, tmp_path, monkeypatch):
    """No actor ever appears (rank 1 alone): the loop trains without an
    aggregator, after the endpoint wait."""
    import traceml_tpu_torch.integrations.ray as R

    monkeypatch.setenv("RANK", "1")
    monkeypatch.setattr(R, "resolve_actor_endpoint",
                        lambda ray, name, timeout=30.0: None)
    out = R.traceml_train_loop(_user_loop(2), settings=_settings(tmp_path, session="noactor"),
                               device="cpu")(None)
    assert len(out["losses"]) == 2
