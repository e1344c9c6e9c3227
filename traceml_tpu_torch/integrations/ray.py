"""Ray Train integration.

Counterpart of ``traceml_tpu/integrations/ray.py``: the aggregator runs
inside a NAMED RAY ACTOR, so every worker, on any node, finds its
endpoint through Ray instead of a shared filesystem; each worker runs the
in-process runtime (``runtime/lifecycle.py``).  ``ray`` is not a
dependency: it is imported when the wrapped loop runs.

Usage::

    from traceml_tpu_torch.integrations.ray import traceml_train_loop

    def my_loop(config):
        ...  # a normal Ray Train loop

    trainer = TorchTrainer(traceml_train_loop(my_loop), ...)

The wrapper: rank 0 creates (or reuses) the aggregator actor; every
worker asks the actor for the endpoint, starts a runtime pointed at it,
calls ``init(mode="auto")`` on ``device`` (CUDA unless the caller asks
for the CPU) and runs the loop; when the loop returns each worker stops
its runtime, and rank 0 has the actor finalize (the final summary) and
kills it.  Telemetry never aborts training: an actor that cannot be
made or reached leaves a run without an aggregator.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

from traceml_tpu_torch.runtime import lifecycle
from traceml_tpu_torch.runtime.settings import (
    AggregatorEndpoint,
    TraceMLSettings,
    settings_from_env,
)
from traceml_tpu_torch.utils.error_log import get_error_log

ACTOR_NAME = "traceml_aggregator"


def _require_ray():
    try:
        import ray  # noqa: F401

        return ray
    except Exception as exc:
        raise ImportError("ray is required for the Ray integration") from exc


class AggregatorActorImpl:
    """The aggregator, hosted inside a Ray actor.

    A plain class: ``ray.remote`` is applied at run time (ray is an
    optional dependency), and tests drive the class through a stand-in
    ``ray`` module.
    """

    def __init__(self, settings_dict: Dict[str, Any]) -> None:
        from traceml_tpu_torch.aggregator.trace_aggregator import TraceMLAggregator

        settings = TraceMLSettings.from_dict(settings_dict)
        if settings.aggregator.bind_host in ("127.0.0.1", "localhost"):
            # workers on OTHER nodes dial the advertised node address: a
            # loopback bind would refuse every one of them
            settings = dataclasses.replace(
                settings, aggregator=dataclasses.replace(settings.aggregator, bind_host="0.0.0.0")
            )
        self._settings = settings
        self._agg = TraceMLAggregator(self._settings)
        self._agg.start()

    def endpoint(self) -> Dict[str, Any]:
        """The endpoint workers dial (host: this node's address)."""
        host = self._settings.aggregator.connect_host or "127.0.0.1"
        try:
            import ray

            host = ray.util.get_node_ip_address()
        except Exception:
            pass
        return {"host": host, "port": self._agg.port or 0}

    def finalize(self) -> bool:
        """Stop the aggregator: settle, write the final summary (within
        the settings' ``finalize_timeout_sec``), then remove the ring
        segments of this node's ranks, as the launcher does after its
        aggregator: nothing else would reap them from ``/dev/shm``."""
        from traceml_tpu_torch.launcher.commands import _cleanup_ring_segments

        try:
            self._agg.stop()
            return True
        except Exception as exc:
            get_error_log().warning("ray aggregator finalize failed", exc)
            return False
        finally:
            _cleanup_ring_segments(self._settings.session_dir)


def actor_name_for(settings: TraceMLSettings) -> str:
    """The session's actor name: two jobs on one cluster must not share an
    aggregator, and a finished job's actor must not pass for a new one.
    Under the default session id ('local') the Ray job id scopes it: the
    workers of one job share it, two jobs never do."""
    session = settings.session_id
    if session == "local":
        try:
            import ray

            job = ray.get_runtime_context().get_job_id()
            if job:
                session = f"local_{job}"
        except Exception:
            pass
    return f"{ACTOR_NAME}_{session}"


def start_actor_aggregator(settings: TraceMLSettings, *, name: Optional[str] = None) -> Any:
    """Create (or fetch) the named aggregator actor; returns its handle."""
    ray = _require_ray()
    name = name or actor_name_for(settings)
    try:
        return ray.get_actor(name)
    except Exception:
        pass
    actor_cls = ray.remote(AggregatorActorImpl)
    if getattr(actor_cls, "options", None) is not None:
        actor_cls = actor_cls.options(name=name, lifetime="detached")
    return actor_cls.remote(settings.to_dict())


def resolve_actor_endpoint(ray: Any, *, name: str = ACTOR_NAME, timeout: float = 30.0) -> Optional[Dict[str, Any]]:
    """The aggregator's endpoint, WAITING for the actor to appear: Ray
    Train starts every worker at once, so the others race rank 0's
    actor creation."""
    import time

    deadline = time.monotonic() + timeout
    actor = None
    while time.monotonic() < deadline:
        try:
            actor = ray.get_actor(name)
            break
        except Exception:
            time.sleep(0.25)
    if actor is None:
        get_error_log().warning(f"ray aggregator actor {name!r} never appeared", None)
        return None
    try:
        return ray.get(actor.endpoint.remote(), timeout=timeout)
    except Exception as exc:
        get_error_log().warning("ray aggregator endpoint resolve failed", exc)
        return None


def traceml_train_loop(
    user_loop: Callable[[Any], Any],
    settings: Optional[TraceMLSettings] = None,
    device: Any = None,
) -> Callable[[Any], Any]:
    """Wrap a Ray Train per-worker loop with the runtime's lifecycle;
    ``device`` is where ``init`` traces (CUDA unless the caller asks for
    the CPU)."""

    def wrapped(config: Any) -> Any:
        ray = _require_ray()
        base = settings or settings_from_env()
        rank = int(os.environ.get("RANK", os.environ.get("WORLD_RANK", 0)))
        actor = None
        run_settings = base
        name = actor_name_for(base)
        try:
            if rank == 0 and not base.aggregator.port:
                try:
                    actor = start_actor_aggregator(base, name=name)
                except Exception as exc:
                    get_error_log().warning("ray aggregator actor creation failed", exc)
                    actor = None
            if not run_settings.aggregator.port:
                endpoint = resolve_actor_endpoint(ray, name=name)
                if endpoint and endpoint.get("port"):
                    run_settings = dataclasses.replace(
                        base,
                        aggregator=AggregatorEndpoint(
                            connect_host=endpoint.get("host") or base.aggregator.connect_host,
                            bind_host=base.aggregator.bind_host,
                            port=int(endpoint["port"]),
                        ),
                    )
            lifecycle.start_runtime(run_settings)
            from traceml_tpu_torch.sdk.initial import init as sdk_init

            sdk_init(mode="auto", device=device)
            return user_loop(config)
        finally:
            try:
                lifecycle.stop_runtime()
            except Exception as exc:
                get_error_log().warning("ray worker runtime stop failed", exc)
            if actor is not None:
                try:
                    ray.get(actor.finalize.remote(), timeout=60)
                except Exception as exc:
                    get_error_log().warning("ray aggregator stop failed", exc)
                try:
                    # the detached actor must not outlive the job: a later
                    # run would resolve a dead aggregator
                    ray.kill(actor)
                except Exception:
                    pass

    return wrapped
