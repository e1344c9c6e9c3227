"""Frozen run settings and the ``TRACEML_*`` environment contract.

Counterpart of ``traceml_tpu/runtime/settings.py``, trimmed to what the
TCP transport and the ``summary`` and ``cli`` modes use (no disk backup,
``TRACEML_CAPTURE_STDERR`` opt-out, max-steps, retention, serving or transport-tier fields yet).  The mode
defaults to ``summary`` here, where the JAX settings default to ``cli``:
the launcher always names the mode (``cli`` by default, as the JAX
launcher does), so the default only reaches a runtime started in process,
which has no live display to feed and so does not tee the script's
stdout.  The
environment is the ONLY contract between the launcher and its child
processes: the launcher writes it with :func:`settings_to_env`, the
aggregator and every rank read it back with :func:`settings_from_env`,
under the same variable names as the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Optional

ENV_SESSION_ID = "TRACEML_SESSION_ID"
ENV_LOGS_DIR = "TRACEML_LOGS_DIR"
ENV_MODE = "TRACEML_MODE"
ENV_AGG_HOST = "TRACEML_AGGREGATOR_HOST"
ENV_AGG_BIND_HOST = "TRACEML_AGGREGATOR_BIND_HOST"
ENV_AGG_PORT = "TRACEML_AGGREGATOR_PORT"  # 0 = no aggregator: rows stay in the rank
ENV_SAMPLER_INTERVAL = "TRACEML_SAMPLER_INTERVAL_SEC"
ENV_DISABLE = "TRACEML_DISABLE"
ENV_RUN_NAME = "TRACEML_RUN_NAME"
ENV_EXPECTED_WORLD_SIZE = "TRACEML_EXPECTED_WORLD_SIZE"
ENV_FINALIZE_TIMEOUT = "TRACEML_FINALIZE_TIMEOUT_SEC"
ENV_SCRIPT = "TRACEML_SCRIPT"
ENV_SCRIPT_ARGS = "TRACEML_SCRIPT_ARGS"

_TRUTHY = ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class AggregatorEndpoint:
    """Where ranks dial (``connect_host``) and where the aggregator
    binds (``bind_host``); port 0 binds an ephemeral port."""

    connect_host: str = "127.0.0.1"
    bind_host: str = "127.0.0.1"
    port: int = 0


@dataclasses.dataclass(frozen=True)
class TraceMLSettings:
    session_id: str = "local"
    logs_dir: Path = Path("./traceml_logs")
    mode: str = "summary"
    aggregator: AggregatorEndpoint = dataclasses.field(default_factory=AggregatorEndpoint)
    sampler_interval_sec: float = 1.0
    disabled: bool = False
    run_name: Optional[str] = None
    expected_world_size: Optional[int] = None
    finalize_timeout_sec: float = 300.0

    @property
    def session_dir(self) -> Path:
        return Path(self.logs_dir) / self.session_id

    def rank_dir(self, global_rank: int) -> Path:
        return self.session_dir / f"rank_{global_rank}"


def _float(raw: Optional[str], fallback: float) -> float:
    try:
        return float(raw) if raw is not None else fallback
    except ValueError:
        return fallback


def _int(raw: Optional[str], fallback: int) -> int:
    try:
        return int(raw.strip()) if raw is not None else fallback
    except ValueError:
        return fallback


def settings_from_env() -> TraceMLSettings:
    """The child-side half of the contract.  Malformed numbers fall back
    to their defaults: the environment must never keep a script from
    running."""
    e = os.environ
    connect_host = e.get(ENV_AGG_HOST) or "127.0.0.1"
    expected_ws = _int(e.get(ENV_EXPECTED_WORLD_SIZE), 0)
    return TraceMLSettings(
        session_id=e.get(ENV_SESSION_ID) or "local",
        logs_dir=Path(e.get(ENV_LOGS_DIR) or "./traceml_logs"),
        mode=e.get(ENV_MODE) or "summary",
        aggregator=AggregatorEndpoint(
            connect_host=connect_host,
            bind_host=e.get(ENV_AGG_BIND_HOST) or connect_host,
            port=_int(e.get(ENV_AGG_PORT), 0),
        ),
        sampler_interval_sec=_float(e.get(ENV_SAMPLER_INTERVAL), 1.0),
        disabled=str(e.get(ENV_DISABLE, "")).strip().lower() in _TRUTHY,
        run_name=e.get(ENV_RUN_NAME) or None,
        expected_world_size=expected_ws or None,
        finalize_timeout_sec=_float(e.get(ENV_FINALIZE_TIMEOUT), 300.0),
    )


def settings_to_env(s: TraceMLSettings) -> Dict[str, str]:
    """The launcher-side half of the contract."""
    env = {
        ENV_SESSION_ID: s.session_id,
        ENV_LOGS_DIR: str(s.logs_dir),
        ENV_MODE: s.mode,
        ENV_AGG_HOST: s.aggregator.connect_host,
        ENV_AGG_BIND_HOST: s.aggregator.bind_host,
        ENV_AGG_PORT: str(s.aggregator.port),
        ENV_SAMPLER_INTERVAL: str(s.sampler_interval_sec),
        ENV_FINALIZE_TIMEOUT: str(s.finalize_timeout_sec),
    }
    if s.disabled:
        env[ENV_DISABLE] = "1"
    if s.run_name:
        env[ENV_RUN_NAME] = s.run_name
    if s.expected_world_size is not None:
        env[ENV_EXPECTED_WORLD_SIZE] = str(s.expected_world_size)
    return env
