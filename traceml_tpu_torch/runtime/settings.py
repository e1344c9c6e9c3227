"""Frozen run settings and the ``TRACEML_*`` environment contract.

Counterpart of ``traceml_tpu/runtime/settings.py``, trimmed to what the
port's run path and its three display modes use (no serving-tier
fields).  It carries the transport tier's fields with the JAX defaults
and variable names (``transport/select.py`` reads them on both ends):
``transport`` (``TRACEML_TRANSPORT``: auto, shm, uds or tcp; auto),
``transport_compress`` (``TRACEML_TRANSPORT_COMPRESS``: auto, zstd, zlib
or off; auto), ``shm_ring_bytes`` (``TRACEML_SHM_RING_BYTES``, 4194304),
``shm_dir`` (``TRACEML_SHM_DIR``, unset: ``/dev/shm``) and ``uds_path``
(``TRACEML_UDS_PATH``, unset: derived from the session directory).  It
carries the bounded-run fields with the JAX defaults and variable names:
``trace_max_steps`` (``TRACEML_TRACE_MAX_STEPS``, unset = every step),
``disk_backup`` (``TRACEML_DISK_BACKUP``), ``capture_stderr``
(``TRACEML_CAPTURE_STDERR``, on when unset) and
``summary_window_rows`` (``TRACEML_SUMMARY_WINDOW_ROWS``, 10000: the
SQLite writer keeps 1.5x that many rows per table and rank).  Two
variables are read in the rank's process on every call, as the JAX
flags are: ``TRACEML_COLLECTIVES`` (:func:`collectives_enabled`, on unless
0) and ``TRACEML_MESH`` (:func:`mesh_spec`, the mesh override of
``utils/topology.py``).  The mode
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
ENV_MAX_STEPS = "TRACEML_TRACE_MAX_STEPS"
ENV_DISABLE = "TRACEML_DISABLE"
ENV_DISK_BACKUP = "TRACEML_DISK_BACKUP"
ENV_CAPTURE_STDERR = "TRACEML_CAPTURE_STDERR"
ENV_RUN_NAME = "TRACEML_RUN_NAME"
ENV_EXPECTED_WORLD_SIZE = "TRACEML_EXPECTED_WORLD_SIZE"
ENV_FINALIZE_TIMEOUT = "TRACEML_FINALIZE_TIMEOUT_SEC"
ENV_SUMMARY_WINDOW_ROWS = "TRACEML_SUMMARY_WINDOW_ROWS"
ENV_TRANSPORT = "TRACEML_TRANSPORT"
ENV_TRANSPORT_COMPRESS = "TRACEML_TRANSPORT_COMPRESS"
ENV_SHM_RING_BYTES = "TRACEML_SHM_RING_BYTES"
ENV_SHM_DIR = "TRACEML_SHM_DIR"
ENV_UDS_PATH = "TRACEML_UDS_PATH"
ENV_COLLECTIVES = "TRACEML_COLLECTIVES"  # 0 turns every collectives capture into a no-op
ENV_MESH = "TRACEML_MESH"  # mesh override, name:size[@kind],... (utils/topology.py)
ENV_SCRIPT = "TRACEML_SCRIPT"
ENV_SCRIPT_ARGS = "TRACEML_SCRIPT_ARGS"

_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "off")


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
    trace_max_steps: Optional[int] = None
    disabled: bool = False
    disk_backup: bool = False
    capture_stderr: bool = True
    run_name: Optional[str] = None
    expected_world_size: Optional[int] = None
    finalize_timeout_sec: float = 300.0
    summary_window_rows: int = 10000
    transport: str = "auto"
    transport_compress: str = "auto"
    shm_ring_bytes: int = 4194304
    shm_dir: Optional[str] = None
    uds_path: Optional[str] = None

    @property
    def session_dir(self) -> Path:
        return Path(self.logs_dir) / self.session_id

    def rank_dir(self, global_rank: int) -> Path:
        return self.session_dir / f"rank_{global_rank}"

    def to_dict(self) -> Dict[str, object]:
        """JSON-safe dict (the hand-off to a Ray actor or a subprocess)."""
        d = dataclasses.asdict(self)
        d["logs_dir"] = str(self.logs_dir)
        return d

    @classmethod
    def from_dict(cls, data: Dict[str, object]) -> "TraceMLSettings":
        """The settings of :meth:`to_dict`; unknown keys are dropped."""
        data = dict(data)
        agg = data.get("aggregator")
        if isinstance(agg, dict):
            data["aggregator"] = AggregatorEndpoint(**agg)
        if "logs_dir" in data:
            data["logs_dir"] = Path(str(data["logs_dir"]))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


def _float(raw: Optional[str], fallback: float) -> float:
    try:
        return float(raw) if raw is not None else fallback
    except ValueError:
        return fallback


def _int(raw: Optional[str], fallback: Optional[int]) -> Optional[int]:
    try:
        return int(raw.strip()) if raw is not None else fallback
    except ValueError:
        return fallback


def _truthy(raw: Optional[str]) -> bool:
    return raw is not None and str(raw).strip().lower() in _TRUTHY


def collectives_enabled() -> bool:
    """``TRACEML_COLLECTIVES``, read on every call as in JAX: on unless
    it reads 0, false or off."""
    v = os.environ.get(ENV_COLLECTIVES)
    return v is None or v.strip().lower() not in _FALSY


def mesh_spec() -> Optional[str]:
    """The ``TRACEML_MESH`` override, or None when unset or empty."""
    return os.environ.get(ENV_MESH) or None


def settings_from_env(env: Optional[Dict[str, str]] = None) -> TraceMLSettings:
    """The child-side half of the contract, read from ``os.environ`` or
    from ``env``.  Malformed numbers fall back to their defaults: the
    environment must never keep a script from running."""
    e = os.environ if env is None else env
    connect_host = e.get(ENV_AGG_HOST) or "127.0.0.1"
    expected_ws = _int(e.get(ENV_EXPECTED_WORLD_SIZE), 0)
    max_steps = e.get(ENV_MAX_STEPS)
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
        trace_max_steps=_int(max_steps, None) if max_steps else None,
        disabled=_truthy(e.get(ENV_DISABLE)),
        disk_backup=_truthy(e.get(ENV_DISK_BACKUP)),
        capture_stderr=_truthy(e.get(ENV_CAPTURE_STDERR, "1")),
        run_name=e.get(ENV_RUN_NAME) or None,
        expected_world_size=expected_ws or None,
        finalize_timeout_sec=_float(e.get(ENV_FINALIZE_TIMEOUT), 300.0),
        summary_window_rows=_int(e.get(ENV_SUMMARY_WINDOW_ROWS), 10000),
        transport=e.get(ENV_TRANSPORT) or "auto",
        transport_compress=e.get(ENV_TRANSPORT_COMPRESS) or "auto",
        shm_ring_bytes=_int(e.get(ENV_SHM_RING_BYTES), 4194304),
        shm_dir=e.get(ENV_SHM_DIR) or None,
        uds_path=e.get(ENV_UDS_PATH) or None,
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
        ENV_CAPTURE_STDERR: "1" if s.capture_stderr else "0",
        ENV_FINALIZE_TIMEOUT: str(s.finalize_timeout_sec),
        ENV_SUMMARY_WINDOW_ROWS: str(s.summary_window_rows),
    }
    if s.trace_max_steps is not None:
        env[ENV_MAX_STEPS] = str(s.trace_max_steps)
    if s.disabled:
        env[ENV_DISABLE] = "1"
    if s.disk_backup:
        env[ENV_DISK_BACKUP] = "1"
    if s.run_name:
        env[ENV_RUN_NAME] = s.run_name
    if s.expected_world_size is not None:
        env[ENV_EXPECTED_WORLD_SIZE] = str(s.expected_world_size)
    if s.transport != "auto":
        env[ENV_TRANSPORT] = s.transport
    if s.transport_compress != "auto":
        env[ENV_TRANSPORT_COMPRESS] = s.transport_compress
    if s.shm_ring_bytes != 4194304:
        env[ENV_SHM_RING_BYTES] = str(s.shm_ring_bytes)
    if s.shm_dir:
        env[ENV_SHM_DIR] = s.shm_dir
    if s.uds_path:
        env[ENV_UDS_PATH] = s.uds_path
    return env
