"""Transport selection: shm ring, Unix socket or TCP.

Counterpart of ``traceml_tpu/transport/select.py``, with the same policy
(``TRACEML_TRANSPORT``):

``auto``  the default: an aggregator on loopback → the shm ring; else the
          Unix socket when a path was given (``TRACEML_UDS_PATH``); else
          TCP.
``shm``   the ring; a ring that fails to set up falls back to TCP, with
          ``fallback_from: "shm"`` in the rank's ``transport_hello``.
``uds``   the Unix-domain stream.
``tcp``   plain TCP, exactly the transport before the tier: no Unix
          listener, no ring registry, no compression on loopback, the
          0.5 s selector tick.

Compression (``TRACEML_TRANSPORT_COMPRESS``): ``auto`` turns the best
codec on only for a cross-host TCP link; a codec named explicitly turns
it on for any stream transport; shm frames are never compressed.

The rank side calls :func:`create_transport_client`; the aggregator side
mirrors the choice with :func:`server_transport_config`, so both ends
read the same settings.  Everything here fails open: a broken fast path
degrades to TCP, never into training code.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from traceml_tpu_torch.transport import compression, shm_ring
from traceml_tpu_torch.transport.tcp_transport import TCPClient, UDSClient
from traceml_tpu_torch.utils.error_log import get_error_log

_LOOPBACK_HOSTS = ("127.0.0.1", "localhost", "::1", "0.0.0.0")
_OFF = ("", "0", "false", "off", "none")
_ON = ("auto", "1", "true", "yes", "on")
# sun_path holds 108 bytes with its NUL
_UDS_PATH_MAX = 107


def is_same_host(connect_host: str) -> bool:
    """True when the aggregator is reachable without leaving the machine."""
    return str(connect_host).strip().lower() in _LOOPBACK_HOSTS


def default_uds_path(session_dir: Path) -> str:
    """The socket path both ends derive from the session directory.

    The name is the JAX package's (a digest of the resolved session
    directory and the uid, short and collision-free per session); it lies
    in the process's temporary directory, or in ``/tmp`` (the JAX
    package's place) when that path would not fit a Unix socket address.
    """
    digest = hashlib.sha1(f"{Path(session_dir).resolve()}:{os.getuid()}".encode()).hexdigest()[:12]
    name = f"traceml-{digest}.sock"
    path = os.path.join(tempfile.gettempdir(), name)
    return path if len(path.encode()) <= _UDS_PATH_MAX else os.path.join("/tmp", name)


def choose_transport(transport: str, connect_host: str, uds_path: Optional[str]) -> str:
    """The configured mode resolved to a concrete kind."""
    mode = (transport or "auto").strip().lower()
    if mode in ("tcp", "uds", "shm"):
        return mode
    if is_same_host(connect_host):
        return "shm"
    if uds_path:
        return "uds"
    return "tcp"


def resolve_compression(transport_kind: str, requested: str, connect_host: str = "") -> Optional[str]:
    """The codec the publisher wraps envelopes with, or None."""
    req = (requested or "auto").strip().lower()
    if req in _OFF or transport_kind == "shm":
        return None
    if req in _ON:
        # only a cross-host TCP link pays per byte; loopback TCP (the
        # forced tcp arm too) keeps the wire of the transport before the tier
        if transport_kind != "tcp" or is_same_host(connect_host):
            return None
        return compression.resolve_codec("auto")
    return compression.resolve_codec(req)


def create_transport_client(settings: Any, global_rank: int) -> Tuple[Optional[TCPClient], Dict[str, Any]]:
    """The rank's telemetry client for ``settings`` and what was chosen:
    ``{"kind", "compression"}``, plus ``fallback_from`` when the ring
    failed to set up and TCP took over.  No aggregator port, no client."""
    connect_host = settings.aggregator.connect_host
    port = settings.aggregator.port
    if not port:
        return None, {"kind": None, "compression": None}
    kind = choose_transport(settings.transport, connect_host, settings.uds_path)
    info: Dict[str, Any] = {"kind": kind, "compression": None}
    client: Optional[TCPClient] = None
    if kind == "shm":
        try:
            path = shm_ring.ring_segment_path(
                settings.session_dir, global_rank, Path(settings.shm_dir) if settings.shm_dir else None
            )
            client = shm_ring.ShmRingClient(  # type: ignore[assignment]
                path, capacity=settings.shm_ring_bytes, session_dir=settings.session_dir,
                global_rank=global_rank,
            )
        except Exception as exc:  # an unwritable dir, a failed mmap: degrade to TCP
            get_error_log().warning("shm ring setup failed; falling back to tcp", exc)
            info["fallback_from"] = "shm"
            kind = info["kind"] = "tcp"
    if kind == "uds":
        client = UDSClient(settings.uds_path or default_uds_path(settings.session_dir))
    elif client is None:
        client = TCPClient(connect_host, port)
        kind = info["kind"] = "tcp"
    info["compression"] = resolve_compression(kind, settings.transport_compress, connect_host)
    return client, info


def server_transport_config(settings: Any) -> Dict[str, Any]:
    """The aggregator's side of the choice: the Unix socket it listens on
    and whether it polls rings.  ``tcp`` gives neither.  An unknown mode
    reads as ``auto`` here as in :func:`choose_transport` (the JAX
    function gives it neither, so its ranks would write rings that no one
    polls)."""
    mode = (settings.transport or "auto").strip().lower()
    if mode not in ("shm", "uds", "tcp"):
        mode = "auto"
    out: Dict[str, Any] = {"uds_path": None, "enable_rings": False}
    if mode == "tcp":
        return out
    if mode in ("auto", "uds"):
        out["uds_path"] = settings.uds_path or default_uds_path(settings.session_dir)
    if mode in ("auto", "shm"):
        out["enable_rings"] = True
    return out
