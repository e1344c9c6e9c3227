"""Telemetry transport, the counterpart of ``traceml_tpu/transport/``.

The tiers: the same-host shared-memory ring (``shm_ring``), the
Unix-domain stream (``UDSClient``), TCP, and per-envelope compression
(``compression``); ``select.choose_transport`` picks one (the ring for an
aggregator on loopback) and ``TRACEML_TRANSPORT`` overrides it.
``spool`` holds the durable send path that replays over any of them.
"""

from traceml_tpu_torch.transport.tcp_transport import TCPClient, TCPServer, UDSClient  # noqa: F401
from traceml_tpu_torch.transport.select import (  # noqa: F401
    choose_transport,
    create_transport_client,
    default_uds_path,
)
