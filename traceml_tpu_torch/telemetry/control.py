"""Control messages sharing the telemetry channel.

Counterpart of ``traceml_tpu/telemetry/control.py``, with the four
messages of the port's run path:

* ``rank_finished`` — the end-of-run marker the aggregator counts
  against the expected world size before it finalizes;
* ``producer_stats`` — the rank publisher's own cost (collect, encode
  and send time, idle ticks, codec), kept latest-per-rank and written
  into ``ingest_stats.json`` under ``producers``;
* ``rank_heartbeat`` — a beacon on idle ticks, so a silent rank that is
  alive stays distinguishable from a dead one;
* ``transport_hello`` — sent once per connection of a rank: the transport it chose
  (``shm``, ``uds``, ``tcp``), its codec and, when the ring failed to set
  up, ``fallback_from``; kept latest-per-rank under ``transports.ranks``
  in ``ingest_stats.json``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional

CONTROL_KEY = "_traceml_control"
RANK_FINISHED = "rank_finished"
PRODUCER_STATS = "producer_stats"
RANK_HEARTBEAT = "rank_heartbeat"
TRANSPORT_HELLO = "transport_hello"


def build_rank_finished(identity_meta: Mapping[str, Any]) -> Dict[str, Any]:
    return {CONTROL_KEY: RANK_FINISHED, "meta": dict(identity_meta), "timestamp": time.time()}


def build_rank_heartbeat(identity_meta: Mapping[str, Any]) -> Dict[str, Any]:
    return {CONTROL_KEY: RANK_HEARTBEAT, "meta": dict(identity_meta), "timestamp": time.time()}


def build_producer_stats(
    identity_meta: Mapping[str, Any], stats: Mapping[str, Any]
) -> Dict[str, Any]:
    return {
        CONTROL_KEY: PRODUCER_STATS,
        "meta": dict(identity_meta),
        "stats": dict(stats),
        "timestamp": time.time(),
    }


def build_transport_hello(
    identity_meta: Mapping[str, Any],
    kind: Optional[str],
    compression: Optional[str],
    fallback_from: Optional[str] = None,
) -> Dict[str, Any]:
    msg: Dict[str, Any] = {
        CONTROL_KEY: TRANSPORT_HELLO,
        "meta": dict(identity_meta),
        "transport": kind,
        "compression": compression,
        "timestamp": time.time(),
    }
    if fallback_from:
        msg["fallback_from"] = fallback_from
    return msg


def is_control_message(payload: Any) -> bool:
    return isinstance(payload, Mapping) and CONTROL_KEY in payload


def control_kind(payload: Any) -> Optional[str]:
    if not is_control_message(payload):
        return None
    return str(payload[CONTROL_KEY])
