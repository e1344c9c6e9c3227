"""Control messages sharing the telemetry channel.

Counterpart of ``traceml_tpu/telemetry/control.py``, with the three
messages of the TCP path:

* ``rank_finished`` — the end-of-run marker the aggregator counts
  against the expected world size before it finalizes;
* ``producer_stats`` — the rank publisher's own cost (collect, encode
  and send time, idle ticks, codec), kept latest-per-rank and written
  into ``ingest_stats.json`` under ``producers``;
* ``rank_heartbeat`` — a beacon on idle ticks, so a silent rank that is
  alive stays distinguishable from a dead one.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional

CONTROL_KEY = "_traceml_control"
RANK_FINISHED = "rank_finished"
PRODUCER_STATS = "producer_stats"
RANK_HEARTBEAT = "rank_heartbeat"


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


def is_control_message(payload: Any) -> bool:
    return isinstance(payload, Mapping) and CONTROL_KEY in payload


def control_kind(payload: Any) -> Optional[str]:
    if not is_control_message(payload):
        return None
    return str(payload[CONTROL_KEY])
