"""Telemetry publisher.

Counterpart of ``traceml_tpu/runtime/sender.py`` without the durable
spool, the disk backup and compression.  Per tick: collect each
sampler's incremental payload, stamp it with the rank's next ``seq``,
encode it once, and ship the whole tick as ONE frame.  Best-effort all
the way down: a batch the client cannot send is dropped and counted.

Idle ticks cost one ``dirty()`` check per sampler and send nothing but,
every ``HEARTBEAT_INTERVAL_S``, a ``rank_heartbeat``.

The publisher observes itself: per sampler the envelopes, bytes and the
nanoseconds spent collecting and encoding; per run the nanoseconds spent
handing frames to the socket (``flush_us``: the port has no disk backup,
so the socket send is the tick's flush) and the number of sends that
time covers (``flushes``), the idle-tick count, the codec and the
client's counters.  A ``producer_stats`` message rides in the batch it
reports on, so its own send is in neither ``flush_us`` nor ``flushes``:
the flush cost per send is ``flush_us / flushes``.  A ``producer_stats`` control message carries
them to the aggregator on a non-idle tick at most every
``STATS_INTERVAL_S``, and always on the final publish.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from traceml_tpu_torch.samplers.base_sampler import BaseSampler
from traceml_tpu_torch.telemetry.control import build_producer_stats, build_rank_heartbeat
from traceml_tpu_torch.telemetry.envelope import SenderIdentity
from traceml_tpu_torch.transport.tcp_transport import TCPClient
from traceml_tpu_torch.utils import msgpack_codec
from traceml_tpu_torch.utils.error_log import get_error_log

HEARTBEAT_INTERVAL_S = 3.0
STATS_INTERVAL_S = 10.0


class TelemetryPublisher:
    def __init__(
        self,
        samplers: List[BaseSampler],
        client: TCPClient,
        identity: SenderIdentity,
    ) -> None:
        self._samplers = samplers
        self._client = client
        self._identity = identity
        for s in samplers:
            s.sender.set_identity(identity)
        self.ticks = 0
        self.idle_ticks = 0
        self.payloads_sent = 0
        self._flush_ns = 0
        self._flushes = 0
        self._last_stats_emit = time.monotonic()
        self._last_heartbeat = 0.0  # monotonic; 0 → the first idle tick sends one
        # per-rank monotonic seq with a time_ns base: a restarted rank
        # resumes above every seq its previous incarnation stamped
        self._seq = time.time_ns()
        self._sampler_stats: Dict[str, Dict[str, int]] = {
            s.name: {"envelopes": 0, "bytes": 0, "collect_ns": 0, "encode_ns": 0}
            for s in samplers
        }

    def _stamp_seq(self, payload: Dict[str, Any]) -> None:
        self._seq += 1
        payload["meta"]["seq"] = self._seq

    def publish(self, extra_payloads: Optional[List[Dict[str, Any]]] = None, final: bool = False) -> int:
        """Collect and send one tick; returns the payloads in the batch."""
        self.ticks += 1
        if not final and not extra_payloads and not any(s.sender.dirty() for s in self._samplers):
            self.idle_ticks += 1
            self._maybe_heartbeat()
            return 0
        batch: List[Any] = []
        perf = time.perf_counter_ns
        for s in self._samplers:
            st = self._sampler_stats[s.name]
            try:
                t0 = perf()
                payload = s.sender.collect_payload()
                t1 = perf()
                st["collect_ns"] += t1 - t0
                if payload is None:
                    continue
                self._stamp_seq(payload)
                enc = msgpack_codec.preencode(payload)
                st["encode_ns"] += perf() - t1
                st["envelopes"] += 1
                st["bytes"] += enc.size()
                batch.append(enc)
            except Exception as exc:
                get_error_log().warning(f"collect failed for sampler {s.name}", exc)
        for p in extra_payloads or ():
            self._stamp_seq(p)
            batch.append(p)
        if batch and (final or time.monotonic() - self._last_stats_emit >= STATS_INTERVAL_S):
            self._last_stats_emit = time.monotonic()
            msg = build_producer_stats(self._identity.to_meta(), self.stats())
            self._stamp_seq(msg)
            batch.append(msg)
        if batch:
            t0 = perf()
            sent = self._client.send_batch(batch)
            self._flush_ns += perf() - t0
            self._flushes += 1
            if sent:
                self.payloads_sent += len(batch)
                self._last_heartbeat = time.monotonic()
        return len(batch)

    def _maybe_heartbeat(self) -> None:
        now = time.monotonic()
        if now - self._last_heartbeat < HEARTBEAT_INTERVAL_S:
            return
        self._last_heartbeat = now
        hb = build_rank_heartbeat(self._identity.to_meta())
        self._stamp_seq(hb)
        self._client.send_batch([hb])

    def stats(self) -> Dict[str, Any]:
        """Per-sampler producer cost (microseconds), idle ratio, codec and
        the client's counters."""
        return {
            "ticks": self.ticks,
            "idle_ticks": self.idle_ticks,
            "idle_ratio": (self.idle_ticks / self.ticks) if self.ticks else 0.0,
            "payloads_sent": self.payloads_sent,
            "codec": msgpack_codec.codec_name(),
            "flush_us": self._flush_ns // 1000,
            "flushes": self._flushes,
            "samplers": {
                name: {
                    "envelopes": st["envelopes"],
                    "bytes": st["bytes"],
                    "collect_us": st["collect_ns"] // 1000,
                    "encode_us": st["encode_ns"] // 1000,
                }
                for name, st in self._sampler_stats.items()
            },
            "transport": {
                "kind": self._client.kind,
                "reconnects": self._client.reconnects,
                "batches_sent": self._client.batches_sent,
                "batches_dropped": self._client.batches_dropped,
            },
        }
