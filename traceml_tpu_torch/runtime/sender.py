"""Telemetry publisher.

Counterpart of ``traceml_tpu/runtime/sender.py``.
Per tick: collect each sampler's incremental payload, stamp it with the
rank's next ``seq``, encode it once, hand the same encoded bytes to the
sampler's disk-backup writer (a v2 frame; nothing is written without
``--disk-backup``) and ship the whole tick as ONE frame.  Without a
client (no aggregator port, a backup only) the backup is all it feeds.

The client is whatever ``transport/select.py`` chose (``transport_info``:
its kind, its codec, ``fallback_from``).  The first batch, or the first
heartbeat of a rank idle throughout, starts with a ``transport_hello``
announcing that choice; it is sent again after the client reconnects
(a TCP redial, a ring's consumer-generation flip), so a restarted
aggregator hears it whatever the spool's replay window still holds.  With a codec, each envelope
goes on the wire wrapped in a compressed carrier
(``transport/compression.py``); the backup keeps the plain bytes, and the
spool stores what went on the wire, so a replay never compresses again.

Fault tolerance, as in JAX: with a spool directory (the runtime gives
``rank_dir(rank)/"spool"``) every batch goes through
:class:`~traceml_tpu_torch.transport.spool.DurableSender`.  A batch the
client cannot send lands in the rank's bounded on-disk replay spool, with
the ring of recent sends that the dead aggregator may not have committed,
and replays on reconnect; the aggregator's SQLite writer drops what it
already holds by ``seq``.  Without a spool a batch the client cannot send
is dropped and counted.  ``seq`` is one counter per rank across every
sampler and control message, with a ``time_ns`` base, so a restarted
rank resumes above every seq its previous incarnation stamped.

Idle ticks cost one ``dirty()`` check per sampler and send nothing but,
every ``TRACEML_HEARTBEAT_INTERVAL_SEC`` seconds (default 3, at least
0.25, as in the JAX package), a ``rank_heartbeat``: the aggregator's
liveness tracker reads a rank that stays silent past its thresholds as
stale, then lost.  A heartbeat is never spooled (a replayed one says
nothing of liveness), but it first tries a replay, so an idle rank
drains its spool as soon as the link heals.

The publisher observes itself: per sampler the envelopes, bytes and the
nanoseconds spent collecting and encoding; per run the nanoseconds spent
handing frames to the socket (``flush_us``) and the number of sends that
time covers (``flushes``), per sampler the microseconds of its backup
writes (``backup_us``), the idle-tick count, the codec, the client's
counters (``kind``, ``reconnects``, ``ring_full_drops`` for the ring),
the compressor's (``compression``: envelopes compressed and passed
through, bytes before and on the wire, their ratio) and the spool's
(``replayed_envelopes``, ``spool_bytes``, ...).  A ``producer_stats`` message rides in the batch it
reports on, so its own send is in neither ``flush_us`` nor ``flushes``:
the flush cost per send is ``flush_us / flushes``.  A ``producer_stats`` control message carries
them to the aggregator on a non-idle tick at most every
``STATS_INTERVAL_S``, and always on the final publish.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from traceml_tpu_torch.samplers.base_sampler import BaseSampler
from traceml_tpu_torch.telemetry.control import (
    build_producer_stats,
    build_rank_heartbeat,
    build_transport_hello,
)
from traceml_tpu_torch.telemetry.envelope import SenderIdentity
from traceml_tpu_torch.transport.compression import EnvelopeCompressor
from traceml_tpu_torch.transport.spool import DurableSender, ReplaySpool
from traceml_tpu_torch.transport.tcp_transport import TCPClient
from traceml_tpu_torch.utils import msgpack_codec
from traceml_tpu_torch.utils.error_log import get_error_log

ENV_HEARTBEAT_INTERVAL = "TRACEML_HEARTBEAT_INTERVAL_SEC"
DEFAULT_HEARTBEAT_INTERVAL_S = 3.0
MIN_HEARTBEAT_INTERVAL_S = 0.25
STATS_INTERVAL_S = 10.0


def heartbeat_interval_from_env() -> float:
    """Seconds between heartbeats: ``TRACEML_HEARTBEAT_INTERVAL_SEC``, 3.0
    when unset or malformed, never below 0.25."""
    raw = os.environ.get(ENV_HEARTBEAT_INTERVAL)
    try:
        value = float(raw) if raw is not None else DEFAULT_HEARTBEAT_INTERVAL_S
    except ValueError:
        value = DEFAULT_HEARTBEAT_INTERVAL_S
    return max(MIN_HEARTBEAT_INTERVAL_S, value)


class TelemetryPublisher:
    def __init__(
        self,
        samplers: List[BaseSampler],
        client: Optional[TCPClient],
        identity: SenderIdentity,
        spool_dir: Optional[Path] = None,
        transport_info: Optional[Dict[str, Any]] = None,
    ) -> None:
        self._samplers = samplers
        self._client = client
        self._identity = identity
        self._transport_info = transport_info or {}
        self._hello_pending = client is not None
        self._hello_reconnects = 0  # the client's reconnects when the hello was last taken
        codec = self._transport_info.get("compression")
        self._compressor = EnvelopeCompressor(codec) if codec else None
        self._durable: Optional[DurableSender] = None
        if client is not None and spool_dir is not None:
            try:
                self._durable = DurableSender(client, ReplaySpool(spool_dir))
            except Exception as exc:
                get_error_log().warning("replay spool unavailable", exc)
        for s in samplers:
            s.sender.set_identity(identity)
        self.ticks = 0
        self.idle_ticks = 0
        self.payloads_sent = 0
        self._flush_ns = 0
        self._flushes = 0
        self._last_stats_emit = time.monotonic()
        self._heartbeat_interval = heartbeat_interval_from_env()
        self._last_heartbeat = 0.0  # monotonic; 0 → the first idle tick sends one
        # per-rank monotonic seq with a time_ns base: a restarted rank
        # resumes above every seq its previous incarnation stamped
        self._seq = time.time_ns()
        self._sampler_stats: Dict[str, Dict[str, int]] = {
            s.name: {"envelopes": 0, "bytes": 0, "collect_ns": 0, "encode_ns": 0, "backup_ns": 0}
            for s in samplers
        }

    def _stamp_seq(self, payload: Dict[str, Any]) -> None:
        self._seq += 1
        payload["meta"]["seq"] = self._seq

    def publish(self, extra_payloads: Optional[List[Dict[str, Any]]] = None, final: bool = False) -> int:
        """Collect and send one tick; returns the payloads in the batch."""
        self.ticks += 1
        if not final and not extra_payloads and not any(
                s.sender.dirty() or s.writer.has_pending() for s in self._samplers):
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
                if payload is not None:
                    self._stamp_seq(payload)
                    enc = msgpack_codec.preencode(payload)
                    st["encode_ns"] += perf() - t1
                    st["envelopes"] += 1
                    st["bytes"] += enc.size()
                    batch.append(self._compressor.wrap(enc) if self._compressor is not None else enc)
                    s.writer.append_envelope(enc)
                elif not (final or s.writer.has_pending()):
                    continue
                # the backup's flush throttle runs on every tick that has
                # something for it, and a final publish forces it out
                t2 = perf()
                s.writer.flush(force=final)
                st["backup_ns"] += perf() - t2
            except Exception as exc:
                get_error_log().warning(f"collect failed for sampler {s.name}", exc)
        for p in extra_payloads or ():
            self._stamp_seq(p)
            batch.append(p)
        if batch:
            hello = self._take_hello()
            if hello is not None:
                batch.insert(0, hello)
        if batch and (final or time.monotonic() - self._last_stats_emit >= STATS_INTERVAL_S):
            self._last_stats_emit = time.monotonic()
            msg = build_producer_stats(self._identity.to_meta(), self.stats())
            self._stamp_seq(msg)
            batch.append(msg)
        if batch and self._client is not None:
            t0 = perf()
            if self._durable is not None:
                sent = self._durable.send(batch)
                self._last_heartbeat = time.monotonic()
            else:
                sent = self._client.send_batch(batch)
                if sent:
                    self._last_heartbeat = time.monotonic()
            self._flush_ns += perf() - t0
            self._flushes += 1
            if sent:
                self.payloads_sent += len(batch)
        return len(batch)

    def _maybe_heartbeat(self) -> None:
        if self._client is None:
            return
        now = time.monotonic()
        if now - self._last_heartbeat < self._heartbeat_interval:
            return
        self._last_heartbeat = now
        hb = build_rank_heartbeat(self._identity.to_meta())
        self._stamp_seq(hb)
        msgs = [hb]
        hello = self._take_hello()  # a rank idle throughout announces itself here
        if hello is not None:
            msgs.insert(0, hello)
        if self._durable is not None:
            self._durable.send_transient(msgs)
        else:
            self._client.send_batch(msgs)

    def _take_hello(self) -> Optional[Dict[str, Any]]:
        """The ``transport_hello``, seq-stamped, once per connection, else None."""
        if self._client is not None and self._client.reconnects != self._hello_reconnects:
            self._hello_reconnects = self._client.reconnects
            self._hello_pending = True
        if not self._hello_pending:
            return None
        self._hello_pending = False
        info = self._transport_info
        hello = build_transport_hello(
            self._identity.to_meta(), info.get("kind") or self._client.kind, info.get("compression"),
            info.get("fallback_from"),
        )
        self._stamp_seq(hello)
        return hello

    def close(self) -> None:
        if self._durable is not None:
            self._durable.close()

    def stats(self) -> Dict[str, Any]:
        """Per-sampler producer cost (microseconds), idle ratio, codec and
        the client's counters."""
        out: Dict[str, Any] = {
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
                    "backup_us": st["backup_ns"] // 1000,
                }
                for name, st in self._sampler_stats.items()
            },
        }
        if self._client is not None:
            transport: Dict[str, Any] = {
                "kind": self._transport_info.get("kind") or self._client.kind,
                "reconnects": self._client.reconnects,
                "batches_sent": self._client.batches_sent,
                "batches_dropped": self._client.batches_dropped,
            }
            ring_full = getattr(self._client, "ring_full_drops", None)  # the shm ring's alone
            if ring_full is not None:
                transport["ring_full_drops"] = ring_full
            if self._compressor is not None:
                transport["compression"] = self._compressor.stats()
            if self._durable is not None:
                transport.update(self._durable.stats())
            out["transport"] = transport
        return out
