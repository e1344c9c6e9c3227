"""Bounded on-disk replay spool and the durable send path.

Counterpart of ``traceml_tpu/transport/spool.py``, with the same frame
format, limits and replay rules.  When a rank's TCP send fails, the
envelopes' encoded bodies (each ``EncodedPayload``'s bare msgpack bytes,
encoded once by the publisher) are appended to a per-rank spool on disk
and replayed on reconnect.  The aggregator's SQLite writer drops replayed
envelopes by their per-rank sequence number (``meta.seq``), so replaying
too much is always safe and the spool needs no acknowledgement protocol.

Spool frame format (``TMS1``), one frame per envelope::

    b"TMS1" | u32 len | u64 seq | raw msgpack body (NO codec prefix)

``len`` counts the seq field and the body, so a reader skips a frame
without decoding it and replay splices the bodies into a batch frame
behind ``pack_array_header`` with no second encode.  Storage is split
into segments (``<time_ns>.seg``; name order is append order) of 4 MiB;
the 64 MiB bound evicts whole segments, oldest first, and counts what it
evicts.  A torn tail (the process died mid-append) ends the read cleanly.
Each process lifetime appends to a fresh segment, so nothing is ever
appended after a torn tail.

Control messages (``rank_finished``, ``producer_stats``) replay
idempotently without dedup (the aggregator's handlers add to a set or
keep the latest), so the spool does not tell them apart.
"""

from __future__ import annotations

import struct
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

from traceml_tpu_torch.utils import msgpack_codec
from traceml_tpu_torch.utils.error_log import get_error_log

SPOOL_MAGIC = b"TMS1"
_HEADER = struct.Struct(">4sIQ")  # magic, len(seq + body), seq
_SEQ_BYTES = 8

_DEFAULT_MAX_BYTES = 64 * 1024 * 1024
_DEFAULT_SEGMENT_BYTES = 4 * 1024 * 1024
# sanity bound against a corrupt length field when scanning a segment
_MAX_FRAME_BYTES = 256 * 1024 * 1024


class _Segment:
    __slots__ = ("path", "frames", "bytes", "first_seq", "last_seq")

    def __init__(self, path: Path) -> None:
        self.path = path
        self.frames = 0
        self.bytes = 0
        self.first_seq: Optional[int] = None
        self.last_seq: Optional[int] = None


def _scan_segment(path: Path) -> Tuple[_Segment, bool]:
    """Walk a segment's headers; returns (metadata, clean_tail)."""
    seg = _Segment(path)
    clean = True
    try:
        with path.open("rb") as f:
            while True:
                header = f.read(_HEADER.size)
                if not header:
                    break
                if len(header) < _HEADER.size:
                    clean = False
                    break
                magic, n, seq = _HEADER.unpack(header)
                if magic != SPOOL_MAGIC or n < _SEQ_BYTES or n > _MAX_FRAME_BYTES:
                    clean = False
                    break
                body_len = n - _SEQ_BYTES
                here = f.tell()
                f.seek(0, 2)
                end = f.tell()
                if end - here < body_len:
                    clean = False
                    break
                f.seek(here + body_len)
                if seg.first_seq is None:
                    seg.first_seq = seq
                seg.last_seq = seq
                seg.frames += 1
                seg.bytes += _HEADER.size - _SEQ_BYTES + n
    except OSError:
        clean = False
    return seg, clean


class ReplaySpool:
    """Bounded, segmented on-disk queue of (seq, raw body) frames.

    One producer and one consumer on the same thread (the publisher's
    tick); not thread-safe by design: the runtime's tick thread and its
    final drain never run at once.
    """

    def __init__(
        self,
        directory: Path,
        max_bytes: int = _DEFAULT_MAX_BYTES,
        segment_bytes: int = _DEFAULT_SEGMENT_BYTES,
    ) -> None:
        self.directory = Path(directory)
        self.max_bytes = int(max_bytes)
        self.segment_bytes = int(segment_bytes)
        self._segments: List[_Segment] = []
        self._write_file = None  # opened lazily: the tail segment's handle
        self.appended_frames = 0
        self.evicted_frames = 0  # evicted by the size bound: lost, and counted
        self.evicted_bytes = 0
        self.torn_tails = 0
        self._recover()

    # -- recovery -------------------------------------------------------
    def _recover(self) -> None:
        try:
            self.directory.mkdir(parents=True, exist_ok=True)
            paths = sorted(self.directory.glob("*.seg"))
        except OSError as exc:
            get_error_log().warning("spool dir unavailable", exc)
            paths = []
        for path in paths:
            seg, clean = _scan_segment(path)
            if not clean:
                self.torn_tails += 1
            if seg.frames == 0:
                try:
                    path.unlink()
                except OSError:
                    pass
                continue
            self._segments.append(seg)

    # -- write side -----------------------------------------------------
    def append(self, seq: int, raw: bytes) -> bool:
        """Spool one envelope body; False only when the filesystem fails."""
        frame = _HEADER.pack(SPOOL_MAGIC, _SEQ_BYTES + len(raw), seq) + raw
        try:
            f = self._writable(len(frame))
            f.write(frame)
            f.flush()
        except OSError as exc:
            get_error_log().warning("spool append failed", exc)
            return False
        seg = self._segments[-1]
        if seg.first_seq is None:
            seg.first_seq = seq
        seg.last_seq = seq
        seg.frames += 1
        seg.bytes += len(frame)
        self.appended_frames += 1
        self._enforce_bound()
        return True

    def _writable(self, incoming: int):
        """The write handle, on a new segment when the tail one is full.
        A recovered (pre-restart) tail is never appended to: its last
        frame may be torn."""
        if self._write_file is not None:
            seg = self._segments[-1]
            if seg.bytes + incoming <= self.segment_bytes:
                return self._write_file
            self._write_file.close()
            self._write_file = None
        # named by wall-clock nanoseconds: above every recovered segment
        # (which held older appends), so name order stays append order
        # across restarts
        path = self.directory / f"{time.time_ns():020d}.seg"
        self._write_file = path.open("ab")
        self._segments.append(_Segment(path))
        return self._write_file

    def _enforce_bound(self) -> None:
        while self.pending_bytes() > self.max_bytes and len(self._segments) > 1:
            self._drop_segment(0, evicted=True)

    def _drop_segment(self, index: int, evicted: bool = False) -> None:
        seg = self._segments.pop(index)
        if evicted:
            self.evicted_frames += seg.frames
            self.evicted_bytes += seg.bytes
        try:
            seg.path.unlink()
        except OSError:
            pass

    # -- read side ------------------------------------------------------
    def pending_frames(self) -> int:
        return sum(s.frames for s in self._segments)

    def pending_bytes(self) -> int:
        return sum(s.bytes for s in self._segments)

    def max_seq(self) -> Optional[int]:
        seqs = [s.last_seq for s in self._segments if s.last_seq is not None]
        return max(seqs) if seqs else None

    def iter_frames(self) -> Iterator[Tuple[int, bytes]]:
        """Yield (seq, raw body) across segments in append order,
        stopping cleanly at a torn tail."""
        for seg in list(self._segments):
            try:
                with seg.path.open("rb") as f:
                    while True:
                        header = f.read(_HEADER.size)
                        if len(header) < _HEADER.size:
                            break
                        magic, n, seq = _HEADER.unpack(header)
                        if magic != SPOOL_MAGIC or n < _SEQ_BYTES or n > _MAX_FRAME_BYTES:
                            break
                        body = f.read(n - _SEQ_BYTES)
                        if len(body) < n - _SEQ_BYTES:
                            break
                        yield seq, body
            except OSError:
                continue

    def consume_through(self, seq: int) -> None:
        """Drop the segments replayed in full (last_seq <= seq).  A
        segment replayed in part stays: its sent prefix replays again on
        the next reconnect and the aggregator drops it as a duplicate."""
        while self._segments:
            seg = self._segments[0]
            if seg.last_seq is None or seg.last_seq > seq:
                break
            if self._write_file is not None and seg is self._segments[-1]:
                self._write_file.close()
                self._write_file = None
            self._drop_segment(0)

    def clear(self) -> None:
        if self._write_file is not None:
            self._write_file.close()
            self._write_file = None
        while self._segments:
            self._drop_segment(0)

    def close(self) -> None:
        if self._write_file is not None:
            try:
                self._write_file.close()
            except OSError:
                pass
            self._write_file = None


class DurableSender:
    """The send path with a replay spool behind it.

    Healthy link: one ``pending_frames()`` check per publish; the batch
    goes straight to ``TCPClient.send_batch`` and into a bounded
    in-memory ring of recently sent bodies.  A TCP send that succeeded is
    NOT a commit by the aggregator (group-commit lag, the kernel's socket
    buffers): when a later send fails, the ring (strictly older than the
    failed batch) goes to the spool first, so the sent-but-maybe-
    uncommitted window replays too and the writer's dedup drops what the
    database already holds.

    Broken link: new batches append to the spool; each send first tries
    to drain the spool in bounded replay batches.
    """

    def __init__(
        self,
        client,
        spool: ReplaySpool,
        ring_envelopes: int = 512,
        ring_bytes: int = 8 * 1024 * 1024,
        replay_batch: int = 64,
    ) -> None:
        self._client = client
        self._spool = spool
        self._ring: List[Tuple[int, bytes]] = []
        self._ring_bytes = 0
        self._ring_max_envelopes = int(ring_envelopes)
        self._ring_max_bytes = int(ring_bytes)
        self._replay_batch = int(replay_batch)
        self.replayed_envelopes = 0
        self.spooled_envelopes = 0
        self.spool_send_failures = 0  # payloads without a msgpack body: the spool cannot hold them

    # -- helpers --------------------------------------------------------
    @staticmethod
    def _raw_of(payload: Any) -> Optional[bytes]:
        if isinstance(payload, msgpack_codec.EncodedPayload):
            return payload.raw
        return msgpack_codec.preencode(payload).raw

    @staticmethod
    def _seq_of(payload: Any) -> int:
        obj = payload.obj if isinstance(payload, msgpack_codec.EncodedPayload) else payload
        try:
            return int((obj.get("meta") or {}).get("seq", 0))
        except (AttributeError, TypeError, ValueError):
            return 0

    def _ring_add(self, batch: List[Any]) -> None:
        for p in batch:
            raw = self._raw_of(p)
            if raw is None:
                continue
            self._ring.append((self._seq_of(p), raw))
            self._ring_bytes += len(raw)
        while self._ring and (
            len(self._ring) > self._ring_max_envelopes or self._ring_bytes > self._ring_max_bytes
        ):
            _, old = self._ring.pop(0)
            self._ring_bytes -= len(old)

    def _spool_payloads(self, payloads: List[Any]) -> None:
        for p in payloads:
            raw = self._raw_of(p)
            if raw is None:
                # a host without msgpack: no bodies to splice, so the
                # batch is dropped as without a spool, but counted
                self.spool_send_failures += 1
                continue
            if self._spool.append(self._seq_of(p), raw):
                self.spooled_envelopes += 1
            else:
                self.spool_send_failures += 1

    def _dump_ring(self) -> None:
        for seq, raw in self._ring:
            if self._spool.append(seq, raw):
                self.spooled_envelopes += 1
        self._ring = []
        self._ring_bytes = 0

    # -- replay ---------------------------------------------------------
    def replay(self) -> bool:
        """Drain the spool through the live link; True once it is empty."""
        if self._spool.pending_frames() == 0:
            return True
        group: List[bytes] = []
        last_seq = 0
        for seq, raw in self._spool.iter_frames():
            group.append(raw)
            last_seq = seq
            if len(group) >= self._replay_batch:
                if not self._send_group(group, last_seq):
                    return False
                group = []
        if group and not self._send_group(group, last_seq):
            return False
        self._spool.clear()
        return True

    def _send_group(self, raws: List[bytes], last_seq: int) -> bool:
        body = msgpack_codec.MSGPACK_PREFIX + msgpack_codec.pack_array_header(len(raws)) + b"".join(raws)
        if not self._client.send_encoded_body(body):
            return False
        self.replayed_envelopes += len(raws)
        self._spool.consume_through(last_seq)
        return True

    # -- send -----------------------------------------------------------
    def send(self, batch: List[Any]) -> bool:
        """Durable send: replay the backlog first, spool on failure."""
        if self._spool.pending_frames() and not self.replay():
            self._spool_payloads(batch)
            return False
        if self._client.send_batch(batch):
            self._ring_add(batch)
            return True
        self._dump_ring()
        self._spool_payloads(batch)
        return False

    def send_transient(self, payloads: List[Any]) -> bool:
        """A best-effort send that is NEVER spooled (heartbeats: a stale
        liveness signal is worthless on replay).  It still tries a replay
        first, so an idle rank drains its backlog as soon as the link
        heals instead of at the next real batch."""
        if self._spool.pending_frames():
            self.replay()
        return bool(self._client.send_batch(payloads))

    def stats(self) -> Dict[str, int]:
        return {
            "spool_bytes": self._spool.pending_bytes(),
            "spool_frames": self._spool.pending_frames(),
            "spooled_envelopes": self.spooled_envelopes,
            "replayed_envelopes": self.replayed_envelopes,
            "spool_evicted_envelopes": self._spool.evicted_frames,
            "spool_send_failures": self.spool_send_failures,
        }

    def close(self) -> None:
        self._spool.close()
