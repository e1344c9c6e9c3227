"""Same-host shared-memory ring transport (SPSC, one memcpy to publish).

Counterpart of ``traceml_tpu/transport/shm_ring.py``: the same segment
bytes, so a segment written by either package is read by the other.  Each
rank publishes into its own file-backed ``mmap`` ring (under
``TRACEML_SHM_DIR``, else ``/dev/shm``), found by the aggregator through a
``rank_<n>/shm_ring.json`` descriptor in the session directory; the
launcher removes both at the end of the run.

Layout (``native/ring.c`` holds the same contract)::

    64-byte header:
      0   magic  b"TMR1"
      4   u32    version (1)
      8   u64    capacity (data bytes)
      16  u64    head  — producer-owned, total bytes published
      24  u64    tail  — consumer-owned, total bytes consumed
      32  u64    producer_gen — stamped at ring creation
      40  u64    consumer_gen — stamped by the aggregator at attach
      48  u32    producer_pid
    data region: u32-le length-prefixed frames, wrapping modulo
    capacity (a frame may straddle the wrap point).

The frames are the bodies the stream transports put after their 4-byte
prefix, so the aggregator's decode path cannot tell transports apart.

* **Commit by head advance.**  The producer writes prefix + body into
  free space, then publishes by advancing ``head``.  Bytes past ``head``
  are invisible, so a ``kill -9`` mid-write (the ``shm.write`` chaos
  point) leaves only unpublished garbage: no torn frame is ever drained.
* **Two-phase consumption.**  The consumer peeks frames from an in-memory
  cursor; the aggregator advances the shared ``tail`` only once the
  SQLite writer has settled the envelopes those frames carried
  (``ShmRingRegistry.take_marks`` / ``commit``).  An aggregator killed in
  between re-delivers the window to its restarted incarnation, and the
  writer drops the repeats by ``seq``.
* **Consumer generation.**  A re-attaching aggregator stamps a fresh
  ``consumer_gen``; the producer's next send sees the flip and reports
  one failed send, so the durable sender above it spools its window and
  replays it.
* **Quarantine.**  A segment whose header fails validation at attach
  (the ``shm.attach`` chaos point can corrupt it) or whose frame length
  breaks the invariants is quarantined and counted.

A file in ``/dev/shm`` rather than ``multiprocessing.shared_memory``: the
resource tracker of an attaching process would unlink the segment at its
exit, and the aggregator must be killable and re-attachable.
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import struct
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from traceml_tpu_torch import native
from traceml_tpu_torch.dev import chaos
from traceml_tpu_torch.utils import msgpack_codec
from traceml_tpu_torch.utils.error_log import get_error_log

ENV_SHM_DIR = "TRACEML_SHM_DIR"
ENV_SHM_RING_BYTES = "TRACEML_SHM_RING_BYTES"

RING_MAGIC = b"TMR1"
RING_VERSION = 1
RING_HDR = 64
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

_OFF_VERSION = 4
_OFF_CAPACITY = 8
_OFF_HEAD = 16
_OFF_TAIL = 24
_OFF_PRODUCER_GEN = 32
_OFF_CONSUMER_GEN = 40
_OFF_PRODUCER_PID = 48

DEFAULT_RING_BYTES = 4 * 1024 * 1024
MIN_RING_BYTES = 64 * 1024

#: descriptor file the producer drops in its rank dir so the aggregator
#: can discover the segment (launcher env carries only the session dir)
DESCRIPTOR_NAME = "shm_ring.json"


def _native_ring():
    """The compiled ``native/ring.c`` extension, or None."""
    return native.get_ring()


def _env_ring_bytes() -> int:
    try:
        return int(os.environ.get(ENV_SHM_RING_BYTES, "").strip() or DEFAULT_RING_BYTES)
    except ValueError:
        return DEFAULT_RING_BYTES


def default_ring_dir() -> Optional[Path]:
    """Where segment files live: TRACEML_SHM_DIR override, else
    /dev/shm when present (page-cache backed), else None (caller falls
    back to the rank dir — still correct, maybe touching disk)."""
    override = os.environ.get(ENV_SHM_DIR)
    if override:
        return Path(override)
    shm = Path("/dev/shm")
    if shm.is_dir() and os.access(shm, os.W_OK):
        return shm
    return None


def ring_segment_path(
    session_dir: Path, global_rank: int, ring_dir: Optional[Path] = None
) -> Path:
    """Deterministic per-(session, rank) segment path, short enough for
    any filesystem and collision-free across sessions via digest."""
    base = ring_dir or default_ring_dir()
    if base is None:
        return Path(session_dir) / f"rank{global_rank}.ring"
    digest = hashlib.sha1(
        f"{Path(session_dir).resolve()}:{os.getuid()}".encode()
    ).hexdigest()[:12]
    return base / f"traceml-{digest}-r{global_rank}.ring"


# ---------------------------------------------------------------------
# header accessors (Python mirror of ring.c; used by both native and
# pure paths for setup/validation — only append/drain have a C twin)
# ---------------------------------------------------------------------


def _read_u64(buf, off: int) -> int:
    return _U64.unpack_from(buf, off)[0]


def _write_u64(buf, off: int, value: int) -> None:
    _U64.pack_into(buf, off, value)


def init_ring_buffer(buf, capacity: int, producer_gen: int) -> None:
    """Stamp a fresh header over a zeroed buffer of RING_HDR+capacity."""
    buf[0:4] = RING_MAGIC
    _U32.pack_into(buf, _OFF_VERSION, RING_VERSION)
    _write_u64(buf, _OFF_CAPACITY, capacity)
    _write_u64(buf, _OFF_HEAD, 0)
    _write_u64(buf, _OFF_TAIL, 0)
    _write_u64(buf, _OFF_PRODUCER_GEN, producer_gen)
    _write_u64(buf, _OFF_CONSUMER_GEN, 0)
    _U32.pack_into(buf, _OFF_PRODUCER_PID, os.getpid() & 0xFFFFFFFF)


def validate_ring_buffer(buf) -> int:
    """Return the capacity of a well-formed ring; ValueError otherwise."""
    if len(buf) < RING_HDR + 8:
        raise ValueError("ring buffer too small")
    if bytes(buf[0:4]) != RING_MAGIC:
        raise ValueError("bad ring magic")
    version = _U32.unpack_from(buf, _OFF_VERSION)[0]
    if version != RING_VERSION:
        raise ValueError(f"unsupported ring version {version}")
    capacity = _read_u64(buf, _OFF_CAPACITY)
    if capacity == 0 or capacity + RING_HDR > len(buf):
        raise ValueError("ring capacity out of range")
    head = _read_u64(buf, _OFF_HEAD)
    tail = _read_u64(buf, _OFF_TAIL)
    if head < tail or head - tail > capacity:
        raise ValueError("ring head/tail invariant violated")
    return capacity


def py_ring_append(buf, capacity: int, payload: bytes) -> bool:
    """Pure-Python twin of ring.c:ring_append (same commit protocol)."""
    need = 4 + len(payload)
    if need > capacity:
        raise ValueError("frame larger than ring")
    head = _read_u64(buf, _OFF_HEAD)
    tail = _read_u64(buf, _OFF_TAIL)
    if head - tail + need > capacity:
        return False
    data_off = RING_HDR
    blob = _U32.pack(len(payload)) + payload
    at = head % capacity
    first = min(capacity - at, need)
    buf[data_off + at : data_off + at + first] = blob[:first]
    if need > first:
        buf[data_off : data_off + need - first] = blob[first:]
    # publish: the head store is the commit point (CPython slice
    # assignment on mmap is a memcpy that completes before this line)
    _write_u64(buf, _OFF_HEAD, head + need)
    return True


def py_ring_drain(buf, capacity: int, max_frames: int) -> List[bytes]:
    """Pure-Python twin of ring.c:ring_drain (advances tail per frame)."""
    tail = _read_u64(buf, _OFF_TAIL)
    out, cursor = py_ring_peek(buf, capacity, tail, max_frames)
    if cursor != tail:
        _write_u64(buf, _OFF_TAIL, cursor)
    return out


def py_ring_peek(
    buf, capacity: int, cursor: int, max_frames: int
) -> Tuple[List[bytes], int]:
    """Pure-Python twin of ring.c:ring_peek — read frames from a
    caller-held cursor WITHOUT touching tail.  The caller advances tail
    (``commit``) only after the frames are durably processed, so a
    crash between peek and commit re-delivers the window."""
    out: List[bytes] = []
    data_off = RING_HDR
    head = _read_u64(buf, _OFF_HEAD)
    if cursor > head:
        raise ValueError("ring cursor beyond head")
    while (max_frames <= 0 or len(out) < max_frames) and head - cursor >= 4:
        at = cursor % capacity
        if capacity - at >= 4:
            n = _U32.unpack_from(buf, data_off + at)[0]
        else:
            split = capacity - at
            raw = bytes(buf[data_off + at : data_off + capacity])
            raw += bytes(buf[data_off : data_off + 4 - split])
            n = _U32.unpack(raw)[0]
        if n + 4 > capacity:
            raise ValueError(f"ring frame length {n} exceeds capacity")
        if head - cursor < 4 + n:
            break
        start = (cursor + 4) % capacity
        first = min(capacity - start, n)
        body = bytes(buf[data_off + start : data_off + start + first])
        if n > first:
            body += bytes(buf[data_off : data_off + n - first])
        out.append(body)
        cursor += 4 + n
    return out, cursor


class ShmRingClient:
    """Producer side: publishes length-prefixed frames into the ring.

    Quacks like :class:`~traceml_tpu_torch.transport.tcp_transport.TCPClient`
    for everything the publisher and the durable sender touch:
    ``send_batch`` / ``send_encoded_body`` / ``close`` plus the
    ``reconnects`` / ``batches_sent`` / ``batches_dropped`` counters.

    Single caller by contract (the rank's publisher tick) — no locks.
    A consumer-generation change (aggregator restarted and re-attached)
    or a full ring reports the send as failed so the DurableSender
    spools and replays; seq dedup keeps delivery exactly-once.
    """

    kind = "shm"

    def __init__(
        self,
        path: Path,
        capacity: Optional[int] = None,
        session_dir: Optional[Path] = None,
        global_rank: Optional[int] = None,
    ) -> None:
        self.path = Path(path)
        cap = capacity or _env_ring_bytes()
        self._capacity = max(MIN_RING_BYTES, int(cap))
        self.reconnects = 0
        self.batches_sent = 0
        self.batches_dropped = 0
        self.ring_full_drops = 0
        self._last_consumer_gen = 0
        self._native = _native_ring()
        self._fd = -1
        self._mm: Optional[mmap.mmap] = None
        self._create()
        if session_dir is not None and global_rank is not None:
            self._write_descriptor(Path(session_dir), int(global_rank))

    # -- setup --------------------------------------------------------

    def _create(self) -> None:
        total = RING_HDR + self._capacity
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # O_EXCL-free: a stale segment from a previous incarnation of
        # this rank is simply re-initialized (new producer_gen)
        fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            os.ftruncate(fd, total)
            mm = mmap.mmap(fd, total)
        except Exception:
            os.close(fd)
            raise
        self._fd = fd
        self._mm = mm
        init_ring_buffer(mm, self._capacity, producer_gen=time.time_ns())

    def _write_descriptor(self, session_dir: Path, global_rank: int) -> None:
        """Drop the discovery breadcrumb the aggregator scans for."""
        # TraceMLSettings.rank_dir's layout (rank_<n>)
        rank_dir = session_dir / f"rank_{global_rank}"
        rank_dir.mkdir(parents=True, exist_ok=True)
        desc = {
            "path": str(self.path),
            "capacity": self._capacity,
            "global_rank": global_rank,
            "producer_pid": os.getpid(),
        }
        tmp = rank_dir / (DESCRIPTOR_NAME + ".tmp")
        tmp.write_text(json.dumps(desc))
        tmp.replace(rank_dir / DESCRIPTOR_NAME)

    # -- send path ----------------------------------------------------

    def _consumer_bounced(self) -> bool:
        """True once per aggregator re-attach: the producer must treat
        the next send as failed so its durable window replays through
        the fresh consumer (seq dedup absorbs any overlap)."""
        assert self._mm is not None
        gen = _read_u64(self._mm, _OFF_CONSUMER_GEN)
        if gen != self._last_consumer_gen:
            first = self._last_consumer_gen == 0
            self._last_consumer_gen = gen
            if not first:
                self.reconnects += 1
                return True
        return False

    def _append(self, body: bytes) -> bool:
        assert self._mm is not None
        # kill9 executes inside fire() — dying here is "mid-ring-write":
        # head was not advanced, so the consumer never sees a torn frame
        fault = chaos.fire("shm.write")
        if fault is not None:
            if fault.action == "stall":
                time.sleep(float(fault.arg or 0.2))
            elif fault.action == "corrupt":
                # flip one byte in the body: the ring framing survives,
                # the aggregator's per-frame decode drops just this batch
                idx = len(body) // 2
                body = body[:idx] + bytes([body[idx] ^ 0xFF]) + body[idx + 1 :]
            elif fault.action in ("reset", "truncate"):
                return False
        if self._native is not None:
            return bool(self._native.ring_append(self._mm, body))
        return py_ring_append(self._mm, self._capacity, body)

    def send_encoded_body(self, body: bytes) -> bool:
        """Publish one already-framed batch body (the same bytes the
        TCP path would put after the 4-byte wire prefix)."""
        if self._mm is None:
            return False
        try:
            if self._consumer_bounced():
                return False
            if self._append(body):
                self.batches_sent += 1
                return True
            self.ring_full_drops += 1
            self.batches_dropped += 1
            return False
        except Exception as exc:
            get_error_log().warning("shm ring append failed", exc)
            self.batches_dropped += 1
            return False

    def send_batch(self, payloads: List[Any]) -> bool:
        if not payloads:
            return True
        try:
            body = msgpack_codec.encode_batch(payloads)
        except Exception as exc:
            get_error_log().warning("shm batch encode failed", exc)
            return False
        return self.send_encoded_body(body)

    def close(self) -> None:
        # the segment outlives the producer: the aggregator drains the
        # remaining frames, the launcher removes the file at teardown
        if self._mm is not None:
            try:
                self._mm.close()
            except Exception:
                pass
            self._mm = None
        if self._fd >= 0:
            try:
                os.close(self._fd)
            except Exception:
                pass
            self._fd = -1


class ShmRingConsumer:
    """Aggregator side: attaches a rank's segment and drains frames on
    the selector tick.  Single caller (the serve thread) — no locks.

    Consumption is two-phase: ``drain(commit=False)`` peeks frames from
    an in-memory ``_cursor`` and ``commit(upto)`` advances the shared
    ``tail`` only once those envelopes are durably written.  A crash
    between the two re-delivers the uncommitted window to the next
    incarnation; the writer's seq dedup absorbs the overlap.  The
    default ``commit=True`` keeps the old drain-and-advance semantics
    for standalone consumers (tests, one-shot tooling).
    """

    def __init__(self, path: Path, global_rank: int) -> None:
        self.path = Path(path)
        self.global_rank = int(global_rank)
        self.tag = f"shm:{global_rank}"
        self._native = _native_ring()
        self._fd = -1
        self._mm: Optional[mmap.mmap] = None
        self._capacity = 0
        self._cursor = 0
        self._attach()

    def _attach(self) -> None:
        fault = chaos.fire("shm.attach")
        fd = os.open(self.path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            mm = mmap.mmap(fd, size)
            if fault is not None and fault.action == "corrupt":
                # simulate a torn header (host reboot mid-page-write)
                mm[0:4] = b"\x00\x00\x00\x00"
            self._capacity = validate_ring_buffer(mm)
        except Exception:
            os.close(fd)
            raise
        self._fd = fd
        self._mm = mm
        # resume reading where the previous incarnation durably stopped:
        # tail is only ever advanced post-commit, so everything past it
        # is the crash-replay window
        self._cursor = _read_u64(mm, _OFF_TAIL)
        # stamp a fresh consumer generation: the producer sees the flip
        # and fails one send so its durable window replays through us
        _write_u64(mm, _OFF_CONSUMER_GEN, time.time_ns())

    def readable(self) -> int:
        if self._mm is None:
            return 0
        head = _read_u64(self._mm, _OFF_HEAD)
        return max(0, head - self._cursor)

    def drain(self, max_frames: int = 0, commit: bool = True) -> List[bytes]:
        """All published frames past the cursor.  ``commit=True`` also
        advances the shared tail (standalone semantics); the registry
        passes ``commit=False`` and settles tails via :meth:`commit`."""
        if self._mm is None:
            return []
        if self._native is not None:
            frames, cursor = self._native.ring_peek(
                self._mm, self._cursor, max_frames
            )
        else:
            frames, cursor = py_ring_peek(
                self._mm, self._capacity, self._cursor, max_frames
            )
        self._cursor = cursor
        if commit and frames:
            self.commit(cursor)
        return frames

    def cursor(self) -> int:
        return self._cursor

    def commit(self, upto: int) -> None:
        """Advance the shared tail to ``upto`` — frames at or before it
        are durably processed and their ring space is reclaimable."""
        if self._mm is None:
            return
        upto = min(int(upto), self._cursor)  # never past what we read
        if upto <= _read_u64(self._mm, _OFF_TAIL):
            return  # monotonic: late/duplicate watermarks are no-ops
        if self._native is not None:
            self._native.ring_set_tail(self._mm, upto)
        else:
            _write_u64(self._mm, _OFF_TAIL, upto)

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except Exception:
                pass
            self._mm = None
        if self._fd >= 0:
            try:
                os.close(self._fd)
            except Exception:
                pass
            self._fd = -1


def scan_ring_descriptors(session_dir: Path) -> List[Dict[str, Any]]:
    """All rank ring descriptors currently present under a session dir."""
    out: List[Dict[str, Any]] = []
    try:
        for desc_path in sorted(Path(session_dir).glob(f"rank*/{DESCRIPTOR_NAME}")):
            try:
                desc = json.loads(desc_path.read_text())
            except (OSError, ValueError):
                continue
            if isinstance(desc, dict) and "path" in desc:
                desc["_descriptor"] = str(desc_path)
                out.append(desc)
    except OSError:
        pass
    return out


class ShmRingRegistry:
    """The aggregator's set of attached rank rings.

    Lives on the serve thread: ``poll()`` runs inside the selector tick
    (polling, no futex or eventfd), rescanning the session
    dir at a low cadence for late-joining ranks and draining whatever
    is published.  Broken/torn segments are quarantined with counters
    rather than retried hot.
    """

    RESCAN_INTERVAL_S = 1.0

    def __init__(self, session_dir: Path) -> None:
        self.session_dir = Path(session_dir)
        self.consumers: Dict[str, ShmRingConsumer] = {}
        self.attach_failures = 0
        self.quarantined: Dict[str, str] = {}
        # cumulative across the registry's lifetime — per-consumer
        # counters die with detach, but the final ingest_stats write
        # happens after close()
        self.rings_attached_total = 0
        self.frames = 0
        self.bytes = 0
        self._last_scan = 0.0
        # durable-consumption marks: after each poll that peeked frames,
        # (cumulative frames polled, {path: cursor}) is queued.  The
        # aggregator counts shm frames it actually drained from the
        # server's pending buffer and pops marks once drained catches up
        # (take_marks) — pairing each cursor snapshot with exactly the
        # frames it covers even when drain slices are capped.
        self._marks: deque = deque()
        self._marks_lock = threading.Lock()

    def _maybe_scan(self) -> None:
        now = time.monotonic()
        if now - self._last_scan < self.RESCAN_INTERVAL_S:
            return
        self._last_scan = now
        for desc in scan_ring_descriptors(self.session_dir):
            path = str(desc["path"])
            if path in self.consumers or path in self.quarantined:
                continue
            try:
                consumer = ShmRingConsumer(
                    Path(path), int(desc.get("global_rank", -1))
                )
            except Exception as exc:
                self.attach_failures += 1
                self.quarantined[path] = str(exc)
                get_error_log().warning(
                    f"shm ring attach failed for {path}", exc
                )
                continue
            self.consumers[path] = consumer
            self.rings_attached_total += 1

    def poll(self, max_frames_per_ring: int = 256) -> List[Tuple[str, bytes]]:
        """One selector-tick poll: (tag, frame) pairs ready to ingest."""
        self._maybe_scan()
        out: List[Tuple[str, bytes]] = []
        dead: List[str] = []
        for path, consumer in self.consumers.items():
            try:
                if consumer.readable() < 4:
                    continue
                # peek-only: tails advance in commit() once the writer
                # durably lands these envelopes (crash → re-delivery)
                for frame in consumer.drain(max_frames_per_ring, commit=False):
                    out.append((consumer.tag, frame))
                    self.frames += 1
                    self.bytes += len(frame)
            except Exception as exc:
                # corrupt length / invariant break: quarantine the ring;
                # the producer fails over to the stream transport
                dead.append(path)
                self.quarantined[path] = str(exc)
                get_error_log().warning(
                    f"shm ring quarantined: {path}", exc
                )
        for path in dead:
            consumer = self.consumers.pop(path)
            consumer.close()
        if out:
            with self._marks_lock:
                self._marks.append((self.frames, self.cursors()))
        return out

    def take_marks(self, drained_frames: int) -> Optional[Dict[str, int]]:
        """Newest cursor snapshot fully covered by ``drained_frames``
        (cumulative shm frames the caller pulled out of the server's
        pending buffer), consuming every mark up to it.  None until a
        mark is covered."""
        cursors: Optional[Dict[str, int]] = None
        with self._marks_lock:
            while self._marks and self._marks[0][0] <= drained_frames:
                cursors = self._marks.popleft()[1]
        return cursors

    def cursors(self) -> Dict[str, int]:
        """Read cursor per attached ring — snapshot BEFORE handing its
        frames downstream, then pass back to :meth:`commit` once the
        writer settles everything drained up to that snapshot."""
        return {
            path: consumer.cursor()
            for path, consumer in self.consumers.items()
        }

    def commit(self, cursors: Dict[str, int]) -> None:
        """Advance ring tails to a settled cursor snapshot.  Stale paths
        (quarantined/detached since the snapshot) are skipped; commits
        are monotonic so reordered watermarks are harmless."""
        for path, upto in cursors.items():
            # a read racing the serve thread's attach or quarantine: a miss
            # only defers the commit, and replay + seq dedup absorb it
            consumer = self.consumers.get(path)
            if consumer is None:
                continue
            try:
                consumer.commit(upto)
            except (ValueError, OSError):
                pass  # closed/quarantined underneath us: commit is moot

    def stats(self) -> Dict[str, Any]:
        return {
            "rings_attached": self.rings_attached_total,
            "attach_failures": self.attach_failures,
            "quarantined": len(self.quarantined),
            "frames": self.frames,
            "bytes": self.bytes,
        }

    def close(self) -> None:
        for consumer in self.consumers.values():
            consumer.close()
        self.consumers.clear()
