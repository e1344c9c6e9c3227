"""Length-prefixed stream transport (TCP, Unix socket) and the ingest server.

Counterpart of ``traceml_tpu/transport/tcp_transport.py``.

Frames: 4-byte big-endian length + codec body (``utils/msgpack_codec``).
One ``send_batch`` encodes a list of payloads into ONE frame and one
``sendall``, so a sampler tick costs one syscall.  The server splits
frames with ``native/framing.c`` when it built (looked up at the first
client, not at import) and with the Python loop otherwise; both give the
same frames.

The server is one selector thread that accepts and reads every client
and only splits frames; decoding happens on the consumer's thread
(``drain_tagged`` hands raw frames over with their peer, ``decode_tagged``
decodes them), so one client's large batch never stalls the others.  An
undecodable frame is skipped and counted in ``decode_errors`` and against
its peer in ``corrupt_frame_drops``; a corrupt length evicts that one
client.  The same selector serves the rest of the transport tier
(``transport/select.py`` decides what is stood up): an optional Unix
socket listener (peers tagged ``uds:<n>``) and an attached shared-memory
ring registry (``transport/shm_ring.py``), polled each tick, whose frames
join the pending queue tagged ``shm:<rank>``; with rings attached the
select timeout drops from 0.5 s to 50 ms.  ``frames_by_transport``
counts frames by path.  ``decode_tagged`` restores compressed carriers
(``transport/compression.py``) and counts them; a corrupt carrier is
dropped like an undecodable frame.

The client is best-effort and never raises into training code: it
connects lazily, drops a batch it cannot send (``send_batch`` returns
False; the publisher's ``DurableSender`` spools it) and redials after a
capped, jittered exponential backoff (1 s doubling to 15 s, the wait
drawn from [window/2, window], as in JAX).  Every send attempt is the
``client.send`` chaos point.  :class:`UDSClient` differs only in its dial.
"""

from __future__ import annotations

import os
import random
import selectors
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from traceml_tpu_torch import native
from traceml_tpu_torch.dev import chaos
from traceml_tpu_torch.transport import compression
from traceml_tpu_torch.utils import msgpack_codec
from traceml_tpu_torch.utils.error_log import get_error_log

_LEN = struct.Struct(">I")
MAX_FRAME_BYTES = 256 * 1024 * 1024  # sanity bound against corrupt lengths


def _framing():
    """The compiled ``native/framing.c`` extension, or None."""
    return native.get_framing()


class _ClientBuffer:
    """Incremental frame splitter, O(total bytes) with a rolling offset."""

    __slots__ = ("buf", "offset", "_native")

    def __init__(self) -> None:
        self.buf = bytearray()
        self.offset = 0  # consumed prefix
        self._native = _framing()

    def feed(self, data: bytes) -> List[bytes]:
        self.buf.extend(data)
        if self._native is not None:
            # the bytearray itself, not a copy: a copy per recv would make a
            # frame spread over many recvs cost O(buffered bytes) each time
            frames, self.offset = self._native.drain_frames(self.buf, self.offset, MAX_FRAME_BYTES)
        else:
            frames = []
            while True:
                avail = len(self.buf) - self.offset
                if avail < _LEN.size:
                    break
                (n,) = _LEN.unpack_from(self.buf, self.offset)
                if n > MAX_FRAME_BYTES:
                    raise ValueError(f"frame length {n} exceeds bound")
                if avail < _LEN.size + n:
                    break
                start = self.offset + _LEN.size
                frames.append(bytes(self.buf[start : start + n]))
                self.offset = start + n
        # compact once the consumed prefix dominates: amortized O(1) per byte
        if self.offset > 65536 and self.offset * 2 > len(self.buf):
            del self.buf[: self.offset]
            self.offset = 0
        return frames


class TCPServer:
    """Aggregator-side ingest server.

    The consumer blocks on :meth:`wait_for_data`, pulls raw frames with
    their peer tags through :meth:`drain_tagged` and decodes them on its
    own thread with :meth:`decode_tagged`.  Single use: after :meth:`stop`
    build a new one.  With ``uds_path`` it also listens on that Unix
    socket; :meth:`attach_ring_registry` adds the shm rings.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, uds_path: Optional[str] = None) -> None:
        self._host = host
        self._requested_port = port
        self._sock: Optional[socket.socket] = None
        self._uds_path = uds_path
        self._uds_sock: Optional[socket.socket] = None
        self._uds_accepts = 0
        # the ShmRingRegistry polled each tick: set before start(), then
        # the serve thread's
        self._rings = None
        self._selector: Optional[selectors.DefaultSelector] = None
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._wake_r, self._wake_w = socket.socketpair()
        self._lock = threading.Lock()
        # (peer, frame): the peer tag ("ip:port") attributes corrupt
        # frames to the client that sent them
        self._pending: List[Tuple[str, bytes]] = []
        self._data_event = threading.Event()
        self._clients: Dict[int, _ClientBuffer] = {}
        self._peers: Dict[int, str] = {}
        self._stopped = False
        self.port: Optional[int] = None
        self.frames_received = 0
        self.decode_errors = 0
        # frames by arrival path ("tcp" | "uds" | "shm"), for ingest_stats.json
        self.frames_by_transport: Dict[str, int] = {}
        # compressed carriers restored on the consumer's thread
        self.compressed_envelopes = 0
        self.compressed_bytes_in = 0
        self.decompressed_bytes = 0
        self.decompress_errors = 0
        # per-peer frames that could not be decoded or desynced the stream
        self.corrupt_frame_drops: Dict[str, int] = {}
        # deepest the undrained-frame buffer got: how far the consumer
        # fell behind the selector thread
        self.pending_hwm = 0

    def attach_ring_registry(self, registry) -> None:
        """Poll ``registry`` (a ``ShmRingRegistry``) each serve tick; call
        before :meth:`start`."""
        self._rings = registry

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        if self._stopped:
            raise RuntimeError("TCPServer is single-use: construct a new instance after stop()")
        if self._thread is not None:
            return
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self._host, self._requested_port))
        sock.listen(128)
        sock.setblocking(False)
        self._sock = sock
        self.port = sock.getsockname()[1]
        self._selector = selectors.DefaultSelector()
        self._selector.register(sock, selectors.EVENT_READ, "accept")
        self._selector.register(self._wake_r, selectors.EVENT_READ, "wake")
        if self._uds_path:
            uds = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                try:
                    os.unlink(self._uds_path)  # a dead incarnation's socket
                except OSError:
                    pass
                uds.bind(self._uds_path)
                uds.listen(128)
                uds.setblocking(False)
                self._uds_sock = uds
                self._selector.register(uds, selectors.EVENT_READ, "accept_uds")
            except OSError as exc:
                # TCP stays the golden path: a failed bind degrades, never aborts
                get_error_log().warning("uds listener bind failed", exc)
                uds.close()
                self._uds_sock = None
        self._running.set()
        self._thread = threading.Thread(target=self._serve, name="traceml-tcp-server", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop and release every fd."""
        if self._thread is None:
            return
        self._stopped = True
        self._running.clear()
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass
        self._thread.join(timeout=5)
        self._thread = None
        for key in list(self._selector.get_map().values()):
            self._selector.unregister(key.fileobj)
            if key.fileobj not in (self._sock, self._wake_r):
                key.fileobj.close()
        self._selector.close()
        self._clients.clear()
        self._peers.clear()
        for s in (self._sock, self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        self._sock = None
        if self._uds_sock is not None:
            self._uds_sock = None  # closed with the selector's other fds
            try:
                os.unlink(self._uds_path)
            except OSError:
                pass
        if self._rings is not None:
            self._rings.close()

    # -- consumer API --------------------------------------------------
    def wait_for_data(self, timeout: float) -> bool:
        fired = self._data_event.wait(timeout)
        if fired:
            self._data_event.clear()
        return fired

    def drain_tagged(self, max_frames: Optional[int] = None) -> List[Tuple[str, bytes]]:
        """``(peer, raw frame)`` pairs the selector thread split off (at
        most ``max_frames``); the peer tag is ``"ip:port"``."""
        with self._lock:
            if max_frames is None or len(self._pending) <= max_frames:
                out = self._pending
                self._pending = []
            else:
                out = self._pending[:max_frames]
                del self._pending[:max_frames]
        return out

    def decode_tagged(self, tagged: List[Tuple[str, bytes]]) -> List[Any]:
        """Per-frame decode of :meth:`drain_tagged` output into a flat
        payload list (batch frames are flattened).  A corrupt frame is
        skipped (its whole batch is lost) and counted against its peer;
        the connection stays up."""
        payloads: List[Any] = []
        for peer, frame in tagged:
            try:
                decoded = msgpack_codec.decode(frame)
            except msgpack_codec.CodecError:
                self.decode_errors += 1
                self._count_corrupt(peer)
                continue
            payloads.extend(self._unwrap_compressed(decoded if isinstance(decoded, list) else [decoded], peer))
        return payloads

    def _unwrap_compressed(self, payloads: List[Any], peer: str) -> List[Any]:
        """Restore the compressed carriers among ``payloads``; a corrupt one
        is dropped and counted against its peer."""
        out: List[Any] = []
        for payload in payloads:
            if not compression.is_compressed_payload(payload):
                out.append(payload)
                continue
            try:
                inner = compression.unwrap_payload(payload)
            except compression.CompressionError:
                self.decompress_errors += 1
                self.decode_errors += 1
                self._count_corrupt(peer)
                continue
            self.compressed_envelopes += 1
            self.compressed_bytes_in += len(payload["z"])
            self.decompressed_bytes += payload["n"]
            out.append(inner)
        return out

    def _count_corrupt(self, peer: str) -> None:
        # the selector thread also mutates this dict: both sides lock
        with self._lock:
            n = self.corrupt_frame_drops.get(peer, 0) + 1
            self.corrupt_frame_drops[peer] = n
        get_error_log().warning(
            f"undecodable frame from {peer} skipped ({n} corrupt frame(s) from this client so far)"
        )

    # -- server thread -------------------------------------------------
    def _serve(self) -> None:
        # the rings have no fd to wake the selector: with rings attached
        # the tick drops to 50 ms, and each tick polls them
        timeout = 0.05 if self._rings is not None else 0.5
        while self._running.is_set():
            try:
                events = self._selector.select(timeout=timeout)
            except OSError:
                break
            for key, _mask in events:
                if key.data == "wake":
                    try:
                        self._wake_r.recv(4096)
                    except OSError:
                        pass
                elif key.data == "accept":
                    self._accept()
                elif key.data == "accept_uds":
                    self._accept_uds()
                else:
                    self._read(key.fileobj)
            if self._rings is not None:
                self._poll_rings()

    def _poll_rings(self) -> None:
        """Move every attached ring's published frames to the pending
        queue, tagged ``shm:<rank>``."""
        try:
            tagged = self._rings.poll()
        except Exception as exc:  # a registry scan or attach gone wrong
            get_error_log().warning("shm ring poll failed", exc)
            return
        if not tagged:
            return
        with self._lock:
            self.frames_received += len(tagged)
            self.frames_by_transport["shm"] = self.frames_by_transport.get("shm", 0) + len(tagged)
            self._pending.extend(tagged)
            self.pending_hwm = max(self.pending_hwm, len(self._pending))
        self._data_event.set()

    def _accept(self) -> None:
        try:
            while True:
                conn, addr = self._sock.accept()
                conn.setblocking(False)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._add_client(conn, f"{addr[0]}:{addr[1]}")
        except OSError:  # BlockingIOError: nothing more to accept
            return

    def _accept_uds(self) -> None:
        try:
            while True:
                conn, _addr = self._uds_sock.accept()
                conn.setblocking(False)
                # a Unix peer has no address: number them as they come
                self._uds_accepts += 1
                self._add_client(conn, f"uds:{self._uds_accepts}")
        except OSError:
            return

    def _add_client(self, conn: socket.socket, peer: str) -> None:
        fileno = conn.fileno()
        self._clients[fileno] = _ClientBuffer()
        self._peers[fileno] = peer
        self._selector.register(conn, selectors.EVENT_READ, "client")

    def _drop_client(self, conn: socket.socket, fileno: int) -> None:
        try:
            self._selector.unregister(conn)
        except (KeyError, ValueError):
            pass
        self._clients.pop(fileno, None)
        self._peers.pop(fileno, None)
        try:
            conn.close()
        except OSError:
            pass

    def _read(self, conn: socket.socket) -> None:
        fileno = conn.fileno()
        try:
            data = conn.recv(1 << 20)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            self._drop_client(conn, fileno)
            return
        buf = self._clients.get(fileno)
        if buf is None:
            return
        peer = self._peers.get(fileno, "unknown")
        try:
            frames = buf.feed(data)
        except ValueError as exc:
            # a corrupt LENGTH desyncs the stream: nothing after it can be
            # reframed, so this one client is evicted
            get_error_log().warning(f"dropping client with bad frame: {exc}")
            with self._lock:
                self.corrupt_frame_drops[peer] = self.corrupt_frame_drops.get(peer, 0) + 1
            self._drop_client(conn, fileno)
            return
        if not frames:
            return
        kind = "uds" if peer.startswith("uds:") else "tcp"
        with self._lock:
            self.frames_received += len(frames)
            self.frames_by_transport[kind] = self.frames_by_transport.get(kind, 0) + len(frames)
            self._pending.extend((peer, frame) for frame in frames)
            self.pending_hwm = max(self.pending_hwm, len(self._pending))
        self._data_event.set()


class TCPClient:
    """Best-effort sender: never raises, connects lazily, drops on failure.

    Reconnect policy: capped exponential backoff with full jitter.
    Consecutive dial failures double the window from
    ``reconnect_backoff`` up to ``backoff_cap``, and the wait is drawn
    uniformly from [window/2, window]; a successful dial resets it.
    """

    kind = "tcp"

    def __init__(
        self,
        host: str,
        port: int,
        connect_timeout: float = 2.0,
        reconnect_backoff: float = 1.0,
        backoff_cap: float = 15.0,
    ) -> None:
        self._host = host
        self._port = port
        self._timeout = connect_timeout
        self._backoff_base = max(0.001, float(reconnect_backoff))
        self._backoff_cap = max(self._backoff_base, float(backoff_cap))
        self._backoff_cur = 0.0  # jittered wait before the next dial
        self._fail_streak = 0
        self._connected_once = False
        self._sock: Optional[socket.socket] = None
        self._last_fail = 0.0
        self._lock = threading.Lock()
        self.reconnects = 0  # successful dials after the first
        self.batches_sent = 0
        self.batches_dropped = 0

    def _dial(self) -> socket.socket:
        """One connected socket, or OSError: the seam :class:`UDSClient`
        overrides."""
        sock = socket.create_connection((self._host, self._port), timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _ensure_connected_locked(self) -> Optional[socket.socket]:
        if self._sock is not None:
            return self._sock
        if time.monotonic() - self._last_fail < self._backoff_cur:
            return None
        try:
            sock = self._dial()
        except OSError:
            self._last_fail = time.monotonic()
            self._fail_streak += 1
            window = min(self._backoff_cap, self._backoff_base * (2 ** (self._fail_streak - 1)))
            self._backoff_cur = random.uniform(window / 2.0, window)
            return None
        self._sock = sock
        self._fail_streak = 0
        self._backoff_cur = 0.0
        if self._connected_once:
            self.reconnects += 1
        self._connected_once = True
        return sock

    def send_batch(self, payloads: List[Any]) -> bool:
        """Encode ``payloads`` as ONE frame, one sendall; True on success.
        Members may be :class:`msgpack_codec.EncodedPayload`, whose bodies
        are spliced without a second encode.  Encoding happens before the
        socket lock is taken."""
        if not payloads:
            return True
        try:
            body = msgpack_codec.encode_batch(payloads)
        except msgpack_codec.CodecError:
            with self._lock:
                self.batches_dropped += 1
            return False
        return self.send_encoded_body(body)

    def send_encoded_body(self, body: bytes) -> bool:
        """Send an assembled wire body as one frame.  The replay path
        (``transport/spool.py``) splices spooled envelope bodies into a
        batch body itself and ships it here: the same framing, counters
        and failure rules as :meth:`send_batch`.  Each attempt is the
        ``client.send`` chaos point (``dev/chaos.py``)."""
        fault = chaos.fire("client.send")
        if fault is not None:
            if fault.action == "stall":
                time.sleep(float(fault.arg or 0.2))
                fault = None
            elif fault.action == "reset":
                with self._lock:
                    self._teardown_locked()
                    self.batches_dropped += 1
                return False
        frame = bytearray(_LEN.pack(len(body)))
        frame += body
        if fault is not None and fault.action == "corrupt":
            # flip one byte past the length prefix: the framing holds, the
            # receiver's decode fails and its connection survives
            frame[4 + len(body) // 2] ^= 0xFF
        with self._lock:
            sock = self._ensure_connected_locked()
            if sock is None:
                self.batches_dropped += 1
                return False
            try:
                if fault is not None and fault.action == "truncate":
                    # a prefix, then a reset: the receiver's stream
                    # desyncs (a bad length next) and it evicts the client
                    sock.sendall(bytes(frame[: max(5, len(frame) // 2)]))
                    self.batches_dropped += 1
                    self._teardown_locked()
                    return False
                sock.sendall(frame)
            except OSError:
                self.batches_dropped += 1
                self._teardown_locked()
                return False
            self.batches_sent += 1
            return True

    def _teardown_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._last_fail = time.monotonic()

    def close(self) -> None:
        """Drop the current socket (a later send_batch may redial)."""
        with self._lock:
            self._teardown_locked()


class UDSClient(TCPClient):
    """The Unix-domain-socket sender: the same framing, batching, backoff,
    ``client.send`` chaos point and durable-sender use as TCP; only the
    dial differs."""

    kind = "uds"

    def __init__(self, path: str, connect_timeout: float = 2.0, reconnect_backoff: float = 1.0,
                 backoff_cap: float = 15.0) -> None:
        super().__init__("", 0, connect_timeout=connect_timeout, reconnect_backoff=reconnect_backoff,
                         backoff_cap=backoff_cap)
        self._path = str(path)

    def _dial(self) -> socket.socket:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.settimeout(self._timeout)
            sock.connect(self._path)
        except OSError:
            sock.close()
            raise
        return sock
