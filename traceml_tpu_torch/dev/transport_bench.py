"""The transport tier's arms, in process, on real envelopes.

:func:`run_arms` takes encoded envelopes (``msgpack_codec.EncodedPayload``,
as the publisher makes them; ``chip_smoke.py`` reads them from a run's
disk backup) and pushes every one, one envelope a frame, from a producer
thread through each arm into the port's ``TCPServer``, read as the
aggregator reads it (``drain_tagged`` then ``decode_tagged``), until all
are back.  Each arm's decoded list must equal the envelopes decoded from
their source bytes (``equal``).  The arms:

``tcp_native``, ``tcp_python``  TCP, the server splitting frames with
                                ``native/framing.c`` or with the Python loop;
``uds``                         the Unix socket;
``shm_native``, ``shm_python``  the rank's ring through ``native/ring.c`` or
                                the Python twin, polled by the server's
                                registry on its 50 ms tick, its tails
                                committed after each drain;
``tcp_zstd``, ``tcp_zlib``      TCP with each envelope wrapped in a
                                compressed carrier on the producer thread.

Each arm runs ``repeats`` times, the arms interleaved; a run is timed from
the producer's start to the last envelope decoded (set-up excluded), and
the arm reports its fastest and median run, frames/s and MB/s of wire
bytes at the fastest.  Besides: the ring alone (append, then drain, µs a
frame, ``ring.c`` and the twin), the server's frame split alone (µs a
frame over 64 KiB chunks) and each codec's µs an envelope to wrap and to
unwrap, with its ratio (bytes offered / bytes on the wire over the
envelopes it compressed) and how many passed through unwrapped.

Host CPU work only: run on the card's host, its numbers are that host's.
"""

from __future__ import annotations

import statistics
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional
from unittest import mock

from traceml_tpu_torch.transport import compression, shm_ring, tcp_transport
from traceml_tpu_torch.transport.tcp_transport import TCPClient, TCPServer, UDSClient
from traceml_tpu_torch.utils import msgpack_codec

ARMS = ("tcp_native", "tcp_python", "uds", "shm_native", "shm_python", "tcp_zstd", "tcp_zlib")
_CHUNK = 64 * 1024
_TIMEOUT_S = 120.0


def _no_native():
    return None


def _drain_until(server: TCPServer, n: int, on_drain: Optional[Callable[[], None]] = None) -> List[Any]:
    got: List[Any] = []
    deadline = time.monotonic() + _TIMEOUT_S
    while len(got) < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{len(got)} of {n} envelopes back in {_TIMEOUT_S} s")
        server.wait_for_data(0.05)
        tagged = server.drain_tagged()
        if tagged:
            got.extend(server.decode_tagged(tagged))
            if on_drain is not None:
                on_drain()
    return got


def _one_run(arm: str, bodies: List[msgpack_codec.EncodedPayload], want: List[Any], work: Path,
             ring_dir: Path) -> Dict[str, Any]:
    """One timed push of every body through ``arm``; ``want`` is what must
    come back."""
    patches = []
    if arm == "tcp_python":
        patches.append(mock.patch.object(tcp_transport, "_framing", _no_native))
    if arm == "shm_python":
        patches.append(mock.patch.object(shm_ring, "_native_ring", _no_native))
    codec = {"tcp_zstd": "zstd", "tcp_zlib": "zlib"}.get(arm)
    compressor = compression.EnvelopeCompressor(codec) if codec else None
    for p in patches:
        p.start()
    registry = client = None
    try:
        if arm.startswith("shm"):
            session = work / f"session-{arm}"
            client = shm_ring.ShmRingClient(shm_ring.ring_segment_path(session, 0, ring_dir), session_dir=session,
                                            global_rank=0)
            registry = shm_ring.ShmRingRegistry(session)
            server = TCPServer()
            server.attach_ring_registry(registry)
        elif arm == "uds":
            sock = str(work / "bench.sock")
            server = TCPServer(uds_path=sock)
        else:
            server = TCPServer()
        server.start()
        try:
            if arm == "uds":
                client = UDSClient(sock)
            elif client is None:
                client = TCPClient("127.0.0.1", server.port)
            retries = [0]
            wire = [0]

            def produce() -> None:
                for enc in bodies:
                    payload = compressor.wrap(enc) if compressor is not None else enc
                    body = msgpack_codec.encode_batch([payload])
                    wire[0] += len(body)
                    while not client.send_encoded_body(body):  # only a full ring refuses
                        retries[0] += 1
                        time.sleep(0.001)

            commit = (lambda: registry.commit(registry.cursors())) if registry is not None else None
            producer = threading.Thread(target=produce, name=f"bench-{arm}", daemon=True)
            t0 = time.perf_counter()
            producer.start()
            got = _drain_until(server, len(bodies), commit)
            seconds = time.perf_counter() - t0
            producer.join(timeout=_TIMEOUT_S)
        finally:
            if client is not None:
                client.close()
            server.stop()
            if registry is not None:
                Path(client.path).unlink(missing_ok=True)
    finally:
        for p in patches:
            p.stop()
    return {"seconds": seconds, "equal": got == want, "wire_bytes": wire[0], "send_retries": retries[0],
            "compressed": server.compressed_envelopes, "decompress_errors": server.decompress_errors}


def _ring_alone(bodies: List[bytes], work: Path, native: bool) -> Dict[str, float]:
    patch = None if native else mock.patch.object(shm_ring, "_native_ring", _no_native)
    if patch is not None:
        patch.start()
    try:
        cap = max(shm_ring.MIN_RING_BYTES, 2 * sum(4 + len(b) for b in bodies))
        client = shm_ring.ShmRingClient(work / f"alone-{native}.ring", capacity=cap)
        consumer = shm_ring.ShmRingConsumer(client.path, 0)
        try:
            t0 = time.perf_counter()
            for b in bodies:
                client.send_encoded_body(b)
            t1 = time.perf_counter()
            frames = consumer.drain()
            t2 = time.perf_counter()
        finally:
            client.close()
            consumer.close()
            client.path.unlink(missing_ok=True)
    finally:
        if patch is not None:
            patch.stop()
    if frames != bodies:
        raise RuntimeError(f"the ring gave back {len(frames)} frames, not the {len(bodies)} appended")
    n = len(bodies)
    return {"append_us": (t1 - t0) / n * 1e6, "drain_us": (t2 - t1) / n * 1e6}


def _split_alone(stream: bytes, n: int, native: bool) -> float:
    with mock.patch.object(tcp_transport, "_framing", tcp_transport._framing if native else _no_native):
        buf = tcp_transport._ClientBuffer()
        got = 0
        t0 = time.perf_counter()
        for i in range(0, len(stream), _CHUNK):
            got += len(buf.feed(stream[i:i + _CHUNK]))
        seconds = time.perf_counter() - t0
    if got != n:
        raise RuntimeError(f"the split gave {got} frames, not {n}")
    return seconds / n * 1e6


def _codec_cost(bodies: List[msgpack_codec.EncodedPayload], codec: str) -> Dict[str, Any]:
    comp = compression.EnvelopeCompressor(codec)
    t0 = time.perf_counter()
    wrapped = [comp.wrap(enc) for enc in bodies]
    t1 = time.perf_counter()
    carriers = [w.obj for w in wrapped if compression.is_compressed_payload(w.obj)]
    for c in carriers:
        compression.unwrap_payload(c)
    t2 = time.perf_counter()
    stats = comp.stats()
    return {"wrap_us_per_envelope": (t1 - t0) / len(bodies) * 1e6,
            "unwrap_us_per_carrier": (t2 - t1) / len(carriers) * 1e6 if carriers else None,
            "ratio": stats["ratio"], "compressed": stats["envelopes_compressed"],
            "passthrough": stats["envelopes_passthrough"], "bytes_precompress": stats["bytes_precompress"],
            "bytes_wire": stats["bytes_wire"]}


def run_arms(bodies: List[msgpack_codec.EncodedPayload], ring_dir: Optional[Path] = None,
             repeats: int = 3) -> Dict[str, Any]:
    """Every arm ``repeats`` times, interleaved; see the module docstring.
    Ring segments go into a private directory of this call under
    ``ring_dir`` (the system's temporary directory by default), so two
    calls given one ``ring_dir`` never share a segment; it is removed."""
    codecs = compression.available_codecs()
    arms = [a for a in ARMS if not a.startswith("tcp_z") or a[4:] in codecs]
    with tempfile.TemporaryDirectory(prefix="traceml-bench-") as tmp, \
            tempfile.TemporaryDirectory(prefix="traceml-bench-", dir=ring_dir) as ring_tmp:
        work = Path(tmp)
        ring_work = Path(ring_tmp)
        want = [msgpack_codec.decode(enc.body) for enc in bodies]
        runs: Dict[str, List[Dict[str, Any]]] = {a: [] for a in arms}
        for _ in range(repeats):
            for arm in arms:
                runs[arm].append(_one_run(arm, bodies, want, work, ring_work))
        raw = [enc.body for enc in bodies]
        stream = b"".join(tcp_transport._LEN.pack(len(b)) + b for b in raw)
        alone = {"ring_native": min((_ring_alone(raw, ring_work, True) for _ in range(repeats)),
                                    key=lambda r: r["append_us"] + r["drain_us"]),
                 "ring_python": min((_ring_alone(raw, ring_work, False) for _ in range(repeats)),
                                    key=lambda r: r["append_us"] + r["drain_us"]),
                 "split_native_us": min(_split_alone(stream, len(raw), True) for _ in range(repeats)),
                 "split_python_us": min(_split_alone(stream, len(raw), False) for _ in range(repeats))}
    out: Dict[str, Any] = {"envelopes": len(bodies), "body_bytes": sum(len(b) for b in raw), "arms": {}}
    for arm, rs in runs.items():
        best = min(rs, key=lambda r: r["seconds"])
        out["arms"][arm] = {
            "equal": all(r["equal"] for r in rs),
            "seconds_min": best["seconds"], "seconds_median": statistics.median(r["seconds"] for r in rs),
            "frames_per_s": len(bodies) / best["seconds"], "mb_per_s": best["wire_bytes"] / best["seconds"] / 1e6,
            "wire_bytes": best["wire_bytes"], "send_retries": max(r["send_retries"] for r in rs),
            "compressed": best["compressed"], "decompress_errors": max(r["decompress_errors"] for r in rs),
        }
    a = out["arms"]
    out["ratios"] = {
        "tcp_native_over_python": a["tcp_python"]["seconds_min"] / a["tcp_native"]["seconds_min"],
        "shm_native_over_python": a["shm_python"]["seconds_min"] / a["shm_native"]["seconds_min"],
        "shm_over_tcp": a["tcp_native"]["seconds_min"] / a["shm_native"]["seconds_min"],
        "uds_over_tcp": a["tcp_native"]["seconds_min"] / a["uds"]["seconds_min"],
        "ring_alone_native_over_python": (alone["ring_python"]["append_us"] + alone["ring_python"]["drain_us"])
        / (alone["ring_native"]["append_us"] + alone["ring_native"]["drain_us"]),
        "split_native_over_python": alone["split_python_us"] / alone["split_native_us"],
    }
    out["alone"] = alone
    out["codecs"] = {c: _codec_cost(bodies, c) for c in codecs}
    return out
