"""The port's ``native/`` C extensions against the Python twins.

``framing.c`` and ``ring.c`` are built by ``traceml_tpu_torch.native``
into ``build/traceml_tpu_torch/`` (nothing under the package) and loaded
as ``_framing`` and ``_ring``.  The same bytes, made from a numpy seed, go
through the C extension and through the Python twins of both packages
(the port's and the JAX package's ``_ClientBuffer`` loop, ``_LEN``
framing and ``py_ring_*``): the packed frames, the drained frames with
partial tails and offsets, and the ring buffers after the same appends
are equal byte for byte.  An oversized frame raises on every path.  With
``TRACEML_NO_NATIVE=1``, or a compiler that fails, ``get_framing`` and
``get_ring`` give None and the Python twins carry the same traffic.
"""

import struct

import numpy as np
import pytest

from traceml_tpu.transport import shm_ring as jax_ring
from traceml_tpu.transport import tcp_transport as jax_tcp
from traceml_tpu_torch import native
from traceml_tpu_torch.ops._build import BUILD_DIR
from traceml_tpu_torch.transport import shm_ring, tcp_transport

PACKAGE_DIR = native._SRC_DIR.parent
MAX = 1 << 20


def _bodies(seed, n=24):
    rng = np.random.default_rng(seed)
    sizes = [0, 1, 3, 4, 5] + [int(s) for s in rng.integers(0, 3000, size=n)]
    return [rng.integers(0, 256, size=s, dtype=np.uint8).tobytes() for s in sizes]


def _python_buffer(monkeypatch):
    monkeypatch.setattr(tcp_transport, "_framing", lambda: None)
    return tcp_transport._ClientBuffer()


def _jax_python_buffer(monkeypatch):
    monkeypatch.setattr(jax_tcp, "_native", None)
    return jax_tcp._ClientBuffer()


def test_build_lands_in_build_dir_not_in_the_package():
    for name in native.SOURCES:
        mod = native.load(name)
        path = native.library_path(name)
        assert mod.__name__ == f"_{name}" and mod.__file__ == str(path)
        assert path.parent == BUILD_DIR and BUILD_DIR.parts[-2:] == ("build", "traceml_tpu_torch")
        assert path.exists()
    assert native.get_framing() is not None and native.get_ring() is not None
    assert sorted(p.name for p in PACKAGE_DIR.rglob("*.so")) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_frames_equals_both_python_framings(seed):
    bodies = _bodies(seed)
    port_py = b"".join(tcp_transport._LEN.pack(len(b)) + b for b in bodies)
    jax_py = b"".join(jax_tcp._LEN.pack(len(b)) + b for b in bodies)
    assert native.get_framing().pack_frames(bodies) == port_py == jax_py


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drain_frames_over_chunked_stream_equals_python_twins(seed, monkeypatch):
    """Random recv-sized chunks: partial prefixes and bodies at every cut."""
    bodies = _bodies(seed)
    stream = native.get_framing().pack_frames(bodies)
    cuts = np.sort(np.random.default_rng(seed + 100).integers(0, len(stream), size=40))
    chunks = [stream[a:b] for a, b in zip([0, *cuts], [*cuts, len(stream)])]
    got = {}
    for name, buf in (("native", tcp_transport._ClientBuffer()), ("port_python", _python_buffer(monkeypatch)),
                      ("jax_python", _jax_python_buffer(monkeypatch))):
        frames = []
        for chunk in chunks:
            frames.extend(buf.feed(chunk))
        got[name] = frames
    assert got["native"] == got["port_python"] == got["jax_python"] == bodies


def test_drain_frames_partial_tail_and_offset():
    framing = native.get_framing()
    blob = framing.pack_frames([b"one", b"two", b"three"])
    frames, consumed = framing.drain_frames(blob[:-2], 0, MAX)
    assert (frames, consumed) == ([b"one", b"two"], 14)
    frames, consumed = framing.drain_frames(blob, consumed, MAX)
    assert (frames, consumed) == ([b"three"], len(blob))
    assert framing.drain_frames(blob, len(blob), MAX) == ([], len(blob))
    with pytest.raises(ValueError):
        framing.drain_frames(blob, len(blob) + 1, MAX)


def test_oversized_frame_raises_on_every_path(monkeypatch):
    bad = struct.pack(">I", 1 << 30) + b"xx"
    with pytest.raises(ValueError):
        native.get_framing().drain_frames(bad, 0, MAX)
    for buf in (tcp_transport._ClientBuffer(), _python_buffer(monkeypatch)):
        with pytest.raises(ValueError):
            buf.feed(bad)


def _ring_buf(mod, capacity, gen=7):
    buf = bytearray(mod.RING_HDR + capacity)
    mod.init_ring_buffer(buf, capacity, producer_gen=gen)
    return buf


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_append_and_drain_match_python_twins_byte_for_byte(seed):
    """The same appends (wrapping the 1 KiB ring many times) through
    ``ring.c``, the port's twin and the JAX twin leave equal buffers; every
    path drains every other path's frames."""
    ring, capacity = native.get_ring(), 1024
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, size=int(s), dtype=np.uint8).tobytes() for s in rng.integers(0, 400, size=60)]
    appenders = {
        "native": lambda buf, f: ring.ring_append(buf, f),
        "port": lambda buf, f: shm_ring.py_ring_append(buf, capacity, f),
        "jax": lambda buf, f: jax_ring.py_ring_append(buf, capacity, f),
    }
    drainers = {
        "native": lambda buf: ring.ring_drain(buf, 0),
        "port": lambda buf: shm_ring.py_ring_drain(buf, capacity, 0),
        "jax": lambda buf: jax_ring.py_ring_drain(buf, capacity, 0),
    }
    bufs = {name: _ring_buf(shm_ring, capacity) for name in appenders}
    assert bufs["native"] == _ring_buf(jax_ring, capacity)  # the same header bytes
    for a_name, append in appenders.items():
        d_name = {"native": "port", "port": "jax", "jax": "native"}[a_name]
        got = []
        for frame in frames:
            if not append(bufs[a_name], frame):
                got.extend(drainers[d_name](bufs[a_name]))
                assert append(bufs[a_name], frame)
        got.extend(drainers[d_name](bufs[a_name]))
        assert got == frames, (a_name, d_name)
    assert bufs["native"] == bufs["port"] == bufs["jax"]


def test_ring_peek_leaves_tail_and_set_tail_commits():
    ring, capacity = native.get_ring(), 512
    buf = _ring_buf(shm_ring, capacity)
    for f in (b"a" * 100, b"b" * 200, b"c" * 50):
        assert ring.ring_append(buf, f)
    frames, cursor = ring.ring_peek(buf, 0, 2)
    assert frames == [b"a" * 100, b"b" * 200] and cursor == 308
    assert shm_ring.py_ring_peek(buf, capacity, 0, 2) == (frames, cursor)
    assert ring.ring_readable(buf) == 362  # tail untouched
    ring.ring_set_tail(buf, cursor)
    assert ring.ring_readable(buf) == 54
    assert jax_ring.py_ring_drain(buf, capacity, 0) == [b"c" * 50]
    with pytest.raises(ValueError, match="larger than ring"):
        ring.ring_append(buf, b"x" * capacity)
    with pytest.raises(ValueError, match="beyond head"):
        ring.ring_peek(buf, 10 ** 6, 0)


def test_no_native_env_gives_none_and_python_carries_the_traffic(monkeypatch, tmp_path):
    monkeypatch.setenv("TRACEML_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_cached", {})
    assert native.get_framing() is None and native.get_ring() is None
    buf = tcp_transport._ClientBuffer()
    assert buf._native is None
    bodies = _bodies(5)
    assert buf.feed(b"".join(tcp_transport._LEN.pack(len(b)) + b for b in bodies)) == bodies
    client = shm_ring.ShmRingClient(tmp_path / "r.ring", capacity=shm_ring.MIN_RING_BYTES)
    consumer = shm_ring.ShmRingConsumer(client.path, 0)
    try:
        assert client._native is None and consumer._native is None
        assert client.send_encoded_body(bodies[-1]) and consumer.drain() == [bodies[-1]]
    finally:
        client.close()
        consumer.close()


def test_failed_build_raises_strictly_and_falls_back_quietly(monkeypatch, tmp_path):
    monkeypatch.setenv("CC", "false")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path", lambda name: tmp_path / f"_{name}-x.so")
    monkeypatch.setattr(native, "_cached", {})
    with pytest.raises(native.NativeBuildError):
        native.build("framing")
    assert native.get_framing() is None and native.get_ring() is None
    assert list(tmp_path.iterdir()) == []  # no torn library left behind
