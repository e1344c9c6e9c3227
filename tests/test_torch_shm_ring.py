"""The port's shared-memory ring (``transport/shm_ring.py``) against the
JAX package's.

A segment is the contract: the port's ``ShmRingClient`` writes what the
JAX ``ShmRingConsumer`` drains and the other way round, with the same
64-byte ``TMR1`` header.  Then the ring's own contract, run with
``ring.c`` and with the Python twin: a round trip; wraparound at several
times the capacity; a torn write (garbage past ``head``, and a producer
SIGKILLed inside ``shm.write``) never drained; a full ring failing one
send and recovering; a frame larger than the ring refused; a re-attach
failing exactly one send; corrupt headers and broken invariants rejected
and quarantined; the registry's descriptor scan, its marks and its
commits (a re-attached consumer resumes at the committed tail); and the
``shm.write`` / ``shm.attach`` chaos cases of JAX
``tests/transport/test_shm_ring.py``.  Payloads come from a numpy seed;
rings live under ``tmp_path`` (``TRACEML_SHM_DIR`` too), never in
``/dev/shm``.
"""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from traceml_tpu.transport import shm_ring as jax_ring
from traceml_tpu.utils import msgpack_codec as jax_codec
from traceml_tpu_torch.dev import chaos
from traceml_tpu_torch.transport import shm_ring
from traceml_tpu_torch.transport.shm_ring import (
    MIN_RING_BYTES,
    RING_HDR,
    ShmRingClient,
    ShmRingConsumer,
    ShmRingRegistry,
    scan_ring_descriptors,
)
from traceml_tpu_torch.utils import msgpack_codec

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _rings_under_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("TRACEML_SHM_DIR", str(tmp_path / "shm"))


@pytest.fixture(params=["native", "python"])
def impl(request, monkeypatch):
    """Run the case with ``ring.c`` and with the Python twin."""
    if request.param == "python":
        monkeypatch.setattr(shm_ring, "_native_ring", lambda: None)
    else:
        assert shm_ring._native_ring() is not None
    return request.param


def _payloads(n, seed=0, rank=0):
    rng = np.random.default_rng(seed)
    return [
        {"meta": {"seq": 1000 + i, "session_id": "s", "sampler": "step_time", "global_rank": rank},
         "data": {"step": i, "values": [float(v) for v in rng.normal(size=64)]}}
        for i in range(n)
    ]


def _pending(client):
    """Published bytes the consumer has not committed (head - tail)."""
    return shm_ring._read_u64(client._mm, shm_ring._OFF_HEAD) - shm_ring._read_u64(client._mm, shm_ring._OFF_TAIL)


def _ring(tmp_path, name="seg.ring", **kw):
    return ShmRingClient(tmp_path / name, capacity=MIN_RING_BYTES, **kw)


def test_segment_bytes_are_the_jax_packages(tmp_path):
    a, b = bytearray(RING_HDR + 4096), bytearray(RING_HDR + 4096)
    shm_ring.init_ring_buffer(a, 4096, producer_gen=5)
    jax_ring.init_ring_buffer(b, 4096, producer_gen=5)
    assert a == b and shm_ring.validate_ring_buffer(a) == jax_ring.validate_ring_buffer(b) == 4096
    assert shm_ring.ring_segment_path(tmp_path / "sess", 3, tmp_path) == jax_ring.ring_segment_path(
        tmp_path / "sess", 3, tmp_path)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_segment_written_by_one_package_drains_in_the_other(tmp_path, impl, direction):
    """Many batches over a 64 KiB ring, wrapping it several times."""
    client_cls, consumer_cls, codec = (
        (ShmRingClient, jax_ring.ShmRingConsumer, jax_codec) if direction == "port_to_jax"
        else (jax_ring.ShmRingClient, ShmRingConsumer, msgpack_codec))
    client = client_cls(tmp_path / "x.ring", capacity=MIN_RING_BYTES)
    consumer = consumer_cls(client.path, 0)
    try:
        sent, got = [], []
        for i in range(120):
            batch = _payloads(3, seed=i)
            assert client.send_batch(batch), i
            sent.append(batch)
            if i % 5 == 4:
                got += [codec.decode(f) for f in consumer.drain()]
        got += [codec.decode(f) for f in consumer.drain()]
        assert got == sent
    finally:
        client.close()
        consumer.close()


def test_round_trip(tmp_path, impl):
    client = _ring(tmp_path)
    consumer = ShmRingConsumer(client.path, 0)
    try:
        payloads = _payloads(5)
        assert client.send_batch(payloads)
        frames = consumer.drain()
        assert [msgpack_codec.decode(f) for f in frames] == [payloads]
        assert (client.batches_sent, client.batches_dropped) == (1, 0)
    finally:
        client.close()
        consumer.close()


def test_torn_write_is_never_drained(tmp_path, impl):
    client = _ring(tmp_path)
    consumer = ShmRingConsumer(client.path, 0)
    try:
        client._mm[RING_HDR:RING_HDR + 64] = b"\xde\xad\xbe\xef" * 16  # bytes past head
        assert consumer.readable() == 0 and consumer.drain() == []
        payloads = _payloads(2)
        assert client.send_batch(payloads)
        assert [msgpack_codec.decode(f) for f in consumer.drain()] == [payloads]
    finally:
        client.close()
        consumer.close()


def test_producer_killed_inside_shm_write_leaves_no_torn_frame(tmp_path):
    """A real SIGKILL at the third publish (``shm.write`` kill9): the two
    published frames drain, nothing of the third."""
    path = tmp_path / "killed.ring"
    code = (
        "import sys\n"
        "from traceml_tpu_torch.transport.shm_ring import ShmRingClient, MIN_RING_BYTES\n"
        f"c = ShmRingClient({str(path)!r}, capacity=MIN_RING_BYTES)\n"
        "for i in range(3):\n"
        "    c.send_encoded_body(bytes([i]) * 1000)\n"
        "sys.exit(3)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO),
               TRACEML_FAULT_PLAN=json.dumps([{"point": "shm.write", "action": "kill9", "after": 2}]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, timeout=60)
    assert proc.returncode == -9, proc.stderr.decode()[-2000:]
    consumer = ShmRingConsumer(path, 0)
    try:
        assert consumer.drain() == [bytes([0]) * 1000, bytes([1]) * 1000]
        assert consumer.readable() == 0
    finally:
        consumer.close()


def test_full_ring_fails_one_send_then_recovers(tmp_path, impl):
    client = _ring(tmp_path)
    consumer = ShmRingConsumer(client.path, 0)
    try:
        big = b"x" * (MIN_RING_BYTES // 3)
        assert client.send_encoded_body(big) and client.send_encoded_body(big)
        assert not client.send_encoded_body(big)  # full: fail, never block
        assert (client.ring_full_drops, client.batches_dropped) == (1, 1)
        assert len(consumer.drain()) == 2
        assert client.send_encoded_body(big)  # the drain freed the space
    finally:
        client.close()
        consumer.close()


def test_frame_larger_than_ring_is_refused(tmp_path, impl):
    client = _ring(tmp_path)
    try:
        assert not client.send_encoded_body(b"x" * (MIN_RING_BYTES + 1))
        assert client.batches_dropped == 1 and client.ring_full_drops == 0
    finally:
        client.close()


def test_reattach_fails_exactly_one_send(tmp_path, impl):
    """A restarted aggregator's attach flips the consumer generation: one
    failed send (the durable sender replays on it), then sends flow, and
    the new consumer also drains what the dead one never committed."""
    client = _ring(tmp_path)
    first = ShmRingConsumer(client.path, 0)
    try:
        assert client.send_batch(_payloads(1))
        assert client.reconnects == 0
        first.close()
        second = jax_ring.ShmRingConsumer(client.path, 0)  # either package's consumer
        try:
            assert not client.send_batch(_payloads(1))
            assert client.reconnects == 1
            assert client.send_batch(_payloads(1))
            assert len(second.drain()) == 2
        finally:
            second.close()
    finally:
        client.close()


def test_hello_is_sent_again_after_a_reattach(tmp_path, impl):
    """A restarted aggregator starts with no hellos; the flip that its
    attach causes makes the publisher announce the transport again."""
    from traceml_tpu_torch.runtime.sender import TelemetryPublisher
    from traceml_tpu_torch.telemetry.control import TRANSPORT_HELLO, control_kind
    from traceml_tpu_torch.telemetry.envelope import SenderIdentity

    client = _ring(tmp_path)
    pub = TelemetryPublisher([], client, SenderIdentity(session_id="s", hostname="h", pid=1, global_rank=0),
                             transport_info={"kind": "shm", "compression": None})

    def hellos(consumer):
        return [m for f in consumer.drain() for m in msgpack_codec.decode(f)
                if control_kind(m) == TRANSPORT_HELLO]

    first = ShmRingConsumer(client.path, 0)
    try:
        pub.publish(extra_payloads=_payloads(1))
        pub.publish(extra_payloads=_payloads(1))
        assert [h["transport"] for h in hellos(first)] == ["shm"]  # once per connection
    finally:
        first.close()
    second = ShmRingConsumer(client.path, 0)
    try:
        pub.publish(extra_payloads=_payloads(1))  # the flip: this send fails
        assert client.reconnects == 1
        pub.publish(extra_payloads=_payloads(1))
        pub.publish(extra_payloads=_payloads(1))
        assert [h["transport"] for h in hellos(second)] == ["shm"]
    finally:
        second.close()
        client.close()


def test_corrupt_header_rejected(tmp_path):
    _ring(tmp_path).close()
    with open(tmp_path / "seg.ring", "r+b") as f:
        f.write(b"\x00\x00\x00\x00")
    with pytest.raises(ValueError, match="magic"):
        ShmRingConsumer(tmp_path / "seg.ring", 0)


@pytest.mark.parametrize("field,value,match", [
    ((4, "<I"), 2, "version"), ((8, "<Q"), 0, "capacity"), ((8, "<Q"), 1 << 40, "capacity"),
    ((24, "<Q"), 99, "invariant"),
])
def test_validate_rejects_what_the_jax_validator_rejects(field, value, match):
    buf = bytearray(RING_HDR + 1024)
    shm_ring.init_ring_buffer(buf, 1024, producer_gen=1)
    struct.pack_into(field[1], buf, field[0], value)
    for validate in (shm_ring.validate_ring_buffer, jax_ring.validate_ring_buffer):
        with pytest.raises(ValueError, match=match):
            validate(buf)


def test_registry_scan_marks_and_commit(tmp_path, impl):
    session = tmp_path / "session"
    client = ShmRingClient(tmp_path / "seg.ring", capacity=MIN_RING_BYTES, session_dir=session, global_rank=3)
    registry = ShmRingRegistry(session)
    try:
        (desc,) = scan_ring_descriptors(session)
        assert (desc["global_rank"], desc["path"]) == (3, str(client.path))
        assert desc == {**json.loads((session / "rank_3" / "shm_ring.json").read_text()),
                        "_descriptor": str(session / "rank_3" / "shm_ring.json")}
        batches = [_payloads(2, seed=s, rank=3) for s in range(3)]
        assert client.send_batch(batches[0]) and client.send_batch(batches[1])
        first = registry.poll()
        assert [t for t, _ in first] == ["shm:3", "shm:3"]
        assert client.send_batch(batches[2])
        second = registry.poll()
        assert [msgpack_codec.decode(f) for _, f in first + second] == batches
        assert registry.take_marks(1) is None  # the first mark covers two frames
        marks = registry.take_marks(3)  # both marks covered: the newest
        assert marks == {str(client.path): _pending(client)}
        assert _pending(client) == sum(4 + len(f) for _, f in first + second)  # nothing committed yet
        registry.commit({str(client.path): marks[str(client.path)] - 4 - len(second[0][1])})
        assert _pending(client) == 4 + len(second[0][1])
        stats = registry.stats()
        assert (stats["rings_attached"], stats["frames"], stats["quarantined"]) == (1, 3, 0)
        registry.close()
        assert registry.stats()["frames"] == 3  # counters outlive close (the final stats write)
        # a restarted aggregator resumes at the committed tail: the
        # uncommitted frame comes again
        again = ShmRingRegistry(session)
        assert [msgpack_codec.decode(f) for _, f in again.poll()] == [batches[2]]
        again.commit(again.cursors())
        assert _pending(client) == 0
        again.close()
    finally:
        registry.close()
        client.close()


def test_registry_quarantines_a_corrupt_segment(tmp_path):
    session = tmp_path / "session"
    ShmRingClient(tmp_path / "seg.ring", capacity=MIN_RING_BYTES, session_dir=session, global_rank=0).close()
    with open(tmp_path / "seg.ring", "r+b") as f:
        f.write(b"XXXX")
    registry = ShmRingRegistry(session)
    assert registry.poll() == []
    stats = registry.stats()
    assert (stats["attach_failures"], stats["quarantined"], stats["rings_attached"]) == (1, 1, 0)
    registry.close()


def test_registry_quarantines_a_ring_whose_frame_length_breaks(tmp_path, impl):
    session = tmp_path / "session"
    client = ShmRingClient(tmp_path / "seg.ring", capacity=MIN_RING_BYTES, session_dir=session, global_rank=0)
    registry = ShmRingRegistry(session)
    try:
        assert client.send_encoded_body(b"ok") and [f for _, f in registry.poll()] == [b"ok"]
        assert client.send_encoded_body(b"bad")
        struct.pack_into("<I", client._mm, RING_HDR + 6, MIN_RING_BYTES)  # the second frame's length
        assert registry.poll() == []
        assert registry.stats()["quarantined"] == 1 and registry.consumers == {}
    finally:
        registry.close()
        client.close()


def test_chaos_shm_write_corrupt_drops_one_batch(tmp_path, impl):
    chaos._reset_for_tests('[{"point": "shm.write", "action": "corrupt"}]')
    session = tmp_path / "session"
    try:
        client = ShmRingClient(tmp_path / "seg.ring", capacity=MIN_RING_BYTES, session_dir=session, global_rank=0)
        registry = ShmRingRegistry(session)
        first, good = _payloads(2), _payloads(3, seed=1)
        assert client.send_batch(first)  # the fault fires on this publish
        assert client.send_batch(good)
        tagged = registry.poll()
        assert len(tagged) == 2
        decoded = []
        for _tag, frame in tagged:
            try:
                decoded.append(msgpack_codec.decode(frame))
            except msgpack_codec.CodecError:
                decoded.append(None)
        # the flip broke the first batch; the ring's framing kept the next
        assert decoded[0] != first and decoded[1] == good
        client.close()
        registry.close()
    finally:
        chaos._reset_for_tests(None)


@pytest.mark.parametrize("action", ["reset", "truncate", "stall"])
def test_chaos_shm_write_failing_and_stalling_actions(tmp_path, action):
    chaos._reset_for_tests(json.dumps([{"point": "shm.write", "action": action, "arg": 0.01}]))
    try:
        client = _ring(tmp_path)
        consumer = ShmRingConsumer(client.path, 0)
        assert client.send_encoded_body(b"one") == (action == "stall")
        assert client.send_encoded_body(b"two")
        assert consumer.drain() == ([b"one", b"two"] if action == "stall" else [b"two"])
        client.close()
        consumer.close()
    finally:
        chaos._reset_for_tests(None)


def test_chaos_shm_attach_corrupt_quarantines(tmp_path):
    chaos._reset_for_tests('[{"point": "shm.attach", "action": "corrupt"}]')
    session = tmp_path / "session"
    try:
        client = ShmRingClient(tmp_path / "seg.ring", capacity=MIN_RING_BYTES, session_dir=session, global_rank=0)
        registry = ShmRingRegistry(session)
        assert registry.poll() == []
        assert registry.stats()["attach_failures"] == 1
        client.close()
        registry.close()
    finally:
        chaos._reset_for_tests(None)


def test_default_ring_dir_and_capacity_come_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("TRACEML_SHM_RING_BYTES", str(2 * MIN_RING_BYTES))
    path = shm_ring.ring_segment_path(tmp_path / "sess", 0)
    assert path.parent == tmp_path / "shm" and path.name == jax_ring.ring_segment_path(tmp_path / "sess", 0).name
    client = ShmRingClient(path)
    try:
        assert os.path.getsize(path) == RING_HDR + 2 * MIN_RING_BYTES
    finally:
        client.close()
    monkeypatch.setenv("TRACEML_SHM_RING_BYTES", "garbage")
    assert shm_ring._env_ring_bytes() == shm_ring.DEFAULT_RING_BYTES
