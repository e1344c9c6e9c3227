"""The port's wire path against the JAX package's, under both codecs.

The same payloads (a step-time envelope from the incremental sender over
rows made from a numpy seed, and a ``rank_finished`` control message) go
from a port ``TCPClient`` to a JAX ``TCPServer`` and from a JAX client to
a port server, in-process; both sides decode to the same payloads and
normalize to the same envelopes.  Both servers are read the way the
aggregator reads them: ``drain_tagged`` then ``decode_tagged``.  Each case runs with msgpack and with
the JSON fallback (the codec flag patched off in both packages), which is
what a host without msgpack uses.  The port's batch body is byte-for-byte
the JAX package's.  Garbage frames bump ``decode_errors`` and the sending
peer's ``corrupt_frame_drops`` without killing the server; a client with
no server returns False.  The publisher's ``producer_stats`` count every
send whose time they hold.
"""

import socket
import struct
import time

import numpy as np
import pytest

from traceml_tpu.database.database import Database as JaxDatabase
from traceml_tpu.database.database_sender import DBIncrementalSender as JaxSender
from traceml_tpu.telemetry.control import build_rank_finished as jax_rank_finished
from traceml_tpu.telemetry.envelope import SenderIdentity as JaxIdentity
from traceml_tpu.telemetry.envelope import normalize_telemetry_envelope as jax_normalize
from traceml_tpu.transport.tcp_transport import TCPClient as JaxClient
from traceml_tpu.transport.tcp_transport import TCPServer as JaxServer
from traceml_tpu.utils import msgpack_codec as jax_codec
from traceml_tpu_torch.database.database import Database
from traceml_tpu_torch.database.database_sender import DBIncrementalSender
from traceml_tpu_torch.runtime.sender import TelemetryPublisher
from traceml_tpu_torch.samplers.base_sampler import BaseSampler
from traceml_tpu_torch.telemetry.control import build_rank_finished
from traceml_tpu_torch.telemetry.envelope import SenderIdentity, normalize_telemetry_envelope
from traceml_tpu_torch.transport.tcp_transport import TCPClient, TCPServer
from traceml_tpu_torch.utils import msgpack_codec

PHASES = ("step_time", "dataloader_next", "h2d_time", "compute_time")


@pytest.fixture(params=["msgpack", "json"])
def codec(request, monkeypatch):
    if request.param == "json":
        monkeypatch.setattr(msgpack_codec, "_HAVE_MSGPACK", False)
        monkeypatch.setattr(jax_codec, "_HAVE_MSGPACK", False)
    assert msgpack_codec.codec_name() == jax_codec.codec_name() == request.param
    return request.param


def _rows(seed, n=12):
    rng = np.random.default_rng(seed)
    rows = []
    for step in range(1, n + 1):
        events = {
            f"_traceml_internal:{p}": {
                "cpu_ms": float(rng.uniform(0.1, 20.0)),
                "device_ms": float(rng.uniform(0.1, 20.0)),
                "count": 1,
            }
            for p in PHASES
        }
        rows.append({"step": step, "timestamp": 1.7e9 + step, "clock": "device", "events": events})
    return rows


def _payloads(seed):
    db = Database()
    db.add_records("step_time", _rows(seed))
    sender = DBIncrementalSender("step_time", db)
    sender.set_identity(SenderIdentity(session_id="s", global_rank=1, world_size=2, hostname="h", pid=7))
    envelope = sender.collect_payload()
    envelope["meta"]["seq"] = 5
    return [envelope, build_rank_finished({"global_rank": 1, "rank": 1})]


def _drain(server, n, timeout=5.0):
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        server.wait_for_data(0.05)
        out.extend(server.decode_tagged(server.drain_tagged()))
    return out


def _send(server_cls, client_cls, payloads):
    server = server_cls()
    server.start()
    try:
        client = client_cls("127.0.0.1", server.port)
        assert client.send_batch(payloads)
        got = _drain(server, len(payloads))
        client.close()
        return got, server.decode_errors
    finally:
        server.stop()


def test_senders_build_the_same_wire_tables():
    rows = _rows(3)
    port_db, jax_db = Database(), JaxDatabase()
    port_db.add_records("step_time", rows[:7])
    jax_db.add_records("step_time", rows[:7])
    port, jax = DBIncrementalSender("step_time", port_db), JaxSender("step_time", jax_db)
    port.set_identity(SenderIdentity(session_id="s", global_rank=2, hostname="h", pid=9))
    jax.set_identity(JaxIdentity(session_id="s", global_rank=2, hostname="h", pid=9))
    batches = [(port.collect_payload(), jax.collect_payload())]
    port_db.add_records("step_time", rows[7:])
    jax_db.add_records("step_time", rows[7:])
    batches.append((port.collect_payload(), jax.collect_payload()))  # only the new rows
    for a, b in batches:
        assert a["body"] == b["body"]
        assert {k: v for k, v in a["meta"].items() if k != "timestamp"} == {
            k: v for k, v in b["meta"].items()
            if k not in ("timestamp", "platform", "device_kind")
        }
    assert [a["body"]["tables"]["step_time"]["n"] for a, _ in batches] == [7, 5]
    assert port.collect_payload() is None and jax.collect_payload() is None
    meta = {"global_rank": 2, "rank": 2}
    ours, theirs = build_rank_finished(meta), jax_rank_finished(meta)
    assert ours.keys() == theirs.keys() and ours["_traceml_control"] == theirs["_traceml_control"]


def test_batch_body_is_the_jax_packages_bytes(codec):
    payloads = _payloads(0)
    port_body = msgpack_codec.encode_batch([msgpack_codec.preencode(p) for p in payloads])
    assert port_body == jax_codec.encode(payloads)
    assert port_body[:1] == (b"\x01" if codec == "msgpack" else b"\x02")


def test_port_client_and_jax_client_decode_to_the_same_envelopes(codec):
    payloads = _payloads(1)
    at_jax, jax_errors = _send(JaxServer, TCPClient, payloads)
    at_port, port_errors = _send(TCPServer, JaxClient, payloads)
    assert (jax_errors, port_errors) == (0, 0)
    assert at_jax == at_port
    assert len(at_port) == 2
    env_jax, env_port = jax_normalize(at_jax[0]), normalize_telemetry_envelope(at_port[0])
    assert env_jax.meta == env_port.meta and env_port.seq == 5
    assert env_jax.tables == env_port.tables == {"step_time": _rows(1)}
    assert env_port.global_rank == 1 and env_port.sampler == "step_time"
    assert at_port[1]["_traceml_control"] == "rank_finished"
    assert normalize_telemetry_envelope(at_port[1]) is None  # control, not telemetry


def test_garbage_frames_count_decode_errors_and_the_server_lives(codec):
    server = TCPServer()
    server.start()
    try:
        raw = socket.create_connection(("127.0.0.1", server.port))
        raw_peer = "%s:%d" % raw.getsockname()
        good = msgpack_codec.encode({"ok": 1})
        for body in (b"\x09junk", b"\x02{not json", b"\x01\xc1", good):
            raw.sendall(struct.pack(">I", len(body)) + body)
        got = _drain(server, 1)
        assert got == [{"ok": 1}]
        assert server.decode_errors == 3
        assert server.corrupt_frame_drops == {raw_peer: 3}
        # a corrupt LENGTH evicts that client only, and counts against it
        raw.sendall(struct.pack(">I", 1 << 31))
        deadline = time.monotonic() + 5.0
        while server.corrupt_frame_drops[raw_peer] < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.corrupt_frame_drops == {raw_peer: 4}
        client = TCPClient("127.0.0.1", server.port)
        assert client.send_batch([{"after": True}])
        assert _drain(server, 1) == [{"after": True}]
        assert server.decode_errors == 3
        assert server.corrupt_frame_drops == {raw_peer: 4}
        raw.close()
        client.close()
    finally:
        server.stop()


def test_client_with_no_server_returns_false():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()  # a port nothing listens on
    client = TCPClient("127.0.0.1", port, reconnect_backoff=0.001)
    assert client.send_batch([{"x": 1}]) is False
    assert client.send_batch([{"x": 2}]) is False
    assert (client.batches_sent, client.batches_dropped) == (0, 2)
    client.close()


class _RowsSampler(BaseSampler):
    name = "step_time"

    def _sample(self):
        pass


def test_publisher_stats_count_each_timed_send():
    """``flush_us`` and ``flushes`` cover the same sends: the final batch's
    ``producer_stats`` rides in the send it cannot time, so it counts
    neither; a later ``stats()`` counts both."""
    rows = _rows(4)
    server = TCPServer()
    server.start()
    try:
        sampler = _RowsSampler()
        identity = SenderIdentity(session_id="s", global_rank=0, world_size=1, hostname="h", pid=3)
        pub = TelemetryPublisher([sampler], TCPClient("127.0.0.1", server.port), identity)
        sampler.db.add_records("step_time", rows[:5])
        assert pub.publish() == 2  # busy: the transport hello and one envelope
        assert pub.publish() == 0  # idle: nothing new, heartbeat not due
        sampler.db.add_records("step_time", rows[5:])
        finished = build_rank_finished(identity.to_meta())
        assert pub.publish([finished], final=True) == 3  # envelope, marker, stats
        got = _drain(server, 5)
    finally:
        server.stop()
    stats = [p["stats"] for p in got if p.get("_traceml_control") == "producer_stats"]
    assert len(stats) == 1
    sent = stats[0]
    assert (sent["ticks"], sent["idle_ticks"], sent["flushes"]) == (3, 1, 1)
    assert sent["samplers"]["step_time"]["envelopes"] == 2
    assert sent["transport"]["batches_sent"] == 1
    after = pub.stats()
    assert (after["flushes"], after["transport"]["batches_sent"]) == (2, 2)
    assert after["flush_us"] >= sent["flush_us"]
    tables = [normalize_telemetry_envelope(p).tables["step_time"] for p in got if "_traceml_control" not in p]
    assert tables == [rows[:5], rows[5:]]
    assert [(p["transport"], p["compression"]) for p in got
            if p.get("_traceml_control") == "transport_hello"] == [("tcp", None)]
