"""The port's transport selection and envelope compression against the JAX
package's, and the golden test of every transport.

* ``choose_transport``, ``resolve_compression``, ``server_transport_config``
  and ``default_uds_path`` equal JAX's over the whole grid (modes, hosts,
  socket paths, compression requests; the socket's directory is the
  process's temporary directory where JAX's is ``/tmp``, the name the
  same), and so does ``create_transport_client``'s ``info``.
* A ring that fails to set up falls back to ``tcp`` with
  ``fallback_from``; a forced ``tcp`` client is the plain ``TCPClient``
  with no codec, and a forced ``tcp`` aggregator has no Unix listener and
  no ring registry.
* For zstd and zlib the port's carrier bytes equal JAX's for the same
  envelope, each package restores the other's carriers, and both pass
  small and incompressible bodies through and reject a corrupt carrier
  or a bomb.  The replay spool re-sends a carrier's bytes as they are,
  compressing nothing twice, as JAX's does.
* The golden test: the same envelopes (step-time rows from a numpy seed)
  sent over tcp (the C and the Python frame split), uds, shm (``ring.c``
  and the twin) and the compressed arms decode to equal lists in the
  port's server (``dev/transport_bench.py``, the arms ``chip_smoke.py``
  times on the card), and a JAX ring drains into the port's server.
"""

import tempfile
import types
from pathlib import Path

import numpy as np
import pytest

from test_torch_sqlite import step_rows
from traceml_tpu.transport import compression as jax_comp
from traceml_tpu.transport import select as jax_select
from traceml_tpu.transport import shm_ring as jax_ring
from traceml_tpu.transport import spool as jax_spool
from traceml_tpu.utils import msgpack_codec as jax_codec
from traceml_tpu_torch.aggregator.trace_aggregator import TraceMLAggregator
from traceml_tpu_torch.dev.transport_bench import ARMS, run_arms
from traceml_tpu_torch.runtime.settings import AggregatorEndpoint, TraceMLSettings
from traceml_tpu_torch.telemetry.envelope import rows_to_columns
from traceml_tpu_torch.transport import compression, select, shm_ring, spool
from traceml_tpu_torch.transport.shm_ring import ShmRingClient, ShmRingRegistry
from traceml_tpu_torch.transport.tcp_transport import TCPClient, TCPServer, UDSClient
from traceml_tpu_torch.utils import msgpack_codec

MODES = ("auto", "shm", "uds", "tcp", "", "TCP", " Auto ", "bogus")
HOSTS = ("127.0.0.1", "localhost", "LOCALHOST", "::1", "0.0.0.0", "10.0.0.7", "gpu-worker-3")
UDS_PATHS = (None, "", "/tmp/explicit.sock")
REQUESTS = ("auto", "", "0", "off", "none", "false", "1", "on", "yes", "true", "zstd", "zlib", "ZLIB", "lz4")
CODECS = [c for c in ("zstd", "zlib") if c in compression.available_codecs() and c in jax_comp.available_codecs()]


@pytest.fixture(autouse=True)
def _rings_under_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("TRACEML_SHM_DIR", str(tmp_path / "shm"))


def _settings(tmp_path, **kw):
    agg = types.SimpleNamespace(connect_host=kw.pop("connect_host", "127.0.0.1"), port=kw.pop("port", 59999))
    base = dict(transport="auto", transport_compress="auto", shm_ring_bytes=1 << 20,
                shm_dir=str(tmp_path / "shmdir"), uds_path=None, session_dir=tmp_path / "session")
    base.update(kw)
    return types.SimpleNamespace(aggregator=agg, **base)


def _to_jax_socket(path, session_dir):
    """The port's default socket path in JAX's spelling (``/tmp``)."""
    return jax_select.default_uds_path(session_dir) if path == select.default_uds_path(session_dir) else path


# -- the selection policy over the grid -----------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_choose_transport_equals_jax_over_the_grid(mode):
    for host in HOSTS:
        for uds in UDS_PATHS:
            assert select.choose_transport(mode, host, uds) == jax_select.choose_transport(mode, host, uds), (
                mode, host, uds)


@pytest.mark.parametrize("kind", ("shm", "uds", "tcp"))
def test_resolve_compression_equals_jax_over_the_grid(kind):
    for req in REQUESTS:
        for host in HOSTS:
            assert select.resolve_compression(kind, req, host) == jax_select.resolve_compression(kind, req, host), (
                kind, req, host)
    assert select.resolve_compression("tcp", "auto", "10.0.0.7") == compression.available_codecs()[0]
    assert select.resolve_compression("tcp", "auto", "127.0.0.1") is None
    assert select.resolve_compression("shm", "zlib", "10.0.0.7") is None


@pytest.mark.parametrize("mode", MODES)
def test_server_transport_config_equals_jax_over_the_grid(tmp_path, mode):
    """Equal to JAX for every mode it knows; an unknown one reads as
    ``auto`` on both ends of the port, where the JAX server stands up
    nothing for the rings its ranks then write (a repaired divergence)."""
    for uds in UDS_PATHS:
        s = _settings(tmp_path, transport=mode, uds_path=uds)
        port = select.server_transport_config(s)
        port["uds_path"] = _to_jax_socket(port["uds_path"], s.session_dir)
        if mode.strip().lower() in ("", "auto", "shm", "uds", "tcp"):
            assert port == jax_select.server_transport_config(s), (mode, uds)
        else:
            assert port == jax_select.server_transport_config(_settings(tmp_path, transport="auto", uds_path=uds))
            assert jax_select.server_transport_config(s) == {"uds_path": None, "enable_rings": False}
            assert select.choose_transport(mode, "127.0.0.1", uds) == "shm"


def test_default_uds_path_is_jaxs_name_in_the_temp_dir(tmp_path, monkeypatch):
    for session in (tmp_path / "a", tmp_path / ("x" * 80) / "session", tmp_path / "a" / ".." / "a"):
        port, jax = select.default_uds_path(session), jax_select.default_uds_path(session)
        name = jax.rsplit("/", 1)[1]
        fits = len(f"{tempfile.gettempdir()}/{name}".encode()) <= 107
        assert port.rsplit("/", 1) == [tempfile.gettempdir() if fits else "/tmp", name] and len(port) <= 107
    assert select.default_uds_path(tmp_path / "a") != select.default_uds_path(tmp_path / "b")
    monkeypatch.setattr(tempfile, "tempdir", "/tmp")
    assert select.default_uds_path(tmp_path / "a") == jax_select.default_uds_path(tmp_path / "a")
    monkeypatch.setattr(tempfile, "tempdir", "/" + "t" * 120)  # too long for a socket address: /tmp
    assert select.default_uds_path(tmp_path / "a") == jax_select.default_uds_path(tmp_path / "a")


@pytest.mark.parametrize("mode", ("auto", "shm", "uds", "tcp"))
@pytest.mark.parametrize("host", ("127.0.0.1", "10.0.0.7"))
def test_create_transport_client_info_equals_jax(tmp_path, mode, host):
    s = _settings(tmp_path, transport=mode, connect_host=host)
    port_client, port_info = select.create_transport_client(s, 0)
    jax_client, jax_info = jax_select.create_transport_client(s, 1)
    try:
        assert port_info == jax_info
        assert port_client.kind == jax_client.kind == port_info["kind"]
    finally:
        port_client.close()
        jax_client.close()


def test_no_port_means_no_client(tmp_path):
    assert select.create_transport_client(_settings(tmp_path, port=0), 0) == (None, {"kind": None,
                                                                                     "compression": None})


def test_auto_on_loopback_is_the_ring_with_its_descriptor(tmp_path):
    s = _settings(tmp_path)
    client, info = select.create_transport_client(s, 0)
    try:
        assert isinstance(client, ShmRingClient) and info == {"kind": "shm", "compression": None}
        assert client.path.parent == tmp_path / "shmdir" and client._capacity == 1 << 20
        assert (s.session_dir / "rank_0" / "shm_ring.json").exists()
    finally:
        client.close()


def test_forced_tcp_is_the_plain_client_and_server(tmp_path):
    s = _settings(tmp_path, transport="tcp", transport_compress="auto")
    client, info = select.create_transport_client(s, 0)
    try:
        assert type(client) is TCPClient and info == {"kind": "tcp", "compression": None}
    finally:
        client.close()
    agg = TraceMLAggregator(TraceMLSettings(session_id="t", logs_dir=tmp_path / "logs", transport="tcp",
                                            aggregator=AggregatorEndpoint()))
    assert agg.ring_registry is None and agg.server._uds_path is None and agg.server._rings is None
    auto = TraceMLAggregator(TraceMLSettings(session_id="t", logs_dir=tmp_path / "logs"))
    assert isinstance(auto.ring_registry, ShmRingRegistry) and auto.server._rings is auto.ring_registry
    assert auto.server._uds_path == select.default_uds_path(tmp_path / "logs" / "t")


def test_forced_uds_uses_the_session_socket(tmp_path):
    s = _settings(tmp_path, transport="uds")
    client, info = select.create_transport_client(s, 0)
    try:
        assert isinstance(client, UDSClient) and info == {"kind": "uds", "compression": None}
        assert client._path == select.default_uds_path(s.session_dir)
    finally:
        client.close()


def test_failed_ring_setup_falls_back_to_tcp(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")  # the segment's parent is a file: mkdir raises
    client, info = select.create_transport_client(_settings(tmp_path, shm_dir=str(blocker)), 0)
    try:
        assert type(client) is TCPClient
        assert info == {"kind": "tcp", "compression": None, "fallback_from": "shm"}
    finally:
        client.close()


# -- the compression carrier ----------------------------------------------


def _envelope(seed=0, n=40):
    rows = step_rows(seed, n, 2.0, 18.0)
    meta = {"seq": 7 + seed, "session_id": "s", "sampler": "step_time", "global_rank": 2, "schema": 2,
            "timestamp": 1.7e9}
    return {"meta": meta, "body": {"tables": {"step_time": rows_to_columns(rows)}}}


@pytest.mark.parametrize("codec", CODECS)
def test_carrier_bytes_equal_jax_and_decode_across_packages(codec):
    env = _envelope()
    port = compression.EnvelopeCompressor(codec).wrap(msgpack_codec.preencode(env))
    jax = jax_comp.EnvelopeCompressor(codec).wrap(jax_codec.preencode(env))
    assert port.raw == jax.raw and compression.is_compressed_payload(port.obj)
    assert port.obj["meta"] == {"compression": codec, "seq": 7, "global_rank": 2, "session_id": "s",
                                "sampler": "step_time"}
    on_wire = msgpack_codec.decode(port.body)
    assert compression.unwrap_payload(on_wire) == jax_comp.unwrap_payload(on_wire) == env
    assert compression.unwrap_payload(jax_codec.decode(jax.body())) == env


@pytest.mark.parametrize("codec", CODECS)
def test_stats_and_pass_through_equal_jax(codec):
    rng = np.random.default_rng(3)
    envs = [_envelope(s) for s in range(3)] + [
        {"meta": {"seq": 1}},  # below MIN_COMPRESS_BYTES
        {"meta": {"seq": 2}, "data": {"blob": rng.integers(0, 256, size=4096, dtype=np.uint8).tobytes()}},
    ]
    port, jax = compression.EnvelopeCompressor(codec), jax_comp.EnvelopeCompressor(codec)
    for env in envs:
        enc = msgpack_codec.preencode(env)
        wrapped = port.wrap(enc)
        assert wrapped.raw == jax.wrap(jax_codec.preencode(env)).raw
        assert (wrapped is enc) == (env["meta"]["seq"] in (1, 2))
    assert port.stats() == jax.stats()
    assert (port.envelopes_compressed, port.envelopes_passthrough) == (3, 2) and port.stats()["ratio"] > 1.0


@pytest.mark.parametrize("codec", CODECS)
def test_corrupt_carrier_and_bomb_are_rejected_by_both(codec):
    wrapped = compression.EnvelopeCompressor(codec, min_bytes=0).wrap(msgpack_codec.preencode(_envelope()))
    corrupt = dict(wrapped.obj, z=b"\x00" * len(wrapped.obj["z"]))
    bomb = dict(wrapped.obj, n=compression.MAX_DECOMPRESSED_BYTES + 1)
    short = dict(wrapped.obj, n=wrapped.obj["n"] - 1)
    for carrier in (corrupt, bomb, short, dict(wrapped.obj, z="text")):
        with pytest.raises(compression.CompressionError):
            compression.unwrap_payload(carrier)
        with pytest.raises(jax_comp.CompressionError):
            jax_comp.unwrap_payload(carrier)
    plain = _envelope()
    assert compression.unwrap_payload(plain) is plain


def test_server_drops_and_counts_a_corrupt_carrier(tmp_path):
    good = compression.EnvelopeCompressor("zlib").wrap(msgpack_codec.preencode(_envelope(1)))
    bad = msgpack_codec.preencode(dict(good.obj, z=b"\x01" * 8))
    server = TCPServer()
    payloads = server.decode_tagged([("1.2.3.4:5", msgpack_codec.encode_batch([good, bad]))])
    assert payloads == [_envelope(1)]
    assert (server.compressed_envelopes, server.decompress_errors, server.decode_errors) == (1, 1, 1)
    assert server.corrupt_frame_drops == {"1.2.3.4:5": 1}
    assert server.decompressed_bytes == good.obj["n"] and server.compressed_bytes_in == len(good.obj["z"])


class _FlakyClient:
    """Fails its first ``fail`` sends; records every body it takes."""

    kind = "tcp"

    def __init__(self, fail):
        self.fail, self.bodies = fail, []
        self.reconnects = self.batches_sent = self.batches_dropped = 0

    def send_batch(self, payloads):
        return self.send_encoded_body(msgpack_codec.encode_batch(payloads))

    def send_encoded_body(self, body):
        if self.fail:
            self.fail -= 1
            return False
        self.bodies.append(body)
        return True


@pytest.mark.parametrize("codec", CODECS)
def test_spool_replays_carriers_as_raw_bytes_like_jax(tmp_path, monkeypatch, codec):
    carriers = [compression.EnvelopeCompressor(codec).wrap(msgpack_codec.preencode(_envelope(s))) for s in range(3)]
    jax_carriers = [jax_comp.EnvelopeCompressor(codec).wrap(jax_codec.preencode(_envelope(s))) for s in range(3)]
    port, jax = _FlakyClient(1), _FlakyClient(1)
    port_sender = spool.DurableSender(port, spool.ReplaySpool(tmp_path / "p"))
    jax_sender = jax_spool.DurableSender(jax, jax_spool.ReplaySpool(tmp_path / "j"))
    assert not port_sender.send(carriers) and not jax_sender.send(jax_carriers)

    def no_second_compression(*_a, **_k):
        raise AssertionError("a replay compressed again")

    monkeypatch.setattr(compression, "compress_bytes", no_second_compression)
    assert port_sender.replay() and jax_sender.replay()
    want = msgpack_codec.MSGPACK_PREFIX + msgpack_codec.pack_array_header(3) + b"".join(c.raw for c in carriers)
    assert port.bodies == jax.bodies == [want]
    assert port_sender.stats()["replayed_envelopes"] == 3


# -- the golden test --------------------------------------------------------


def _bench_envelopes(n=90):
    envs = []
    for i in range(n):
        env = _envelope(seed=i, n=1 + i % 7)
        env["meta"]["seq"] = 100 + i
        envs.append(msgpack_codec.preencode(env))
    return envs


def test_every_arm_decodes_the_same_envelopes(tmp_path):
    out = run_arms(_bench_envelopes(), ring_dir=tmp_path, repeats=1)
    assert set(out["arms"]) == set(a for a in ARMS if not a.startswith("tcp_z") or a[4:] in CODECS)
    for arm, got in out["arms"].items():
        assert got["equal"] and got["decompress_errors"] == 0, (arm, got)
        assert (got["compressed"] > 0) == arm.startswith("tcp_z"), (arm, got)
    for codec in CODECS:
        assert out["codecs"][codec]["ratio"] > 1.0 and out["codecs"][codec]["compressed"] > 0
    assert list(tmp_path.iterdir()) == []  # every segment removed


def test_two_bench_calls_given_one_ring_dir_share_no_segment(tmp_path, monkeypatch):
    """Each ``run_arms`` call keeps its rings in a private directory under
    ``ring_dir``: two calls at once (a parent's and a change's run on one
    machine) never open one another's segment."""
    from traceml_tpu_torch.transport import shm_ring as port_ring

    paths = []

    class Recording(port_ring.ShmRingClient):
        def __init__(self, path, *a, **k):
            paths.append(Path(path))
            super().__init__(path, *a, **k)

    monkeypatch.setattr(port_ring, "ShmRingClient", Recording)
    calls = []
    for _ in range(2):
        before = len(paths)
        run_arms(_bench_envelopes(12), ring_dir=tmp_path, repeats=1)
        calls.append(set(paths[before:]))
    assert calls[0] and calls[1] and not calls[0] & calls[1]
    for p in calls[0] | calls[1]:
        assert p.parent.parent == tmp_path  # a directory of the call's own under ring_dir
    assert len({p.parent for p in calls[0]}) == len({p.parent for p in calls[1]}) == 1
    assert list(tmp_path.iterdir()) == []


def test_a_jax_ring_drains_into_the_port_server(tmp_path):
    session = tmp_path / "session"
    jax_client = jax_ring.ShmRingClient(tmp_path / "j.ring", capacity=shm_ring.MIN_RING_BYTES,
                                        session_dir=session, global_rank=4)
    server = TCPServer()
    server.attach_ring_registry(ShmRingRegistry(session))
    server.start()
    want = [_envelope(s) for s in range(4)]
    got = []
    try:
        for env in want:
            assert jax_client.send_batch([env])
        for _ in range(200):
            server.wait_for_data(0.05)
            tagged = server.drain_tagged()
            assert {t for t, _ in tagged} <= {"shm:4"}
            got += server.decode_tagged(tagged)
            if len(got) >= len(want):
                break
    finally:
        server.stop()
        jax_client.close()
    assert got == want and server.frames_by_transport == {"shm": 4}
