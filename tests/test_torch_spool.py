"""The port's replay spool, durable sender and chaos plans against the
JAX package's.

* ``ReplaySpool``: the same appends (bodies and seqs made from a numpy
  seed, with a small segment size and bound so segments rotate and the
  oldest are evicted), ``consume_through``, a reopen, a torn tail and
  appends after recovery go through the JAX spool and the port's.  Both
  give the same frames, the same segment files byte for byte (their
  ``time_ns`` names excepted) and the same counters.
* ``DurableSender``: the same batches through both senders over a fake
  client whose link goes down and comes back.  They send the same
  payloads (the replay bodies byte for byte), spool the ring of recent
  sends on the first failure, replay it on reconnect, never spool a
  heartbeat, and report the same stats.
* ``TRACEML_FAULT_PLAN``: the same plans, given the same events at each
  point and the same ``RANK``, fire at the same events in both ``chaos``
  modules (``os.kill`` is patched, so ``kill9`` only records).
"""

import os
import signal

import numpy as np
import pytest

from traceml_tpu.dev import chaos as jax_chaos
from traceml_tpu.transport.spool import DurableSender as JaxDurableSender
from traceml_tpu.transport.spool import ReplaySpool as JaxSpool
from traceml_tpu.utils import msgpack_codec as jax_codec
from traceml_tpu_torch.dev import chaos
from traceml_tpu_torch.transport.spool import DurableSender, ReplaySpool
from traceml_tpu_torch.utils import msgpack_codec

SEGMENT_BYTES = 700
MAX_BYTES = 2500


def _frames(seed, n, first_seq):
    rng = np.random.default_rng(seed)
    return [(first_seq + i, rng.bytes(int(rng.integers(20, 180)))) for i in range(n)]


def _segment_bytes(spool):
    return [seg.path.read_bytes() for seg in spool._segments]


def _state(spool):
    return {
        "frames": list(spool.iter_frames()),
        "segments": _segment_bytes(spool),
        "pending_frames": spool.pending_frames(),
        "pending_bytes": spool.pending_bytes(),
        "max_seq": spool.max_seq(),
        "appended": spool.appended_frames,
        "evicted": (spool.evicted_frames, spool.evicted_bytes),
        "torn_tails": spool.torn_tails,
    }


def _both(tmp_path, **kw):
    return (JaxSpool(tmp_path / "jax", **kw), ReplaySpool(tmp_path / "port", **kw))


def test_spool_frames_segments_and_counters_match(tmp_path):
    kw = {"max_bytes": MAX_BYTES, "segment_bytes": SEGMENT_BYTES}
    jax, port = _both(tmp_path, **kw)
    for seq, raw in _frames(0, 40, 1000):
        assert jax.append(seq, raw) and port.append(seq, raw)
    a, b = _state(jax), _state(port)
    assert a == b
    assert a["evicted"][0] > 0 and len(a["segments"]) > 1  # the bound evicted whole segments
    assert a["pending_bytes"] <= MAX_BYTES
    # every frame is TMS1 | u32 len | u64 seq | body
    first_seq, first_raw = b["frames"][0]
    head = b["segments"][0][:16]
    assert head[:4] == b"TMS1"
    assert int.from_bytes(head[4:8], "big") == 8 + len(first_raw)
    assert int.from_bytes(head[8:16], "big") == first_seq

    # a consumer that replayed through the middle of a segment
    mid = b["frames"][len(b["frames"]) // 2][0]
    jax.consume_through(mid)
    port.consume_through(mid)
    assert _state(jax) == _state(port)
    assert _state(port)["frames"][0][0] <= mid + 1  # a part-replayed segment stays whole

    # reopen: recovery finds the same frames; the next appends open a
    # fresh segment
    jax.close()
    port.close()
    jax, port = _both(tmp_path, **kw)
    assert _state(jax) == _state(port)
    for seq, raw in _frames(1, 5, 2000):
        jax.append(seq, raw)
        port.append(seq, raw)
    assert _state(jax) == _state(port)
    jax.clear()
    port.clear()
    assert _state(jax) == _state(port)
    assert _state(port)["pending_frames"] == 0


@pytest.mark.parametrize("cut", [3, 11, 40], ids=["in-header", "in-seq", "in-body"])
def test_spool_recovers_from_a_torn_tail(tmp_path, cut):
    kw = {"max_bytes": 1 << 20, "segment_bytes": 1 << 16}
    jax, port = _both(tmp_path, **kw)
    frames = _frames(2, 6, 50)
    for seq, raw in frames:
        jax.append(seq, raw)
        port.append(seq, raw)
    jax.close()
    port.close()
    # the process died mid-append: a partial frame at the tail
    torn = b"TMS1" + (8 + 100).to_bytes(4, "big") + (56).to_bytes(8, "big") + bytes(100)
    for spool in (jax, port):
        with spool._segments[-1].path.open("ab") as f:
            f.write(torn[:cut])
    jax, port = _both(tmp_path, **kw)
    a, b = _state(jax), _state(port)
    assert a == b
    assert b["torn_tails"] == 1 and b["frames"] == frames
    # appends after recovery never follow the torn tail
    for seq, raw in _frames(3, 2, 60):
        jax.append(seq, raw)
        port.append(seq, raw)
    a, b = _state(jax), _state(port)
    assert a == b and b["frames"][-2:] == _frames(3, 2, 60)


class FakeClient:
    """A link that is up or down; records what went over it."""

    kind = "tcp"

    def __init__(self, codec):
        self.codec = codec
        self.up = True
        self.sent = []  # ("batch", decoded objects) or ("body", bytes)

    def send_batch(self, payloads):
        if not self.up:
            return False
        self.sent.append(("batch", self.codec.decode(self.codec.encode_batch(payloads))))
        return True

    def send_encoded_body(self, body):
        if not self.up:
            return False
        self.sent.append(("body", body))
        return True


def _payload(seq, sampler="step_time", n=3):
    return {"meta": {"session_id": "s", "global_rank": 1, "sampler": sampler, "seq": seq},
            "body": {"tables": {sampler: [{"step": seq * 10 + i, "timestamp": 1.7e9 + i} for i in range(n)]}}}


def _drive(sender, client):
    """Healthy sends, a failure (ring and batch spooled), more sends on
    a dead link, a heartbeat, the link back (replay, then the batch)."""
    seq = iter(range(1, 1000))
    results = []
    for _ in range(4):
        results.append(sender.send([_payload(next(seq)), _payload(next(seq), "process")]))
    client.up = False
    for _ in range(3):
        results.append(sender.send([_payload(next(seq))]))
    results.append(sender.send_transient([{"meta": {"kind": "rank_heartbeat", "seq": next(seq)}}]))
    client.up = True
    results.append(sender.send([_payload(next(seq))]))
    results.append(sender.send([_payload(next(seq))]))
    return results


def test_durable_sender_matches_and_replays_the_ring(tmp_path):
    jax_client, port_client = FakeClient(jax_codec), FakeClient(msgpack_codec)
    jax = JaxDurableSender(jax_client, JaxSpool(tmp_path / "jax"), ring_envelopes=5, replay_batch=4)
    port = DurableSender(port_client, ReplaySpool(tmp_path / "port"), ring_envelopes=5, replay_batch=4)
    assert _drive(jax, jax_client) == _drive(port, port_client)
    assert jax.stats() == port.stats()
    assert jax_client.sent == port_client.sent
    stats = port.stats()
    # the ring (its last 5 sends) and the 3 failed batches were spooled;
    # the heartbeat was not
    assert stats["spooled_envelopes"] == 5 + 3 and stats["spool_frames"] == 0
    assert stats["replayed_envelopes"] == 8
    bodies = [msgpack_codec.decode(b) for kind, b in port_client.sent if kind == "body"]
    replayed = [p["meta"]["seq"] for body in bodies for p in body]
    assert replayed == [4, 5, 6, 7, 8, 9, 10, 11]  # ring seqs 4-8, then the failed 9-11
    assert [len(b) for b in bodies] == [4, 4]  # bounded replay batches


def test_durable_sender_counts_what_a_json_host_cannot_spool(tmp_path, monkeypatch):
    monkeypatch.setattr(msgpack_codec, "_HAVE_MSGPACK", False)
    monkeypatch.setattr(jax_codec, "_HAVE_MSGPACK", False)
    jax_client, port_client = FakeClient(jax_codec), FakeClient(msgpack_codec)
    jax = JaxDurableSender(jax_client, JaxSpool(tmp_path / "jax"))
    port = DurableSender(port_client, ReplaySpool(tmp_path / "port"))
    assert _drive(jax, jax_client) == _drive(port, port_client)
    assert jax.stats() == port.stats()
    assert port.stats()["spool_send_failures"] == 3 and port.stats()["spooled_envelopes"] == 0


PLANS = [
    [{"point": "aggregator.ingest", "action": "kill9", "after": 40}],
    [{"point": "client.send", "action": "reset", "after": 3, "times": 4, "every": 2, "rank": 1},
     {"point": "client.send", "action": "stall", "arg": 0.01, "after": 1, "times": 2}],
    [{"point": "rank.tick", "action": "kill9", "after": 8, "rank": 1},
     {"point": "client.send", "action": "corrupt", "every": 5, "times": 3},
     {"point": "client.send", "action": "truncate", "after": 7}],
    {"point": "shm.write", "action": "reset", "after": 2},
]
EVENTS = ["client.send", "rank.tick", "aggregator.ingest", "client.send", "shm.write"] * 50


@pytest.mark.parametrize("rank", [None, "0", "1"])
@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_fault_plans_fire_at_the_same_events(monkeypatch, plan, rank):
    import json

    if rank is None:
        monkeypatch.delenv("RANK", raising=False)
    else:
        monkeypatch.setenv("RANK", rank)
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append((pid == os.getpid(), sig)))
    fired = {}
    for name, module in (("jax", jax_chaos), ("port", chaos)):
        module._reset_for_tests(json.dumps(PLANS[plan]))
        try:
            assert module.active()
            fired[name] = [(i, point, getattr(module.fire(point), "action", None)) for i, point in enumerate(EVENTS)]
        finally:
            module._reset_for_tests(None)
    assert fired["jax"] == fired["port"]
    actions = [a for _, _, a in fired["port"] if a]
    assert actions  # every plan fires somewhere
    n_kill9 = actions.count("kill9")
    assert kills == [(True, signal.SIGKILL)] * (2 * n_kill9)
    assert not chaos.active() and chaos.fire("client.send") is None


@pytest.mark.parametrize("bad", ['[{"point": "client.sned", "action": "reset"}]',
                                 '[{"point": "client.send", "action": "explode"}]', '"reset"'])
def test_bad_plans_are_refused_alike(bad):
    for module in (jax_chaos, chaos):
        with pytest.raises(ValueError):
            module.parse_plan(bad)
