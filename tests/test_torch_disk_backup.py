"""The port's disk backup (``database/database_writer.py``) against the
JAX package's.

* v1 (per row): the JAX ``DatabaseWriter`` writes the same rows in two
  tables (the port writes no v1 file: its runtime always feeds the
  writer envelopes); each package's ``iter_backup_file`` reads the file
  back as the same rows.
* v2 (per envelope): the same envelopes (a row-list table and a columnar
  one), encoded once by each package's codec, go through both writers'
  ``append_envelope``; the files are byte-identical and both readers give
  the same ``(table, row)`` stream.
* A v1 reader (length + body frames only) reads the v1 rows of a mixed
  file and stops cleanly at the first v2 frame, whose magic reads as a
  length past the 64 MiB frame bound; both readers refuse a frame over
  64 MiB, and stop at a torn tail, keeping the frames before it.
* A failed write is logged and swallowed, and its frames stay buffered.
* The port's publisher hands each tick's encoded bytes to the backup:
  with no client the file holds every row the samplers produced.

Exact comparison: rows are JSON-safe dicts compared with ``==``.
"""

import io
import struct


from traceml_tpu.database.database import Database as JaxDatabase
from traceml_tpu.database import database_writer as jax_dw
from traceml_tpu.utils import msgpack_codec as jax_codec
from traceml_tpu_torch.database import database_writer as dw
from traceml_tpu_torch.telemetry.envelope import rows_to_columns
from traceml_tpu_torch.utils import msgpack_codec

STEP_ROWS = [
    {"step": s, "timestamp": 1.7e9 + s * 0.25, "clock": "device",
     "events": {"_traceml_internal:step_time": {"cpu_ms": 10.0 + s, "device_ms": 9.5 + s, "count": 1}}}
    for s in range(1, 9)
]
STATS_ROWS = [{"timestamp": 1.7e9, "flops_per_step": 3.0e12, "flops_source": "manual", "tokens_per_step": None}]


def _fill(db):
    db.add_records("step_time", STEP_ROWS[:5])
    db.add_records("model_stats", STATS_ROWS)
    db.add_records("step_time", STEP_ROWS[5:])
    return db


def _payloads():
    meta = {"session_id": "s", "global_rank": 0, "sampler": "step_time", "seq": 7}
    return [
        {"meta": meta, "body": {"tables": {"step_time": STEP_ROWS[:4], "model_stats": rows_to_columns(STATS_ROWS)}}},
        {"meta": dict(meta, seq=8), "body": {"tables": {"step_time": rows_to_columns(STEP_ROWS[4:])}}},
    ]


def test_v1_files_read_back_equal(tmp_path):
    jax_w = jax_dw.DatabaseWriter("step_time", _fill(JaxDatabase()), tmp_path)
    assert jax_w.flush(force=True) == 9
    assert jax_w.flush(force=True) == 0  # nothing new
    for table in ("step_time", "model_stats"):
        f = tmp_path / "step_time" / f"{table}.msgpack"
        rows = list(jax_dw.iter_backup_file(f))
        assert rows == list(dw.iter_backup_file(f))
        assert list(dw.iter_backup_tables(f)) == list(jax_dw.iter_backup_tables(f)) == [(None, r) for r in rows]
        assert rows == (STEP_ROWS if table == "step_time" else STATS_ROWS)


def test_v2_files_are_byte_identical_and_read_back_equal(tmp_path):
    jax_w = jax_dw.DatabaseWriter("step_time", JaxDatabase(), tmp_path / "jax", flush_every=3)
    port_w = dw.DatabaseWriter("step_time", tmp_path / "port", flush_every=3)
    for p in _payloads():
        jax_w.append_envelope(jax_codec.preencode(p))
        port_w.append_envelope(msgpack_codec.preencode(p))
    assert jax_w.envelope_mode and port_w.has_pending()
    assert [jax_w.flush() for _ in range(3)] == [port_w.flush() for _ in range(3)] == [0, 0, 2]
    jax_f, port_f = (tmp_path / side / "step_time" / dw.ENVELOPE_FILE for side in ("jax", "port"))
    assert port_f.read_bytes() == jax_f.read_bytes()
    got = list(dw.iter_backup_tables(port_f))
    assert got == list(jax_dw.iter_backup_tables(jax_f)) == list(jax_dw.iter_backup_tables(port_f))
    assert got == [("step_time", r) for r in STEP_ROWS[:4]] + [("model_stats", STATS_ROWS[0])] + [
        ("step_time", r) for r in STEP_ROWS[4:]]
    assert list(dw.iter_backup_file(port_f)) == [r for _, r in got]


def _v1_reader(data: bytes):
    """A reader of v1 frames only: u32 length + body, stopping at a length
    past the frame bound."""
    fh, out = io.BytesIO(data), []
    while True:
        hdr = fh.read(4)
        if len(hdr) < 4:
            return out
        (n,) = struct.unpack(">I", hdr)
        if n > 64 * 1024 * 1024:
            return out
        out.append(msgpack_codec.decode(fh.read(n)))


def test_v1_reader_stops_at_a_v2_frame_and_oversize_frames_are_refused(tmp_path):
    f = tmp_path / "step_time.msgpack"
    v1 = b"".join(struct.pack(">I", len(b)) + b for b in map(msgpack_codec.encode, STEP_ROWS))
    # a v2 frame appended after the v1 rows, then one more v1 row
    body = msgpack_codec.preencode(_payloads()[0]).body
    tail_row = msgpack_codec.encode({"step": 99})
    f.write_bytes(v1 + dw.V2_MAGIC + struct.pack(">I", len(body)) + body + struct.pack(">I", len(tail_row)) + tail_row)
    assert struct.unpack(">I", dw.V2_MAGIC)[0] > dw._MAX_FRAME
    assert _v1_reader(f.read_bytes()) == STEP_ROWS  # stops cleanly at the v2 frame
    mixed = list(dw.iter_backup_tables(f))
    assert mixed == list(jax_dw.iter_backup_tables(f))
    assert mixed[:8] == [(None, r) for r in STEP_ROWS] and mixed[-1] == (None, {"step": 99})
    # a frame over 64 MiB (v1 or v2) ends both readers, keeping what came before
    for hdr in (struct.pack(">I", dw._MAX_FRAME + 1), dw.V2_MAGIC + struct.pack(">I", dw._MAX_FRAME + 1)):
        f.write_bytes(v1 + hdr + b"\x00" * 16)
        assert list(dw.iter_backup_file(f)) == list(jax_dw.iter_backup_file(f)) == STEP_ROWS
    # a torn tail (a crash mid-write)
    f.write_bytes(v1 + v1[:7])
    assert list(dw.iter_backup_file(f)) == list(jax_dw.iter_backup_file(f)) == STEP_ROWS


def test_failed_write_is_logged_and_swallowed(tmp_path, monkeypatch):
    from traceml_tpu_torch.utils.error_log import get_error_log

    warnings = []
    monkeypatch.setattr(get_error_log(), "warning", lambda msg, exc=None: warnings.append(msg))
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    w = dw.DatabaseWriter("step_time", blocker)
    w.append_envelope(msgpack_codec.preencode(_payloads()[0]))
    assert w.flush(force=True) == 0 and w.has_pending() and w.envelopes_written == 0
    assert any("disk backup flush failed" in m for m in warnings)
    blocker.unlink()  # the next attempt writes the frames kept
    assert w.flush(force=True) == 1 and not w.has_pending() and w.envelopes_written == 1
    off = dw.DatabaseWriter("step_time", None)  # no backup dir
    off.append_envelope(msgpack_codec.preencode(_payloads()[0]))
    assert not off.enabled and not off.has_pending() and off.flush(force=True) == 0


def test_publisher_without_client_writes_every_row(tmp_path):
    from traceml_tpu_torch.runtime.sender import TelemetryPublisher
    from traceml_tpu_torch.samplers.base_sampler import BaseSampler
    from traceml_tpu_torch.telemetry.envelope import SenderIdentity

    class Rows(BaseSampler):
        name = "step_time"

        def _sample(self):
            pass

    s = Rows(disk_backup_dir=tmp_path)
    pub = TelemetryPublisher([s], None, SenderIdentity(session_id="s", hostname="h", pid=1))
    assert s.writer.enabled
    for i in range(0, 8, 2):
        s.db.add_records("step_time", STEP_ROWS[i:i + 2])
        assert pub.publish() == 1
    assert s.writer.has_pending()  # the flush throttle holds the frames
    s.stop()  # the sampler's last-chance flush
    rows = [r for t, r in dw.iter_backup_tables(tmp_path / "step_time" / dw.ENVELOPE_FILE) if t == "step_time"]
    assert rows == STEP_ROWS
    assert "transport" not in pub.stats() and pub.stats()["samplers"]["step_time"]["envelopes"] == 4
