"""Optional per-rank on-disk telemetry backup.

Counterpart of ``traceml_tpu/database/database_writer.py``: append-only
files under ``<logs>/<session>/rank_N/data/<sampler>/``, kept with
``--disk-backup`` and read back by ``inspect``, also when the aggregator
was unreachable.  The writer appends v2 frames only, one per envelope:
``b"TMB2" + u32_be(len) + codec(envelope)`` in ``envelopes.msgpack``.
The body is the same encoded bytes the wire ships (the publisher encodes
each payload once); the magic reads as a ~1.4 GB length to a v1 reader,
beyond its 64 MiB frame bound, so an old reader stops cleanly instead of
misparsing.  The JAX writer's v1 path (``u32_be(len) + codec(row)`` per
row in ``<table>.msgpack``) runs only on a writer no publisher feeds,
which the runtime never builds, so the port writes no v1 file.

:func:`iter_backup_file` reads both formats, in any mix within one file,
so v1 files written by the JAX package stay readable, and stops at a
torn or corrupt frame.  Flushes are throttled to every ``flush_every``
calls; a failed write is logged and swallowed, and its frames stay
buffered for the next attempt.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterator, Optional, Tuple

from traceml_tpu_torch.utils import msgpack_codec
from traceml_tpu_torch.utils.error_log import get_error_log

_LEN = struct.Struct(">I")
V2_MAGIC = b"TMB2"  # 0x544D4232 ≈ 1.4 GB as a big-endian length
ENVELOPE_FILE = "envelopes.msgpack"
_MAX_FRAME = 64 * 1024 * 1024
# a burst between flushes must not hold unbounded encoded bytes in memory
_BUF_FLUSH_BYTES = 512 * 1024


class DatabaseWriter:
    def __init__(
        self,
        sampler_name: str,
        out_dir: Optional[Path],
        flush_every: int = 20,
    ) -> None:
        self._sampler = sampler_name
        self._dir = Path(out_dir) / sampler_name if out_dir else None
        self._flush_every = max(1, flush_every)
        self._calls = 0
        # encoded envelope frames buffered until the flush throttle (or
        # force, or the byte high-water mark) writes them in one append
        self._buf = bytearray()
        self._buf_envelopes = 0
        self.envelopes_written = 0

    @property
    def enabled(self) -> bool:
        return self._dir is not None

    def has_pending(self) -> bool:
        return bool(self._buf)

    def append_envelope(self, enc: msgpack_codec.EncodedPayload) -> None:
        """Buffer one encoded envelope as a v2 frame: a length prefix and
        the wire body, never a second encode."""
        if self._dir is None:
            return
        body = enc.body
        self._buf += V2_MAGIC
        self._buf += _LEN.pack(len(body))
        self._buf += body
        self._buf_envelopes += 1
        if len(self._buf) >= _BUF_FLUSH_BYTES:
            self._write_buffer()

    def _write_buffer(self) -> int:
        if not self._buf:
            return 0
        n = self._buf_envelopes
        try:
            self._dir.mkdir(parents=True, exist_ok=True)
            with open(self._dir / ENVELOPE_FILE, "ab") as fh:
                fh.write(self._buf)
        except Exception as exc:
            get_error_log().warning(f"disk backup flush failed for sampler={self._sampler}", exc)
            return 0
        # cleared only after a successful write: a failed one keeps the
        # frames for the next attempt
        del self._buf[:]
        self._buf_envelopes = 0
        self.envelopes_written += n
        return n

    def flush(self, force: bool = False) -> int:
        """Write the buffered envelope frames; returns how many.  Throttled
        to every ``flush_every`` calls unless ``force``."""
        if self._dir is None:
            return 0
        self._calls += 1
        if not force and self._calls % self._flush_every:
            return 0
        return self._write_buffer()


def iter_backup_tables(path: Path) -> Iterator[Tuple[Optional[str], dict]]:
    """Decode an append-only backup file → ``(table, row)``.

    v1 frames yield ``(None, row)`` (their table is the file's name); v2
    frames are unpacked into their tables and yield ``(table, row)`` per
    row, tables in the JAX envelope's order (row-list tables first).  A
    torn or corrupt frame (a crash mid-write) ends the iteration instead
    of raising: post-mortem reading must work on the runs that crashed.
    """
    from traceml_tpu_torch.telemetry.envelope import normalize_telemetry_envelope

    with open(path, "rb") as fh:
        while True:
            hdr = fh.read(_LEN.size)
            if len(hdr) < _LEN.size:
                return
            if hdr == V2_MAGIC:
                hdr = fh.read(_LEN.size)
                if len(hdr) < _LEN.size:
                    return
                (n,) = _LEN.unpack(hdr)
                if n > _MAX_FRAME:
                    return
                body = fh.read(n)
                if len(body) < n:
                    return
                try:
                    payload = msgpack_codec.decode(body)
                except msgpack_codec.CodecError:
                    return
                env = normalize_telemetry_envelope(payload)
                if env is None:
                    continue  # decodable but not an envelope: skip the frame
                tables = env.tables
                for table in env.table_names():
                    yield from ((table, row) for row in tables.get(table, []))
                continue
            (n,) = _LEN.unpack(hdr)
            if n > _MAX_FRAME:  # a corrupt length (or a v2 magic to a v1 reader)
                return
            body = fh.read(n)
            if len(body) < n:
                return
            try:
                yield None, msgpack_codec.decode(body)
            except msgpack_codec.CodecError:
                return


def iter_backup_file(path: Path):
    """Decode an append-only backup file → rows (what ``inspect`` reads);
    v2 frames are flattened into their rows."""
    for _table, row in iter_backup_tables(path):
        yield row
