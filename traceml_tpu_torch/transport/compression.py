"""Per-envelope wire compression.

Counterpart of ``traceml_tpu/transport/compression.py``, with the same
carrier bytes: the publisher may wrap each already-encoded envelope body
in a small compressed carrier::

    {"_traceml_z": "zstd", "n": <orig len>, "z": <compressed raw body>,
     "meta": {"seq": ..., "global_rank": ..., "compression": "zstd"}}

* **Self-describing.**  The telemetry channel runs one way (ranks never
  read from the aggregator), so nothing is negotiated: each carrier
  names its codec and the receiver decompresses whatever arrives.  A
  ``transport_hello`` control message, once per connection, announces the sender's
  choice, for observability only.
* **The carrier is itself a msgpack map**, so the single-encode contract
  holds: its ``EncodedPayload.raw`` splices into batch frames like a
  plain envelope's, and the replay spool (``transport/spool.py``) stores
  and replays the compressed bytes with no second compression.
* **meta rides outside the compressed body**, with ``seq`` and
  ``global_rank``, so the spool's seq bookkeeping and rank attribution
  never decompress.
* **stdlib + ctypes only.**  zstd binds ``libzstd.so.1`` through ctypes
  (level 3, checked by a round trip at first use); zlib is the stdlib
  fallback.  Bodies under ``MIN_COMPRESS_BYTES``, and bodies that do not
  shrink, ship unwrapped; ``MAX_DECOMPRESSED_BYTES`` bounds a
  decompression bomb.

Decompression happens in the server's decode path
(``TCPServer.decode_tagged``), so everything after the drain sees
payloads equal to the uncompressed arm's.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
import zlib
from typing import Any, Dict, Optional

from traceml_tpu_torch.utils import msgpack_codec

#: marker key of a compressed carrier payload
COMPRESSED_KEY = "_traceml_z"

#: envelopes below this many encoded bytes ship raw — heartbeats and
#: control messages are header-dominated and would only grow
MIN_COMPRESS_BYTES = 256

#: hard sanity bound on the declared uncompressed size of an incoming
#: carrier (mirrors MAX_FRAME_BYTES on the framing layer)
MAX_DECOMPRESSED_BYTES = 256 * 1024 * 1024

_ZSTD_LEVEL = 3  # zstd default: ~zlib-9 ratio at many times the speed


class CompressionError(ValueError):
    """Raised when a carrier's body cannot be restored (corrupt bytes,
    size mismatch, or a codec this host cannot decode)."""


class _ZstdLib:
    """Minimal single-shot libzstd binding (compress/decompress only)."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        self._lib = lib
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]

    def compress(self, data: bytes, level: int = _ZSTD_LEVEL) -> bytes:
        bound = self._lib.ZSTD_compressBound(len(data))
        dst = ctypes.create_string_buffer(bound)
        n = self._lib.ZSTD_compress(dst, bound, data, len(data), level)
        if self._lib.ZSTD_isError(n):
            raise CompressionError("zstd compress failed")
        return dst.raw[:n]

    def decompress(self, data: bytes, orig_len: int) -> bytes:
        dst = ctypes.create_string_buffer(orig_len or 1)
        n = self._lib.ZSTD_decompress(dst, orig_len, data, len(data))
        if self._lib.ZSTD_isError(n) or n != orig_len:
            raise CompressionError("zstd decompress failed")
        return dst.raw[:n]


_zstd_lock = threading.Lock()
_zstd: Optional[_ZstdLib] = None
_zstd_attempted = False


def _get_zstd() -> Optional[_ZstdLib]:
    global _zstd, _zstd_attempted
    if _zstd is not None or _zstd_attempted:
        return _zstd
    with _zstd_lock:
        if _zstd_attempted:
            return _zstd
        _zstd_attempted = True
        for name in ("libzstd.so.1", "libzstd.1.dylib", "zstd"):
            try:
                if name == "zstd":
                    found = ctypes.util.find_library("zstd")
                    if not found:
                        continue
                    name = found
                _zstd = _ZstdLib(ctypes.CDLL(name))
                # round-trip probe: a lib that loads but misbehaves must
                # not silently corrupt telemetry
                probe = b"traceml" * 8
                if _zstd.decompress(_zstd.compress(probe), len(probe)) != probe:
                    _zstd = None
                    continue
                break
            except Exception:
                _zstd = None
        return _zstd


def available_codecs() -> tuple:
    """Codecs this host can encode AND decode, preferred first."""
    out = []
    if _get_zstd() is not None:
        out.append("zstd")
    out.append("zlib")  # stdlib: always present
    return tuple(out)


def resolve_codec(requested: Optional[str]) -> Optional[str]:
    """Map a ``TRACEML_TRANSPORT_COMPRESS`` value to a usable codec name
    (or None for off).  ``auto``/``1``/``on`` pick the best available;
    an explicit codec is honored only if this host supports it."""
    if requested is None:
        return None
    req = str(requested).strip().lower()
    if req in ("", "0", "false", "off", "none"):
        return None
    codecs = available_codecs()
    if req in ("auto", "1", "true", "yes", "on"):
        return codecs[0] if codecs else None
    return req if req in codecs else None


def compress_bytes(data: bytes, codec: str) -> bytes:
    if codec == "zstd":
        z = _get_zstd()
        if z is None:
            raise CompressionError("zstd unavailable on this host")
        return z.compress(data)
    if codec == "zlib":
        return zlib.compress(data, 6)
    raise CompressionError(f"unknown codec {codec!r}")


def decompress_bytes(data: bytes, codec: str, orig_len: int) -> bytes:
    if orig_len < 0 or orig_len > MAX_DECOMPRESSED_BYTES:
        raise CompressionError(f"declared size {orig_len} out of bounds")
    if codec == "zstd":
        z = _get_zstd()
        if z is None:
            raise CompressionError("zstd frame received but zstd unavailable")
        return z.decompress(data, orig_len)
    if codec == "zlib":
        try:
            out = zlib.decompress(data)
        except zlib.error as exc:
            raise CompressionError(f"zlib decompress failed: {exc}") from exc
        if len(out) != orig_len:
            raise CompressionError("zlib size mismatch")
        return out
    raise CompressionError(f"unknown codec {codec!r}")


def _carrier_meta(obj: Any, codec: str) -> Dict[str, Any]:
    """The carrier's outer meta: the keys consumed without decompress
    (spool seq bookkeeping, rank attribution) + the codec stamp."""
    meta: Dict[str, Any] = {"compression": codec}
    inner = obj.get("meta") if isinstance(obj, dict) else None
    if isinstance(inner, dict):
        for key in ("seq", "global_rank", "session_id", "sampler"):
            if key in inner:
                meta[key] = inner[key]
    return meta


class EnvelopeCompressor:
    """Publisher-side per-envelope compressor with self-stats.

    Single caller by contract (the publisher tick thread, which the
    runtime serializes) — no locks, like ReplaySpool.
    """

    def __init__(
        self, codec: str, min_bytes: int = MIN_COMPRESS_BYTES
    ) -> None:
        self.codec = codec
        self.min_bytes = int(min_bytes)
        self.envelopes_compressed = 0
        self.envelopes_passthrough = 0
        self.bytes_in = 0   # raw body bytes offered to the codec
        self.bytes_out = 0  # carrier body bytes actually shipped

    def wrap(
        self, enc: msgpack_codec.EncodedPayload
    ) -> msgpack_codec.EncodedPayload:
        """Wrap one pre-encoded envelope in a compressed carrier, or
        return it untouched (too small, raw-less, or no win)."""
        raw = enc.raw
        if raw is None or len(raw) < self.min_bytes:
            self.envelopes_passthrough += 1
            return enc
        try:
            z = compress_bytes(raw, self.codec)
        except CompressionError:
            self.envelopes_passthrough += 1
            return enc
        carrier = {
            COMPRESSED_KEY: self.codec,
            "n": len(raw),
            "z": z,
            "meta": _carrier_meta(enc.obj, self.codec),
        }
        wrapped = msgpack_codec.preencode(carrier)
        if wrapped.raw is None or wrapped.size() >= enc.size():
            # incompressible body (or a JSON-fallback host): raw wins
            self.envelopes_passthrough += 1
            return enc
        self.envelopes_compressed += 1
        self.bytes_in += len(raw)
        self.bytes_out += wrapped.size()
        return wrapped

    def stats(self) -> Dict[str, Any]:
        ratio = (
            self.bytes_in / self.bytes_out if self.bytes_out else 1.0
        )
        return {
            "codec": self.codec,
            "envelopes_compressed": self.envelopes_compressed,
            "envelopes_passthrough": self.envelopes_passthrough,
            "bytes_precompress": self.bytes_in,
            "bytes_wire": self.bytes_out,
            "ratio": round(ratio, 3),
        }


def is_compressed_payload(payload: Any) -> bool:
    return isinstance(payload, dict) and COMPRESSED_KEY in payload


def unwrap_payload(payload: Any) -> Any:
    """Restore the inner payload of a compressed carrier; payloads that
    aren't carriers pass through untouched.  Raises
    :class:`CompressionError` on corrupt or undecodable carriers."""
    if not is_compressed_payload(payload):
        return payload
    codec = str(payload.get(COMPRESSED_KEY))
    body = payload.get("z")
    n = payload.get("n")
    if not isinstance(body, (bytes, bytearray)) or not isinstance(n, int):
        raise CompressionError("malformed compressed carrier")
    raw = decompress_bytes(bytes(body), codec, n)
    try:
        return msgpack_codec.decode(msgpack_codec.MSGPACK_PREFIX + raw)
    except msgpack_codec.CodecError as exc:
        raise CompressionError(f"carrier body undecodable: {exc}") from exc
