"""Wire codec.

Counterpart of ``traceml_tpu/utils/msgpack_codec.py``: msgpack when it
imports, JSON otherwise.  Every body carries a one-byte prefix so a
receiver decodes either format whatever its own codec is:

    b"\\x01" + msgpack bytes      — msgpack payload
    b"\\x02" + utf-8 JSON bytes   — JSON payload

The prefix is part of the frame body (inside the length prefix the
transport adds).  JSON turns int dict keys into strings and tuples into
lists; telemetry rows use string keys and lists only.

The publisher encodes each payload once (:func:`preencode`) and
:func:`encode_batch` splices the encoded bodies into one batch body,
byte-identical to :func:`encode` of the list, for msgpack and for JSON
alike — so the encode cost the publisher reports is the real one on a
host without msgpack too.
"""

from __future__ import annotations

import json
from typing import Any, List

_MSGPACK_PREFIX = b"\x01"
_JSON_PREFIX = b"\x02"

try:
    import msgpack as _msgpack

    _HAVE_MSGPACK = True
except ImportError:
    _msgpack = None
    _HAVE_MSGPACK = False


class CodecError(ValueError):
    pass


def _json_default(obj: Any) -> Any:
    # numpy scalars & arrays show up in telemetry rows; coerce.
    try:
        import numpy as np

        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, np.generic):
            return obj.item()
    except ImportError:
        pass
    if isinstance(obj, (bytes, bytearray)):
        return obj.decode("utf-8", "replace")
    return str(obj)


def encode(obj: Any) -> bytes:
    """Encode a JSON-safe object to wire bytes (prefix + body)."""
    if _HAVE_MSGPACK:
        try:
            return _MSGPACK_PREFIX + _msgpack.packb(
                obj, use_bin_type=True, default=_json_default
            )
        except Exception:
            pass  # an object msgpack refuses: fall through to JSON
    try:
        return _JSON_PREFIX + json.dumps(obj, default=_json_default).encode("utf-8")
    except Exception as exc:
        raise CodecError(f"cannot encode payload: {exc}") from exc


class EncodedPayload:
    """A payload encoded exactly once: ``obj`` and its wire ``body``."""

    __slots__ = ("obj", "body")

    def __init__(self, obj: Any) -> None:
        self.obj = obj
        self.body = encode(obj)

    def size(self) -> int:
        return len(self.body)


def preencode(obj: Any) -> EncodedPayload:
    return EncodedPayload(obj)


def _array_header(n: int) -> bytes:
    """msgpack array header for ``n`` elements (fixarray/array16/32)."""
    if n <= 0x0F:
        return bytes((0x90 | n,))
    if n <= 0xFFFF:
        return b"\xdc" + n.to_bytes(2, "big")
    return b"\xdd" + n.to_bytes(4, "big")


def encode_batch(payloads: List[Any]) -> bytes:
    """One wire body for a list of payloads, splicing pre-encoded
    members; byte-identical to ``encode([...the objects...])``.  A batch
    whose members were encoded by different codecs (msgpack refused one
    object) is encoded again as a whole."""
    bodies = [
        p.body if isinstance(p, EncodedPayload) else encode(p) for p in payloads
    ]
    prefixes = {b[:1] for b in bodies}
    if prefixes == {_MSGPACK_PREFIX}:
        return _MSGPACK_PREFIX + _array_header(len(bodies)) + b"".join(b[1:] for b in bodies)
    if prefixes == {_JSON_PREFIX}:
        return _JSON_PREFIX + b"[" + b", ".join(b[1:] for b in bodies) + b"]"
    return encode([p.obj if isinstance(p, EncodedPayload) else p for p in payloads])


def decode(data: bytes) -> Any:
    """Decode wire bytes produced by :func:`encode`."""
    if not data:
        raise CodecError("empty frame")
    prefix, body = data[:1], data[1:]
    if prefix == _MSGPACK_PREFIX:
        if not _HAVE_MSGPACK:
            raise CodecError("msgpack frame received but msgpack unavailable")
        try:
            return _msgpack.unpackb(body, raw=False, strict_map_key=False)
        except Exception as exc:
            raise CodecError(f"bad msgpack frame: {exc}") from exc
    if prefix == _JSON_PREFIX:
        try:
            return json.loads(body.decode("utf-8"))
        except ValueError as exc:
            raise CodecError(f"bad json frame: {exc}") from exc
    raise CodecError(f"unknown codec prefix {prefix!r}")


def codec_name() -> str:
    return "msgpack" if _HAVE_MSGPACK else "json"
