"""The FDB wire protocol — length-prefixed binary frames.

Every message is one frame::

    u32 body_length | body
    body = u32 request_id | u8 opcode | payload

Request ids correlate pipelined requests with their responses on one
connection (the server answers in completion order, not arrival order).
Payloads are built from three primitives — ``u8``/``u32``/``u64`` integers,
length-prefixed byte strings and length-prefixed UTF-8 strings — and the
domain types ride on their existing canonical text forms:

- :class:`~repro.core.keys.Key`      -> ``Key.canonical()`` / ``from_canonical``
- :class:`~repro.core.request.Request` -> ``Request.format()`` / ``parse``
  (the round-trip property the request language guarantees)
- :class:`~repro.core.store.FieldLocation` -> ``encode()`` / ``decode``
- :class:`~repro.core.schema.Schema` -> the inline config spec as JSON
  (self-describing — the client needs no schema registry entry)

A frame longer than ``max_frame`` is a protocol error, not an allocation:
mis-framed or hostile input fails fast instead of exhausting memory.
Errors travel as ``ERR`` frames carrying the server-side exception type name
and message; the client raises :class:`RemoteError` (transport faults raise
the underlying ``OSError``/:class:`RemoteTimeout` instead, which is what the
retry layer keys on — an application error must never be retried blindly,
a transport fault may be).
"""

from __future__ import annotations

import struct
from typing import Iterator, Sequence

from ..keys import Key
from ..request import Request
from ..store import FieldLocation

__all__ = [
    "MAGIC",
    "PROTOCOL_VERSION",
    "DEFAULT_MAX_FRAME",
    "ProtocolError",
    "RemoteError",
    "RemoteTimeout",
    "Op",
    "Cursor",
    "encode_frame",
    "split_frame",
]

MAGIC = b"RFDB"
PROTOCOL_VERSION = 1

#: extension level negotiated as an OPTIONAL trailing u16 on HELLO (both
#: directions).  A v1 peer never reads past the base HELLO fields (neither
#: ``decode_hello`` nor the client's reply parsing calls ``expect_end``),
#: so the extra bytes are invisible to it and it simply never negotiates
#: extensions — old clients and servers interoperate unchanged.  Level >= 2
#: means: traced request frames (``TRACE_FLAG`` + 16-byte trace-context
#: prefix) and the ``Op.TRACE`` round are understood.
TRACE_EXT_VERSION = 2

#: opcode bit marking a request frame whose payload is prefixed with a
#: trace context (u64 trace id + u64 parent span id).  Request opcodes stay
#: below 0x40 and responses use the 0x80 bit, so the flag is unambiguous.
TRACE_FLAG = 0x40

#: refuse frames beyond this many body bytes (1 GiB) — far above any real
#: batch, far below "the peer sent garbage length bytes"
DEFAULT_MAX_FRAME = 1 << 30

_U8 = struct.Struct("!B")
_U16 = struct.Struct("!H")
_U32 = struct.Struct("!I")
_U64 = struct.Struct("!Q")
_HDR = struct.Struct("!IB")  # request_id, opcode


class ProtocolError(RuntimeError):
    """Mis-framed, truncated, or version-incompatible wire data."""


class RemoteError(RuntimeError):
    """A failure reported by the FDB server (the operation ran remotely and
    raised).  ``remote_type`` names the server-side exception class."""

    def __init__(self, remote_type: str, message: str):
        super().__init__(f"{remote_type}: {message}")
        self.remote_type = remote_type
        self.remote_message = message


class RemoteTimeout(RemoteError, TimeoutError):
    """A wire call exceeded its deadline (retryable transport fault)."""

    def __init__(self, message: str):
        RemoteError.__init__(self, "TimeoutError", message)


class Op:
    """Opcodes.  Requests are < 0x80; responses have the high bit set."""

    HELLO = 0x01
    ARCHIVE_BATCH = 0x02
    RETRIEVE_BATCH = 0x03
    RETRIEVE_MANY = 0x04
    LIST = 0x05
    WIPE = 0x06
    FLUSH = 0x07
    STATS = 0x08
    TRACE = 0x09
    OK = 0x80
    ERR = 0x81

    NAMES = {
        HELLO: "hello", ARCHIVE_BATCH: "archive_batch",
        RETRIEVE_BATCH: "retrieve_batch", RETRIEVE_MANY: "retrieve_many",
        LIST: "list", WIPE: "wipe", FLUSH: "flush", STATS: "stats",
        TRACE: "trace", OK: "ok", ERR: "err",
    }


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def pack_u16(v: int) -> bytes:
    return _U16.pack(v)


def pack_bytes(b: bytes) -> bytes:
    return _U32.pack(len(b)) + b


def pack_str(s: str) -> bytes:
    return pack_bytes(s.encode("utf-8"))


class Cursor:
    """A bounds-checked reader over one frame body; every short read is a
    :class:`ProtocolError` naming what was expected, never a silent slice."""

    __slots__ = ("_buf", "_pos")

    def __init__(self, buf: bytes):
        self._buf = buf
        self._pos = 0

    def _take(self, n: int, what: str) -> bytes:
        end = self._pos + n
        if end > len(self._buf):
            raise ProtocolError(
                f"truncated frame: needed {n} bytes for {what} at offset "
                f"{self._pos}, only {len(self._buf) - self._pos} left"
            )
        out = self._buf[self._pos:end]
        self._pos = end
        return out

    def u8(self, what: str = "u8") -> int:
        return _U8.unpack(self._take(1, what))[0]

    def u16(self, what: str = "u16") -> int:
        return _U16.unpack(self._take(2, what))[0]

    def u32(self, what: str = "u32") -> int:
        return _U32.unpack(self._take(4, what))[0]

    def u64(self, what: str = "u64") -> int:
        return _U64.unpack(self._take(8, what))[0]

    def bytes_(self, what: str = "bytes") -> bytes:
        return self._take(self.u32(f"{what} length"), what)

    def str_(self, what: str = "str") -> str:
        return self.bytes_(what).decode("utf-8")

    def expect_end(self) -> None:
        if self._pos != len(self._buf):
            raise ProtocolError(
                f"{len(self._buf) - self._pos} trailing bytes after frame payload"
            )


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def encode_frame(req_id: int, opcode: int, payload: bytes = b"") -> bytes:
    """One complete wire frame, length prefix included."""
    body = _HDR.pack(req_id, opcode) + payload
    return _U32.pack(len(body)) + body


def frame_length(header: bytes, *, max_frame: int = DEFAULT_MAX_FRAME) -> int:
    """Decode the 4-byte length prefix, enforcing the frame-size bound."""
    (n,) = _U32.unpack(header)
    if n < _HDR.size:
        raise ProtocolError(f"frame body of {n} bytes is shorter than the header")
    if n > max_frame:
        raise ProtocolError(
            f"frame of {n} bytes exceeds the {max_frame}-byte limit "
            "(mis-framed stream or oversized batch)"
        )
    return n


def split_frame(body: bytes) -> tuple[int, int, Cursor]:
    """(request_id, opcode, payload cursor) of one frame body."""
    if len(body) < _HDR.size:
        raise ProtocolError(f"frame body of {len(body)} bytes is too short")
    req_id, opcode = _HDR.unpack_from(body)
    return req_id, opcode, Cursor(body[_HDR.size:])


# ---------------------------------------------------------------------------
# op payloads — encode/decode pairs shared by both ends of the wire
# ---------------------------------------------------------------------------

def encode_hello(ext_version: int = TRACE_EXT_VERSION) -> bytes:
    """HELLO payload: base magic+version, plus the extension level as an
    OPTIONAL trailing u16 a v1 server never reads."""
    out = MAGIC + _U16.pack(PROTOCOL_VERSION)
    if ext_version > 1:
        out += _U16.pack(ext_version)
    return out


def decode_hello(cur: Cursor) -> int:
    magic = cur._take(len(MAGIC), "magic")
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r} (expected {MAGIC!r}) — not an FDB client")
    version = cur.u16("protocol version")
    if version != PROTOCOL_VERSION:
        raise ProtocolError(
            f"protocol version {version} unsupported (server speaks {PROTOCOL_VERSION})"
        )
    return version


def decode_hello_ext(cur: Cursor) -> int:
    """The trailing extension level after :func:`decode_hello` consumed the
    base fields — 1 (no extensions) when the peer sent none."""
    if len(cur._buf) - cur._pos >= 2:
        return cur.u16("extension version")
    return 1


def mask_op(opcode: int) -> tuple[int, bool]:
    """``(base opcode, traced?)`` — strips :data:`TRACE_FLAG` off requests."""
    if opcode & 0x80:
        return opcode, False
    return opcode & ~TRACE_FLAG, bool(opcode & TRACE_FLAG)


def encode_trace_ctx(trace_id: int, span_id: int) -> bytes:
    """The 16-byte trace-context prefix of a TRACE_FLAG'd request payload."""
    return _U64.pack(trace_id) + _U64.pack(span_id)


def decode_trace_ctx(cur: Cursor) -> tuple[int, int]:
    return cur.u64("trace id"), cur.u64("parent span id")


def encode_archive_batch(items: Sequence[tuple[Key, bytes]]) -> bytes:
    parts = [_U32.pack(len(items))]
    for key, data in items:
        parts.append(pack_str(key.canonical()))
        parts.append(pack_bytes(data))
    return b"".join(parts)


def decode_archive_batch(cur: Cursor) -> list[tuple[Key, bytes]]:
    n = cur.u32("batch size")
    return [
        (Key.from_canonical(cur.str_("key")), cur.bytes_("field payload"))
        for _ in range(n)
    ]


def encode_keys(keys: Sequence[Key]) -> bytes:
    return _U32.pack(len(keys)) + b"".join(pack_str(k.canonical()) for k in keys)


def decode_keys(cur: Cursor) -> list[Key]:
    return [Key.from_canonical(cur.str_("key")) for _ in range(cur.u32("key count"))]


def encode_request(request: Request) -> bytes:
    return pack_str(request.format())


def decode_request(cur: Cursor) -> Request:
    return Request.parse(cur.str_("request"))


def encode_handles(payloads: Sequence[bytes | None]) -> bytes:
    parts = [_U32.pack(len(payloads))]
    for p in payloads:
        if p is None:
            parts.append(_U8.pack(0))
        else:
            parts.append(_U8.pack(1))
            parts.append(pack_bytes(p))
    return b"".join(parts)


def decode_handles(cur: Cursor) -> list[bytes | None]:
    out: list[bytes | None] = []
    for _ in range(cur.u32("handle count")):
        out.append(cur.bytes_("field payload") if cur.u8("present flag") else None)
    return out


def encode_fieldset(items: Sequence[tuple[Key, bytes | None]]) -> bytes:
    parts = [_U32.pack(len(items))]
    for key, p in items:
        parts.append(pack_str(key.canonical()))
        if p is None:
            parts.append(_U8.pack(0))
        else:
            parts.append(_U8.pack(1))
            parts.append(pack_bytes(p))
    return b"".join(parts)


def decode_fieldset(cur: Cursor) -> list[tuple[Key, bytes | None]]:
    out: list[tuple[Key, bytes | None]] = []
    for _ in range(cur.u32("fieldset size")):
        key = Key.from_canonical(cur.str_("key"))
        out.append((key, cur.bytes_("field payload") if cur.u8("present flag") else None))
    return out


def encode_listing(entries) -> bytes:
    entries = list(entries)
    parts = [_U32.pack(len(entries))]
    for e in entries:
        parts.append(pack_str(e.key.canonical()))
        parts.append(pack_bytes(e.location.encode()))
    return b"".join(parts)


def decode_listing(cur: Cursor) -> Iterator[tuple[Key, FieldLocation]]:
    for _ in range(cur.u32("listing size")):
        yield (
            Key.from_canonical(cur.str_("key")),
            FieldLocation.decode(cur.bytes_("location")),
        )


def encode_wipe_report(report) -> bytes:
    parts = [
        _U64.pack(report.entries_removed),
        _U64.pack(report.bytes_freed),
        _U32.pack(len(report.datasets)),
    ]
    parts.extend(pack_str(d) for d in report.datasets)
    return b"".join(parts)


def decode_wipe_report(cur: Cursor):
    from ..client import WipeReport

    entries = cur.u64("entries_removed")
    nbytes = cur.u64("bytes_freed")
    datasets = tuple(cur.str_("dataset") for _ in range(cur.u32("dataset count")))
    return WipeReport(entries_removed=entries, bytes_freed=nbytes, datasets=datasets)


def encode_error(exc: BaseException) -> bytes:
    return pack_str(type(exc).__name__) + pack_str(str(exc))


def decode_error(cur: Cursor) -> RemoteError:
    return RemoteError(cur.str_("error type"), cur.str_("error message"))
