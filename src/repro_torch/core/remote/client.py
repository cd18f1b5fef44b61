"""RemoteFDB — the full FDBClient surface over the wire protocol.

One :class:`RemoteFDB` is a drop-in :class:`~repro.core.client.FDBClient`
whose backend lives in another process (or on another node): every batch op
travels as one frame, so the backend's amortised paths — one vectored write,
one eq_poll burst — survive the network hop instead of degrading into
per-field rounds.

Transport behaviour, all bounded and configurable:

- a connection POOL of ``pool_size`` sockets: checkout blocks when all are
  in flight, so a chatty multi-threaded caller is limited client-side
  before it ever floods the server;
- per-call ``timeout`` on every socket read/write — a wedged server surfaces
  as :class:`~repro.core.remote.protocol.RemoteTimeout`, never a hang;
- bounded retry-with-backoff on TRANSPORT faults only (``OSError``,
  timeouts, torn frames): the connection is discarded, the op re-sent on a
  fresh socket up to ``retries`` times with exponential backoff.  Safe for
  archives because FDB re-archive has replacement semantics.  Application
  errors the server reports (:class:`RemoteError`) are never retried — the
  op ran and failed, a resend would just fail again.

The handshake carries the server's schema (name-resolved when registered,
inline spec otherwise), so the client validates keys and expands requests
locally — bad keys fail before paying a network round, exactly like every
in-process facade.

Wire telemetry (bytes out/in, round-trip seconds, per-connection shards,
reconnects/retries) accumulates in an :class:`~repro.metrics.iostats.IOStats`
surfaced through ``io_stats()`` like every other sink.
"""

from __future__ import annotations

import json
import queue
import socket
import threading
import time
from typing import Iterator, Mapping, Sequence

from ...metrics.iostats import IOStats
from ..catalogue import ListEntry
from ..client import FDBClient, WipeReport
from ..datahandle import DataHandle, MemoryDataHandle
from ..fieldset import FieldSet
from ..keys import Key
from ..request import Request
from . import protocol as P
from .protocol import Cursor, Op, ProtocolError, RemoteError, RemoteTimeout

__all__ = ["RemoteFDB"]

#: transport faults eligible for retry (application errors never are)
_TRANSPORT_FAULTS = (OSError, ProtocolError, EOFError)


def _parse_addr(addr) -> tuple[str, int]:
    if isinstance(addr, (tuple, list)) and len(addr) == 2:
        return str(addr[0]), int(addr[1])
    if isinstance(addr, str):
        host, sep, port = addr.rpartition(":")
        if sep and port.isdigit():
            return host, int(port)
    raise ValueError(f"remote addr must be 'host:port' or (host, port), got {addr!r}")


class _Conn:
    """One pooled socket: dial, handshake, then serial call/response.
    (Pipelining happens across POOL members, not within one socket — each
    call owns its connection until the response lands, which keeps the
    retry story trivially safe.)"""

    __slots__ = ("sock", "conn_id", "schema_spec", "ext_version", "_max_frame")

    def __init__(self, addr: tuple[str, int], timeout: float | None,
                 conn_id: int, max_frame: int):
        self.conn_id = conn_id
        self._max_frame = max_frame
        self.sock = socket.create_connection(addr, timeout=timeout)
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.sock.settimeout(timeout)
            op, cur, _ = self.call(0, Op.HELLO, P.encode_hello())
            if op != Op.OK:
                raise P.decode_error(cur)
            self.schema_spec = json.loads(cur.str_("schema spec"))
            # a v2 server echoes its extension level after the schema spec;
            # a v1 server sends nothing there and negotiates level 1 — the
            # client then never sends TRACE_FLAG'd frames on this socket
            self.ext_version = P.decode_hello_ext(cur)
        except BaseException:
            self.sock.close()
            raise

    def call(self, req_id: int, opcode: int, payload: bytes) -> tuple[int, Cursor, int]:
        """Send one frame, block for its response.  Returns
        ``(response opcode, payload cursor, response bytes)``."""
        self.sock.sendall(P.encode_frame(req_id, opcode, payload))
        body = self._recv_frame()
        resp_id, resp_op, cur = P.split_frame(body)
        if resp_id != req_id:
            raise ProtocolError(
                f"response id {resp_id} does not match request id {req_id}"
            )
        return resp_op, cur, len(body)

    def _recv_exact(self, n: int, what: str) -> bytes:
        chunks = []
        while n > 0:
            chunk = self.sock.recv(min(n, 1 << 20))
            if not chunk:
                raise ProtocolError(f"server closed the connection mid {what}")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def _recv_frame(self) -> bytes:
        hdr = self._recv_exact(4, "frame header")
        return self._recv_exact(
            P.frame_length(hdr, max_frame=self._max_frame), "frame"
        )

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class RemoteFDB(FDBClient):
    """An FDB whose backend is reached over the wire (see module docstring).

    ``addr`` is ``"host:port"`` or ``(host, port)``.  Alternatively pass
    ``server=`` (a started :class:`~repro.core.remote.server.FDBServer`)
    that this client should OWN — closed with the client; the declarative
    ``{"type": "remote", "inner": {...}}`` path uses that for self-hosted
    loopback trees.
    """

    def __init__(
        self,
        addr=None,
        *,
        server=None,
        pool_size: int = 2,
        timeout: float | None = 30.0,
        retries: int = 2,
        backoff: float = 0.05,
        max_frame: int = P.DEFAULT_MAX_FRAME,
    ):
        if server is not None:
            if addr is None:
                addr = server.addr
            self._server = server
        else:
            self._server = None
        if addr is None:
            raise ValueError("RemoteFDB needs an addr or a started server")
        self._addr = _parse_addr(addr)
        if pool_size < 1:
            raise ValueError("pool_size must be >= 1")
        if retries < 0:
            raise ValueError("retries must be >= 0")
        self._timeout = timeout
        self._retries = retries
        self._backoff = backoff
        self._max_frame = max_frame
        self.wire_stats = IOStats("remote-client")
        self._conn_seq = 0
        self._req_seq = 0
        self._mu = threading.Lock()
        self._closed = False
        # pool tokens: a live _Conn, or None meaning "dial on demand" —
        # checkout blocks when every token is in flight
        self._pool: queue.LifoQueue = queue.LifoQueue(maxsize=pool_size)
        first = self._dial()  # eager: surfaces a bad addr here, not on first op
        self.schema = self._resolve_schema(first.schema_spec)
        self._pool.put(first)
        for _ in range(pool_size - 1):
            self._pool.put(None)

    # -------------------------------------------------------------- transport
    @staticmethod
    def _resolve_schema(spec):
        from ..config import schema_from_config

        return schema_from_config(spec)

    def _next_req_id(self) -> int:
        with self._mu:
            self._req_seq = (self._req_seq + 1) % (1 << 32)
            return self._req_seq

    def _dial(self) -> _Conn:
        """Connect + handshake, with bounded retry-with-backoff on refusal
        (a restarting server is the transient this covers)."""
        attempt = 0
        while True:
            with self._mu:
                self._conn_seq += 1
                cid = self._conn_seq
            try:
                conn = _Conn(self._addr, self._timeout, cid, self._max_frame)
                self.wire_stats.record("remote_connect", shard=f"conn{cid}")
                return conn
            except _TRANSPORT_FAULTS as e:
                attempt += 1
                if attempt > self._retries:
                    if isinstance(e, (socket.timeout, TimeoutError)):
                        raise RemoteTimeout(
                            f"connect to {self._addr[0]}:{self._addr[1]} timed "
                            f"out after {attempt} attempts"
                        ) from e
                    raise
                self.wire_stats.record("remote_retry")
                time.sleep(self._backoff * (2 ** (attempt - 1)))

    def _call(self, opcode: int, payload: bytes, op_name: str) -> Cursor:
        """One request/response round with pooling, timeout mapping and
        bounded retry on transport faults.

        The whole round runs under a wire span.  When tracing is on AND the
        connection negotiated the trace extension, the frame goes out
        TRACE_FLAG'd with this span's context prefixed, so the server's op
        span becomes a child of the wire span — the send/receive time and
        the server-side time stitch into one trace."""
        if self._closed:
            raise RuntimeError("RemoteFDB is closed")
        tr = self._trace
        with tr.span("wire.call") as sp:
            if tr.enabled:
                sp.name = "wire." + op_name
            attempt = 0
            while True:
                conn = self._pool.get()
                if conn is None:
                    try:
                        conn = self._dial()
                    except BaseException:
                        self._pool.put(None)  # give the token back
                        raise
                wire_op, wire_payload = opcode, payload
                if tr.enabled and conn.ext_version >= P.TRACE_EXT_VERSION:
                    ctx = sp.context
                    wire_op = opcode | P.TRACE_FLAG
                    wire_payload = (
                        P.encode_trace_ctx(ctx.trace_id, ctx.span_id) + payload
                    )
                req_id = self._next_req_id()
                t0 = time.perf_counter()
                try:
                    resp_op, cur, nread = conn.call(req_id, wire_op, wire_payload)
                except _TRANSPORT_FAULTS as e:
                    conn.close()
                    self._pool.put(None)
                    attempt += 1
                    if attempt > self._retries:
                        if isinstance(e, (socket.timeout, TimeoutError)):
                            raise RemoteTimeout(
                                f"{op_name} timed out after {attempt} attempts "
                                f"(timeout={self._timeout}s)"
                            ) from e
                        raise
                    self.wire_stats.record("remote_retry")
                    time.sleep(self._backoff * (2 ** (attempt - 1)))
                    continue
                self._pool.put(conn)
                self.wire_stats.record(
                    op_name,
                    seconds=time.perf_counter() - t0,
                    nbytes_w=len(payload),
                    nbytes_r=nread,
                    shard=f"conn{conn.conn_id}",
                )
                if tr.enabled:
                    sp.set("bytes_out", len(wire_payload))
                    sp.set("bytes_in", nread)
                    sp.set("attempts", attempt + 1)
                    sp.set("conn", conn.conn_id)
                if resp_op == Op.ERR:
                    raise P.decode_error(cur)
                if resp_op != Op.OK:
                    raise ProtocolError(
                        f"unexpected response opcode {resp_op:#x} to {op_name}"
                    )
                return cur

    # ----------------------------------------------------------- required hooks
    def archive(self, key: Key | Mapping[str, str], data: bytes) -> None:
        self.archive_batch([(key, data)])

    def archive_batch(
        self, items: Sequence[tuple[Key | Mapping[str, str], bytes]]
    ) -> None:
        if not items:
            return
        wire_items = []
        for key, data in items:
            k = self._as_key(key)
            self.schema.validate(k)  # fail fast, before paying the round
            wire_items.append((k, bytes(data)))
        cur = self._call(
            Op.ARCHIVE_BATCH, P.encode_archive_batch(wire_items), "archive_batch"
        )
        cur.expect_end()

    def retrieve_batch(
        self, keys: Sequence[Key | Mapping[str, str]]
    ) -> list[DataHandle | None]:
        ks = [self._as_key(k) for k in keys]
        for k in ks:
            self.schema.validate(k)
        if not ks:
            return []
        cur = self._call(Op.RETRIEVE_BATCH, P.encode_keys(ks), "retrieve_batch")
        payloads = P.decode_handles(cur)
        if len(payloads) != len(ks):
            raise ProtocolError(
                f"server returned {len(payloads)} handles for {len(ks)} keys"
            )
        return [None if p is None else MemoryDataHandle(p) for p in payloads]

    def flush(self) -> None:
        self._call(Op.FLUSH, b"", "flush").expect_end()

    def _list(self, request: Request) -> Iterator[ListEntry]:
        cur = self._call(Op.LIST, P.encode_request(request), "list")
        return iter([ListEntry(k, loc) for k, loc in P.decode_listing(cur)])

    def retrieve_many(self, request) -> FieldSet:
        """One wire round for the WHOLE request: the server resolves and
        reads every matched field and ships payloads back in a single
        fieldset frame (the catalogue listing never crosses the wire just to
        come back as per-key fetches)."""
        req = self._validated_request(request)
        cur = self._call(Op.RETRIEVE_MANY, P.encode_request(req), "retrieve_many")
        items = P.decode_fieldset(cur)
        keys = [k for k, _ in items]
        table: dict[Key, bytes | None] = {}
        for k, p in items:
            table.setdefault(k, p)

        def fetch(ks: list[Key]) -> list[DataHandle | None]:
            out: list[DataHandle | None] = []
            for k in ks:
                p = table.get(k)
                out.append(None if p is None else MemoryDataHandle(p))
            return out

        return FieldSet(keys, fetch, batch_size=None)

    def wipe(self, request) -> WipeReport:
        # validate locally (dataset keywords present, no narrowing spans) so
        # the error surface matches in-process facades, then let the server
        # run the whole wipe in one round
        req = self._validated_request(request)
        self._wipe_validate(req)
        cur = self._call(Op.WIPE, P.encode_request(req), "wipe")
        return P.decode_wipe_report(cur)

    def _wipe_dataset(self, dataset_key: Key, entries=None) -> WipeReport:
        # fan-out callers (SelectFDB) wipe dataset by dataset; each is one
        # wire round carrying the dataset key as a request
        cur = self._call(
            Op.WIPE, P.encode_request(Request(dict(dataset_key))), "wipe"
        )
        return P.decode_wipe_report(cur)

    def io_stats(self) -> list:
        return [self.wire_stats] + self._codec_sinks()

    # --------------------------------------------------------------- telemetry
    def server_stats(self) -> dict:
        """The SERVER's merged telemetry (its FDB tree + its wire sink) —
        one STATS round."""
        cur = self._call(Op.STATS, b"", "stats")
        return json.loads(cur.str_("stats json"))

    def fetch_server_trace(self) -> int:
        """One TRACE round: pull the server-side spans accumulated for this
        client's traced ops and adopt them into the local tracer (they carry
        the client's trace ids, so the trace views stitch).  Returns the
        number of spans imported.  Requires the trace extension on the wire
        (a v1 server raises a RemoteError for the unknown opcode)."""
        cur = self._call(Op.TRACE, b"", "trace")
        spans = json.loads(cur.str_("trace json"))
        return self._trace.adopt(spans)

    # --------------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._closed:
            return
        err: BaseException | None = None
        try:
            self.flush()
        except (RemoteError, *_TRANSPORT_FAULTS) as e:
            err = e
        if self._trace.enabled:
            # last chance to stitch: pull the server-side spans for every
            # traced op this client issued (best effort — the server may be
            # gone or predate the trace extension)
            try:
                self.fetch_server_trace()
            except (RemoteError, *_TRANSPORT_FAULTS):
                pass
        self._closed = True
        while True:
            try:
                conn = self._pool.get_nowait()
            except queue.Empty:
                break
            if conn is not None:
                conn.close()
        if self._server is not None:
            self._server.stop()
        if err is not None:
            raise err
