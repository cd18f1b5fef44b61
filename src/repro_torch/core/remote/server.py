"""The asyncio FDB server — any ``build_fdb`` tree behind a TCP endpoint.

This is the paper's deployment shape: the catalogue/store services run on
storage nodes, clients on compute nodes talk to them over a network (§1.2).
The server fronts ANY :class:`~repro.core.client.FDBClient` — a bare
backend, a tiered SelectFDB, a router — so the whole composition grammar is
servable with one line::

    server = FDBServer({"backend": "posix", "root": "/data/fdb"})
    host, port = server.start()

or from a shell (blocks until interrupted)::

    python -m repro.core.remote.server --config fdb.json --port 7511

Concurrency model:

- one reader coroutine per connection feeds a BOUNDED frame queue; when a
  client pipelines more than ``max_inflight`` requests the reader stops
  reading and TCP flow control pushes back — per-connection backpressure,
  not unbounded buffering;
- one worker coroutine per connection executes ops serially (a client's
  ``archive`` -> ``flush`` ordering survives the wire) and hands the
  blocking FDB calls to a thread pool, so connections run concurrently and
  contention lands on the backend's own locks, exactly where the paper
  puts it;
- wire-level request batching: consecutive queued ``ARCHIVE_BATCH`` frames
  are coalesced into ONE backend ``archive_batch`` call (each frame still
  gets its own response), so a bursty client amortises backend rounds the
  same way :class:`~repro.core.async_fdb.AsyncFDB` writers do locally.

Per-connection wire telemetry (bytes in/out, handling time, coalesced frame
counts, per-connection op shards) accumulates in ``wire_stats`` — an
:class:`~repro.metrics.iostats.IOStats` like every other sink in the repo.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping

from ...metrics.iostats import IOStats
from ...obs.tracer import NULL_TRACER, SpanContext, Tracer, install_tracer
from . import protocol as P
from .protocol import Cursor, Op, ProtocolError

__all__ = ["FDBServer", "serve_fdb"]

#: sentinel the reader enqueues on clean EOF so the worker drains and exits
_EOF = object()

#: span names per served op (precomputed — no per-op string building)
_SERVER_SPANS = {
    Op.RETRIEVE_BATCH: "server.retrieve_batch",
    Op.RETRIEVE_MANY: "server.retrieve_many",
    Op.LIST: "server.list",
    Op.WIPE: "server.wipe",
    Op.FLUSH: "server.flush",
    Op.STATS: "server.stats",
}


class FDBServer:
    """Serve one FDB tree on a TCP address from a background thread.

    ``fdb`` is a live :class:`~repro.core.client.FDBClient` (caller-owned) or
    a config mapping (:func:`~repro.core.config.build_fdb` grammar — the
    server builds AND owns the tree, closing it on :meth:`stop`).
    ``port=0`` binds an ephemeral port; :meth:`start` returns the bound
    ``(host, port)``.
    """

    def __init__(
        self,
        fdb,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_inflight: int = 32,
        coalesce: int = 16,
        max_frame: int = P.DEFAULT_MAX_FRAME,
        owns_fdb: bool | None = None,
    ):
        if isinstance(fdb, Mapping):
            from ..config import build_fdb

            fdb = build_fdb(fdb)
            owns_fdb = True if owns_fdb is None else owns_fdb
        self.fdb = fdb
        self._owns_fdb = bool(owns_fdb)
        self._host = host
        self._port = port
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self._max_inflight = max_inflight
        self._coalesce = max(1, coalesce)
        self._max_frame = max_frame
        self.addr: tuple[str, int] | None = None
        self.wire_stats = IOStats("remote-server")
        #: server-side tracer: the null tracer until the first TRACED frame
        #: (or TRACE round) arrives — an untraced client pays nothing, a
        #: traced one gets server-side spans stitched to its trace ids and
        #: returned over the Op.TRACE round
        self.tracer = NULL_TRACER
        self._tracer_mu = threading.Lock()
        self._conn_ids = itertools.count()
        self._conn_tasks: set[asyncio.Task] = set()
        self._executor = ThreadPoolExecutor(
            max_workers=max(4, max_inflight), thread_name_prefix="fdb-serve"
        )
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop_ev: asyncio.Event | None = None
        self._started = threading.Event()
        self._start_exc: BaseException | None = None
        self._stopped = False

    # ------------------------------------------------------------- lifecycle
    def start(self) -> tuple[str, int]:
        """Run the server on a background thread; returns the bound addr."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(
            target=self._run, name="fdb-server", daemon=True
        )
        self._thread.start()
        self._started.wait(30)
        if self._start_exc is not None:
            raise self._start_exc
        if self.addr is None:
            raise RuntimeError("server failed to start within 30s")
        return self.addr

    def stop(self) -> None:
        """Stop serving: close the listener and every open connection, then
        close the FDB tree if this server owns it.  Idempotent."""
        if self._stopped:
            return
        self._stopped = True
        if self._loop is not None and self._stop_ev is not None:
            self._loop.call_soon_threadsafe(self._stop_ev.set)
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._executor.shutdown(wait=False, cancel_futures=True)
        if self._owns_fdb:
            self.fdb.close()

    def __enter__(self) -> "FDBServer":
        if self._thread is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ----------------------------------------------------------- event loop
    def _run(self) -> None:
        try:
            asyncio.run(self._main())
        except BaseException as e:  # noqa: BLE001 — surfaced by start()
            if not self._started.is_set():
                self._start_exc = e
                self._started.set()

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop_ev = asyncio.Event()
        server = await asyncio.start_server(self._on_connect, self._host, self._port)
        sock = server.sockets[0].getsockname()
        self.addr = (sock[0], sock[1])
        self._started.set()
        try:
            await self._stop_ev.wait()
        finally:
            server.close()
            await server.wait_closed()
            for t in list(self._conn_tasks):
                t.cancel()
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)

    # ----------------------------------------------------------- connections
    async def _on_connect(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        assert task is not None
        self._conn_tasks.add(task)
        conn = f"conn{next(self._conn_ids)}"
        wlock = asyncio.Lock()
        try:
            await self._handshake(reader, writer, wlock, conn)
            # bounded frame queue: the reader below stops pulling off the
            # socket once max_inflight frames are pending, so TCP flow
            # control is the backpressure all the way to the client
            q: asyncio.Queue = asyncio.Queue(maxsize=self._max_inflight)
            worker = asyncio.create_task(self._conn_worker(q, writer, wlock, conn))
            try:
                while True:
                    body = await self._read_frame(reader)
                    if body is None:
                        break
                    await q.put(body)
            finally:
                await q.put(_EOF)
                await worker
        except (ProtocolError, ConnectionError, OSError) as e:
            self.wire_stats.record("wire_conn_error", shard=conn)
            try:
                async with wlock:
                    writer.write(P.encode_frame(0, Op.ERR, P.encode_error(e)))
                    await writer.drain()
            except (ConnectionError, OSError):
                pass
        finally:
            self._conn_tasks.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    def _ensure_tracer(self) -> None:
        """Switch the server-side tracer on (idempotent).  Installs it down
        the whole served tree so backend/tier/codec spans nest under the
        server op spans automatically."""
        if self.tracer.enabled:
            return
        with self._tracer_mu:
            if self.tracer.enabled:
                return
            tracer = Tracer(proc="server")
            install_tracer(self.fdb, tracer)
            self.tracer = tracer

    async def _handshake(self, reader, writer, wlock, conn: str) -> None:
        body = await self._read_frame(reader)
        if body is None:
            raise ConnectionError("peer closed before handshake")
        req_id, opcode, cur = P.split_frame(body)
        if opcode != Op.HELLO:
            raise ProtocolError(
                f"expected HELLO, got opcode {Op.NAMES.get(opcode, opcode)!r}"
            )
        P.decode_hello(cur)
        ext = P.decode_hello_ext(cur)
        from ..config import schema_to_config

        spec = json.dumps(schema_to_config(self.fdb.schema))
        payload = P.pack_str(spec)
        if ext >= P.TRACE_EXT_VERSION:
            # echo the extension level as an optional trailing u16 a v1
            # client never reads — only a peer that advertised it gets it
            payload += P.pack_u16(P.TRACE_EXT_VERSION)
        await self._send(writer, wlock, req_id, Op.OK, payload)
        self.wire_stats.record("wire_hello", nbytes_r=len(body), shard=conn)

    async def _read_frame(self, reader: asyncio.StreamReader) -> bytes | None:
        try:
            hdr = await reader.readexactly(4)
        except asyncio.IncompleteReadError as e:
            if not e.partial:
                return None  # clean EOF between frames
            raise ProtocolError("connection closed mid frame header") from e
        except ConnectionError:
            return None
        n = P.frame_length(hdr, max_frame=self._max_frame)
        try:
            return await reader.readexactly(n)
        except asyncio.IncompleteReadError as e:
            raise ProtocolError(
                f"connection closed mid frame ({len(e.partial)}/{n} bytes)"
            ) from e

    async def _send(self, writer, wlock, req_id: int, opcode: int, payload: bytes) -> None:
        frame = P.encode_frame(req_id, opcode, payload)
        async with wlock:
            writer.write(frame)
            await writer.drain()

    # ---------------------------------------------------------------- worker
    async def _conn_worker(self, q: asyncio.Queue, writer, wlock, conn: str) -> None:
        """Serial op execution for one connection (ordering survives the
        wire), with greedy coalescing of consecutive archive frames."""
        pending = None
        while True:
            item = pending if pending is not None else await q.get()
            pending = None
            if item is _EOF:
                return
            req_id, opcode, _ = P.split_frame(item)
            if P.mask_op(opcode)[0] == Op.ARCHIVE_BATCH:
                # wire-level batching: drain whatever archive frames are
                # already queued into one backend round (the TRACE_FLAG bit
                # is per-frame — masked off before comparing opcodes)
                frames = [item]
                while len(frames) < self._coalesce:
                    try:
                        nxt = q.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if nxt is _EOF or P.mask_op(P.split_frame(nxt)[1])[0] != Op.ARCHIVE_BATCH:
                        pending = nxt
                        break
                    frames.append(nxt)
                await self._run_archive_group(frames, writer, wlock, conn)
                continue
            try:
                await self._run_op(item, writer, wlock, conn)
            except (ConnectionError, OSError):
                return  # peer gone: nothing left to answer

    async def _run_archive_group(self, frames: list[bytes], writer, wlock, conn: str) -> None:
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()
        try:
            nbytes_in = sum(len(f) for f in frames)
            merged = await loop.run_in_executor(
                self._executor, self._archive_frames, frames
            )
            err = None
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — forwarded to the client
            merged, err = 0, e
        dt = time.perf_counter() - t0
        self.wire_stats.record(
            "wire_archive_batch", seconds=dt, nbytes_r=nbytes_in, shard=conn,
            count=merged or 1,
        )
        if len(frames) > 1:
            self.wire_stats.record("wire_coalesced_frames", count=len(frames), shard=conn)
        for f in frames:
            req_id, _, _ = P.split_frame(f)
            if err is None:
                await self._send(writer, wlock, req_id, Op.OK, b"")
            else:
                await self._send(writer, wlock, req_id, Op.ERR, P.encode_error(err))

    def _archive_frames(self, frames: list[bytes]) -> int:
        """Decode + merge archive frames, one backend ``archive_batch``.
        Runs on the executor — decoding stays off the event loop.  The
        coalesced backend call is ONE server span, parented under the first
        traced frame's wire context (one backend round, one span — exactly
        what the client's wire span timed)."""
        items = []
        ctx = None
        for f in frames:
            _, opcode, cur = P.split_frame(f)
            traced = P.mask_op(opcode)[1]
            if traced:
                tid, sid = P.decode_trace_ctx(cur)
                if ctx is None:
                    self._ensure_tracer()
                    ctx = SpanContext(tid, sid)
            items.extend(P.decode_archive_batch(cur))
        tr = self.tracer
        with tr.span("server.archive_batch", remote_parent=ctx) as sp:
            if tr.enabled:
                sp.set("frames", len(frames))
                sp.set("n_items", len(items))
            self.fdb.archive_batch(items)
        return len(items)

    async def _run_op(self, body: bytes, writer, wlock, conn: str) -> None:
        loop = asyncio.get_running_loop()
        req_id, opcode, _ = P.split_frame(body)
        t0 = time.perf_counter()
        try:
            payload = await loop.run_in_executor(
                self._executor, self._serve_op, opcode, body
            )
            resp_op = Op.OK
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — forwarded to the client
            payload, resp_op = P.encode_error(e), Op.ERR
        dt = time.perf_counter() - t0
        base = P.mask_op(opcode)[0]
        self.wire_stats.record(
            f"wire_{Op.NAMES.get(base, hex(base))}",
            seconds=dt, nbytes_r=len(body), nbytes_w=len(payload), shard=conn,
        )
        await self._send(writer, wlock, req_id, resp_op, payload)

    # --------------------------------------------------------- op execution
    def _serve_op(self, opcode: int, body: bytes) -> bytes:
        """Decode one request frame, run it against the FDB, encode the OK
        payload.  Runs on the executor thread pool.  A TRACE_FLAG'd frame
        carries a trace-context prefix: the op executes under a server span
        parented to the client's wire span, so the client can stitch the
        server-side time into ONE trace via the Op.TRACE round."""
        _, raw_op, cur = P.split_frame(body)
        opcode, traced = P.mask_op(raw_op)
        ctx = None
        if traced:
            tid, sid = P.decode_trace_ctx(cur)
            self._ensure_tracer()
            ctx = SpanContext(tid, sid)
        if opcode == Op.TRACE:
            # the extended STATS round: hand the accumulated server spans
            # to the client (drained — each round returns fresh spans)
            spans = [s.to_dict() for s in self.tracer.drain()]
            return P.pack_str(json.dumps(spans))
        tr = self.tracer
        with tr.span(_SERVER_SPANS.get(opcode, "server.op"), remote_parent=ctx) as sp:
            if tr.enabled:
                sp.set("op", Op.NAMES.get(opcode, hex(opcode)))
            return self._dispatch_op(opcode, cur)

    def _dispatch_op(self, opcode: int, cur: Cursor) -> bytes:
        if opcode == Op.RETRIEVE_BATCH:
            keys = P.decode_keys(cur)
            payloads: list[bytes | None] = []
            for h in self.fdb.retrieve_batch(keys):
                if h is None:
                    payloads.append(None)
                else:
                    try:
                        payloads.append(h.read())
                    finally:
                        h.close()
            return P.encode_handles(payloads)
        if opcode == Op.RETRIEVE_MANY:
            fs = self.fdb.retrieve_many(P.decode_request(cur))
            items: list[tuple] = []
            for key, h in zip(fs.keys, fs.handles()):
                if h is None:
                    items.append((key, None))
                else:
                    try:
                        items.append((key, h.read()))
                    finally:
                        h.close()
            return P.encode_fieldset(items)
        if opcode == Op.LIST:
            return P.encode_listing(self.fdb.list(P.decode_request(cur)))
        if opcode == Op.WIPE:
            return P.encode_wipe_report(self.fdb.wipe(P.decode_request(cur)))
        if opcode == Op.FLUSH:
            self.fdb.flush()
            return b""
        if opcode == Op.STATS:
            snap = {
                "server": self.fdb.stats_snapshot(),
                "wire": self.wire_stats.snapshot(),
            }
            return P.pack_str(json.dumps(snap, sort_keys=True))
        if opcode == Op.HELLO:
            raise ProtocolError("duplicate handshake on an established connection")
        raise ProtocolError(f"unknown opcode {opcode:#x}")


def serve_fdb(fdb, *, host: str = "127.0.0.1", port: int = 0, **kw) -> FDBServer:
    """Start an :class:`FDBServer` over *fdb*; returns the RUNNING server
    (``server.addr`` is the bound address)."""
    server = FDBServer(fdb, host=host, port=port, **kw)
    server.start()
    return server


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Serve an FDB composition tree over the wire protocol"
    )
    ap.add_argument("--config", required=True, metavar="JSON|PATH",
                    help="FDB config (repro.core.config grammar): inline JSON "
                         "or a path to a JSON file")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral; the bound port is printed)")
    ap.add_argument("--max-inflight", type=int, default=32,
                    help="per-connection backpressure bound (pipelined frames)")
    args = ap.parse_args()

    if args.config.lstrip().startswith("{"):
        cfg = json.loads(args.config)
    else:
        with open(args.config) as f:
            cfg = json.load(f)

    server = FDBServer(cfg, host=args.host, port=args.port,
                       max_inflight=args.max_inflight)
    host, port = server.start()
    print(f"FDB server listening on {host}:{port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
