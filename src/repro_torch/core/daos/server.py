"""Socket-served DAOS engine for true multi-process contention tests.

DAOS resolves contention *server-side*; to exercise that with real OS
processes (the fdb-hammer integration tests) the engine can be served over a
Unix-domain socket.  Protocol: 4-byte big-endian length + pickled
``(method, args, kwargs)``; reply: 4-byte length + pickled ``("ok", result)``
or ``("err", exc)``.  Thread-per-connection — contention lands on the
engine's internal MVCC structures, exactly where the paper puts it.
"""

from __future__ import annotations

import os
import pickle
import socket
import socketserver
import struct
import threading

from .engine import DaosEngine
from .objects import ObjectId

__all__ = ["DaosServer", "DaosClient", "serve_engine"]

_LEN = struct.Struct(">I")


def _send(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv(sock: socket.socket):
    hdr = _recv_exact(sock, _LEN.size)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return pickle.loads(body)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        engine: DaosEngine = self.server.engine  # type: ignore[attr-defined]
        while True:
            msg = _recv(self.request)
            if msg is None:
                return
            method, args, kwargs = msg
            try:
                fn = getattr(engine, method)
                result = fn(*args, **kwargs)
                # rich server-side objects (Pool/Container hold locks) travel
                # as their labels — clients only ever use labels anyway
                if hasattr(result, "label"):
                    result = result.label
                _send(self.request, ("ok", result))
            except Exception as e:  # noqa: BLE001 — forwarded to the client
                _send(self.request, ("err", e))


class _ThreadingUnixServer(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


class DaosServer:
    """Serve a DaosEngine on a Unix socket path."""

    def __init__(self, engine: DaosEngine, path: str):
        self.engine = engine
        self.path = path
        if os.path.exists(path):
            os.unlink(path)
        self._srv = _ThreadingUnixServer(path, _Handler)
        self._srv.engine = engine  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._srv.serve_forever, name="daos-server", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if os.path.exists(self.path):
            os.unlink(self.path)


def serve_engine(path: str, **engine_kw) -> DaosServer:
    srv = DaosServer(DaosEngine(**engine_kw), path)
    srv.start()
    return srv


class DaosClient:
    """Client proxy with the same method surface as DaosEngine.

    Each client process opens one connection (one 'network endpoint').
    Thread-safe via a per-connection lock.
    """

    def __init__(self, path: str):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(path)
        self._mu = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def _call(self, method: str, *args, **kwargs):
        with self._mu:
            _send(self._sock, (method, args, kwargs))
            reply = _recv(self._sock)
        if reply is None:
            raise ConnectionError("daos server closed the connection")
        status, payload = reply
        if status == "err":
            raise payload
        return payload

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)

        def method(*args, **kwargs):
            return self._call(name, *args, **kwargs)

        method.__name__ = name
        return method


# ObjectId must be picklable for the RPC layer — it is a frozen dataclass, ok.
_ = ObjectId
