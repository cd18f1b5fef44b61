"""repro.core.remote — the FDB wire transport.

The paper's deployment shape puts clients on compute nodes and the
catalogue/store services on storage nodes (§1.2); every other facade in this
repo runs in-process.  This package is the network layer between them:

- :mod:`repro.core.remote.protocol` — the length-prefixed binary protocol
  serializing MARS :class:`~repro.core.request.Request` /
  :class:`~repro.core.keys.Key` plus the batch ops;
- :mod:`repro.core.remote.server` — an asyncio server fronting any
  :func:`~repro.core.config.build_fdb` tree, with wire-level request
  batching and per-connection backpressure;
- :mod:`repro.core.remote.client` — :class:`RemoteFDB`, a full
  :class:`~repro.core.client.FDBClient` over the wire with connection
  pooling, configurable timeouts and bounded retry-with-backoff.

Declaratively, ``{"type": "remote", "addr": "host:port"}`` (connect) or
``{"type": "remote", "inner": {...}}`` (self-hosted loopback server) drops a
remote tier into any SelectFDB/FDBRouter/AsyncFDB composition unchanged.
"""

from .client import RemoteFDB
from .protocol import (
    PROTOCOL_VERSION,
    ProtocolError,
    RemoteError,
    RemoteTimeout,
)
from .server import FDBServer, serve_fdb

__all__ = [
    "FDBServer",
    "PROTOCOL_VERSION",
    "ProtocolError",
    "RemoteError",
    "RemoteFDB",
    "RemoteTimeout",
    "serve_fdb",
]
