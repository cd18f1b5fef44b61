"""repro.core — the paper's contribution: the FDB and its two backend pairs.

Public surface:

- :class:`Key`, :class:`Schema` — metadata identifiers and the 3-level split
- :class:`Request` — the first-class MARS-style request language
  (``step=0/6/12``, ``step=0/to/240/by/6``, ``param=*``, partial requests)
- :class:`FDBClient` — the one client protocol every facade implements
- :class:`FDBConfig`, :func:`build_fdb` — declarative, JSON round-trippable
  composition of any facade tree (``local``/``select``/``dist``/``async``),
  with a pluggable backend registry (:func:`register_backend`)
- :class:`FDB`, :func:`make_fdb` — the facade with the paper's semantics
- :class:`SelectFDB` — tiered metadata routing (hot DAOS / cold POSIX)
- :class:`AsyncFDB` — background writer pool + parallel batched reads
- :class:`FDBRouter`, :func:`make_router` — multi-lane dataset sharding
- :class:`RemoteFDB`, :class:`FDBServer` — the wire transport: any facade
  tree served over TCP (``{"type": "remote", ...}`` in config)
- :class:`FieldSet` — lazy MARS retrieval result with an aggregated handle
- :mod:`repro.core.daos` — the emulated DAOS (MVCC KV/Array object store)
- :mod:`repro.core.posix` / :mod:`repro.core.daos_backend` — the backends
- :mod:`repro.core.costmodel` — Lustre-vs-DAOS per-op cost model at scale
"""

from .async_fdb import AsyncFDB
from .catalogue import Catalogue, ListEntry
from .client import FDBClient, WipeReport
from .codec import (
    CODEC_HEADER_SIZE,
    CodecError,
    CodecFDB,
    DecodedFieldSet,
    decode_payloads,
    encode_fields,
    is_codec_payload,
    wire_size,
)
from .config import (
    ConfigError,
    FDBConfig,
    build_fdb,
    register_backend,
    register_schema,
    registered_backends,
)
from .datahandle import DataHandle, FieldGoneError, MemoryDataHandle
from .fdb import FDB, make_fdb
from .fieldset import ConcatenatedDataHandle, FieldResolutionError, FieldSet
from .keys import Key, key_union
from .request import (
    Request,
    RequestSyntaxError,
    Span,
    UnknownKeywordError,
    WILDCARD,
    as_request,
    as_span,
)
from .remote import (
    FDBServer,
    RemoteError,
    RemoteFDB,
    RemoteTimeout,
    serve_fdb,
)
from .router import FDBRouter, make_router
from .select import SelectFDB
from .schema import (
    CHECKPOINT_SCHEMA,
    DATASET_SCHEMA,
    NWP_SCHEMA_DAOS,
    NWP_SCHEMA_POSIX,
    Schema,
    SplitKey,
)
from .store import FieldLocation, Store

__all__ = [
    "Key",
    "key_union",
    "Schema",
    "SplitKey",
    "Request",
    "RequestSyntaxError",
    "UnknownKeywordError",
    "Span",
    "WILDCARD",
    "as_request",
    "as_span",
    "FDBClient",
    "WipeReport",
    "FieldSet",
    "FieldResolutionError",
    "FieldGoneError",
    "ConcatenatedDataHandle",
    "CODEC_HEADER_SIZE",
    "CodecError",
    "CodecFDB",
    "DecodedFieldSet",
    "decode_payloads",
    "encode_fields",
    "is_codec_payload",
    "wire_size",
    "FDB",
    "make_fdb",
    "SelectFDB",
    "AsyncFDB",
    "FDBRouter",
    "make_router",
    "RemoteFDB",
    "FDBServer",
    "RemoteError",
    "RemoteTimeout",
    "serve_fdb",
    "FDBConfig",
    "ConfigError",
    "build_fdb",
    "register_backend",
    "register_schema",
    "registered_backends",
    "Catalogue",
    "ListEntry",
    "Store",
    "FieldLocation",
    "DataHandle",
    "MemoryDataHandle",
    "NWP_SCHEMA_DAOS",
    "NWP_SCHEMA_POSIX",
    "CHECKPOINT_SCHEMA",
    "DATASET_SCHEMA",
]
