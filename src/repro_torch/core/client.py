"""FDBClient — the one client surface shared by every FDB facade.

The reproduction grew three facades (:class:`~repro.core.fdb.FDB`,
:class:`~repro.core.router.FDBRouter`,
:class:`~repro.core.async_fdb.AsyncFDB`) that each hand-copied the same
~13-method matrix; the follow-up interface studies ("DAOS as HPC Storage:
Exploring Interfaces", 2023) make the point that the API surface — not just
the backend — bounds the concurrency a client can express, so the surface
is defined ONCE here and the facades override only what they genuinely
change (routing, queueing, fan-out).

Primitives a facade must provide: ``archive``, ``retrieve_batch``,
``flush``, ``_list``, ``_wipe_dataset``, ``io_stats``.  Everything else —
single retrieves, byte-reads, MARS-style ``retrieve_many`` over full AND
partial requests, validated ``list``, the store-and-catalogue ``wipe`` with
its report, context management — is derived here.

Request handling: every request-taking method accepts a
:class:`~repro.core.request.Request`, MARS text, or a plain mapping; unknown
keywords raise :class:`~repro.core.request.UnknownKeywordError` EAGERLY (at
the call, not on first iteration of a lazy listing) on every facade alike.
"""

from __future__ import annotations

import abc
import warnings
from dataclasses import dataclass
from typing import Iterable, Iterator, Mapping, Sequence

from ..obs.tracer import NULL_TRACER, install_tracer
from .catalogue import ListEntry
from .datahandle import DataHandle, FieldGoneError
from .fieldset import FieldSet
from .keys import Key
from .request import Request, as_request
from .schema import Schema

__all__ = ["FDBClient", "WipeReport"]


@dataclass(frozen=True)
class WipeReport:
    """What a ``wipe`` actually removed: index entries AND store bytes —
    wiping is no longer catalogue-only (store objects used to leak)."""

    entries_removed: int = 0
    bytes_freed: int = 0
    datasets: tuple[str, ...] = ()

    def __add__(self, other: "WipeReport") -> "WipeReport":
        """Aggregate two reports.  Dataset names are deduplicated (order
        preserved): tiered/fan-out wipes (SelectFDB, FDBRouter) each remove
        their slice of the SAME dataset, which is one wiped dataset, not
        two — counts and bytes still sum, they cover disjoint entries."""
        return WipeReport(
            self.entries_removed + other.entries_removed,
            self.bytes_freed + other.bytes_freed,
            self.datasets
            + tuple(d for d in other.datasets if d not in self.datasets),
        )

    @classmethod
    def merged(cls, reports: Iterable["WipeReport"]) -> "WipeReport":
        total = cls()
        for r in reports:
            total = total + r
        return total


class FDBClient(abc.ABC):
    """Shared FDB client surface (see module docstring)."""

    schema: Schema

    #: pack width used by :meth:`archive_fields` when the caller passes no
    #: explicit ``nbits`` — :class:`~repro.core.codec.CodecFDB` tiers fix it
    #: declaratively per tier
    _codec_nbits: int = 16

    #: span tracer — the class-level null tracer means tracing costs nothing
    #: until :meth:`set_tracer` (or the ``"trace"`` config option) installs a
    #: real one on the instance
    _trace = NULL_TRACER

    @property
    def tracer(self):
        """The tracer observing this client (:data:`~repro.obs.NULL_TRACER`
        unless one was installed)."""
        return self._trace

    def set_tracer(self, tracer) -> int:
        """Install ``tracer`` on this client and every facade below it;
        returns the number of clients touched."""
        return install_tracer(self, tracer)

    # -------------------------------------------------------- required hooks
    @abc.abstractmethod
    def archive(self, key: Key | Mapping[str, str], data: bytes) -> None:
        """Hand one field to the FDB (visibility per backend semantics)."""

    @abc.abstractmethod
    def retrieve_batch(
        self, keys: Sequence[Key | Mapping[str, str]]
    ) -> list[DataHandle | None]:
        """Vectored retrieve; absent fields come back as None."""

    @abc.abstractmethod
    def flush(self) -> None:
        """Block until everything archived by this client is visible."""

    @abc.abstractmethod
    def _list(self, request: Request) -> Iterator[ListEntry]:
        """Backend listing of an already-validated request."""

    @abc.abstractmethod
    def _wipe_dataset(self, dataset_key: Key, entries=None) -> WipeReport:
        """Remove ONE dataset from catalogue AND store; report what went.
        ``entries`` is the dataset's listing when the caller already has it
        (span wipes resolve targets by listing — don't pay the element
        reads twice); None means list here."""

    @abc.abstractmethod
    def io_stats(self) -> list:
        """The distinct IOStats sinks behind this client."""

    def _remove_fields(self, keys: Sequence["Key | Mapping[str, str]"]) -> int:
        """Field-granular removal — the lifecycle migrator's wipe step,
        applied to exactly the fields it just copied (unlike the
        dataset-granular public ``wipe``).  Returns how many fields were
        actually removed.  Wrapper facades forward to the client they
        decorate; terminal facades without per-field removal raise."""
        for attr in ("inner", "fdb"):
            sub = getattr(self, attr, None)
            if isinstance(sub, FDBClient):
                return sub._remove_fields(keys)
        raise NotImplementedError(
            f"{type(self).__name__} does not support per-field removal"
        )

    # ------------------------------------------------------------- derived IO
    def _as_key(self, key: Key | Mapping[str, str]) -> Key:
        return key if isinstance(key, Key) else Key(key)

    def archive_batch(
        self, items: Sequence[tuple[Key | Mapping[str, str], bytes]]
    ) -> None:
        """Archive many fields; semantically sequential ``archive`` calls.
        Facades with an amortised backend path override this."""
        for key, data in items:
            self.archive(key, data)

    def retrieve(self, key: Key | Mapping[str, str]) -> DataHandle | None:
        return self.retrieve_batch([key])[0]

    def _read_handle(self, key: Key | Mapping[str, str], h: DataHandle) -> bytes | None:
        """Drain one handle; on a wipe/migration race (the bytes vanished
        after the catalogue resolved — :class:`FieldGoneError`) re-resolve
        once: a migrated field reads from its new tier, a wiped one is
        ``None``.  Either way the caller sees a full field or None, never a
        torn handle."""
        try:
            try:
                return h.read()
            finally:
                h.close()
        except FieldGoneError:
            h = self.retrieve(key)
            if h is None:
                return None
            try:
                return h.read()
            except FieldGoneError:
                return None
            finally:
                h.close()

    def read(self, key: Key | Mapping[str, str]) -> bytes | None:
        h = self.retrieve(key)
        if h is None:
            return None
        return self._read_handle(key, h)

    def read_batch(
        self, keys: Sequence[Key | Mapping[str, str]]
    ) -> list[bytes | None]:
        out: list[bytes | None] = []
        for key, h in zip(keys, self.retrieve_batch(keys)):
            out.append(None if h is None else self._read_handle(key, h))
        return out

    def drain(self) -> None:
        """Write barrier: all accepted archives have reached the backend.
        Synchronous clients are always drained; queueing facades override."""

    # ------------------------------------------------------------- field codec
    def _codec_sink(self):
        """This client's codec telemetry sink (lazily created — clients that
        never touch the field codec carry no extra state)."""
        s = self.__dict__.get("_codec_stats")
        if s is None:
            from ..metrics.iostats import IOStats

            s = self.__dict__["_codec_stats"] = IOStats("codec")
        return s

    def _codec_sinks(self) -> list:
        """The codec sink as a (possibly empty) list — facades append this
        to their ``io_stats()`` so effective-vs-wire bytes surface in every
        merged snapshot without a sink for clients that never packed."""
        s = self.__dict__.get("_codec_stats")
        return [s] if s is not None else []

    def archive_fields(self, keys: Sequence[Key | Mapping[str, str]], fields,
                       *, nbits: int | None = None) -> None:
        """Archive a batch of 2-D field arrays GRIB-packed on the wire path.

        ``fields`` is an ``(F, H, W)`` array (or a sequence of ``(H, W)``
        arrays) aligned with ``keys``.  The WHOLE batch is bit-packed in one
        ``grib_pack`` Pallas launch (one per distinct shape when ragged) and
        handed to :meth:`archive_batch`, so the backend's amortised write
        path sees wire payloads, exactly like real GRIB traffic.  Routing
        facades (SelectFDB, FDBRouter) split the batch per tier/lane FIRST,
        so a ``{"type": "codec"}`` tier packs at its own declared width;
        ``nbits`` overrides the client's default for this call."""
        from .codec import encode_fields

        tr = self._trace
        with tr.span("client.archive_fields") as sp:
            keys = list(keys)
            payloads = encode_fields(
                fields,
                nbits=self._codec_nbits if nbits is None else nbits,
                stats=self._codec_sink(),
                tracer=tr,
            )
            if len(keys) != len(payloads):
                raise ValueError(
                    f"archive_fields got {len(keys)} keys for {len(payloads)} fields"
                )
            if tr.enabled:
                sp.set("n_fields", len(keys))
                sp.set("wire_bytes", sum(len(p) for p in payloads))
            self.archive_batch(list(zip(keys, payloads)))

    def retrieve_fields(self, request) -> "DecodedFieldSet":
        """MARS-style retrieval of codec'd fields: ``retrieve_many`` under
        the hood, decoded lazily chunk by chunk — a partial request slice
        pays one backend fetch and one ``grib_unpack`` launch per chunk.
        Payloads are self-describing, so mixed-width datasets (16-bit hot,
        24-bit cold) decode uniformly; a raw (non-codec) payload raises
        :class:`~repro.core.codec.CodecError` naming the field."""
        from .codec import DecodedFieldSet

        fs = self.retrieve_many(request)
        chunk = self._fieldset_batch if self._fieldset_batch is not None else len(fs)
        return DecodedFieldSet(
            fs, chunk=chunk, stats=self._codec_sink(), tracer=self._trace
        )

    # --------------------------------------------------------------- requests
    def _validated_request(self, request) -> Request:
        req = as_request(request)
        # raises UnknownKeywordError for keywords outside the schema —
        # eagerly, identically on every facade and backend
        self.schema.request_levels(req)
        return req

    def list(self, request=None) -> Iterator[ListEntry]:
        """All (identifier, location) pairs matching a (possibly partial)
        request — Request, MARS text, or mapping.  Unknown keywords raise
        immediately, not on first iteration."""
        req = self._validated_request(request)
        return self._list(req)

    def _many_fetch(self, keys: list[Key]) -> Sequence[DataHandle | None]:
        """The vectored fetch a FieldSet resolves through (override to fan
        out)."""
        return self.retrieve_batch(keys)

    _fieldset_batch: int | None = 64

    def retrieve_many(self, request) -> FieldSet:
        """MARS-style retrieval: a request that is fully specified with
        exact value lists expands client-side to its cartesian product
        (absent fields surface as None); anything partial, ranged or
        wildcarded is resolved against the catalogue (level-pruned
        ``list()``, so unmatched datasets are never scanned) — ranges match
        numerically there, so ``step=06`` is found by ``step=0/to/12/by/6``
        whichever spelling was archived.  Returns a lazy :class:`FieldSet`
        — iterate ``(Key, DataHandle)`` pairs or take the aggregated
        streaming handle."""
        tr = self._trace
        with tr.span("client.retrieve_many") as sp:
            req = self._validated_request(request)
            if req.is_exact(self.schema):
                keys = req.expand(self.schema)
            else:
                keys = [e.key for e in self._list(req)]
            if tr.enabled:
                sp.set("n_keys", len(keys))
            return FieldSet(keys, self._many_fetch, batch_size=self._fieldset_batch)

    def read_many(self, request) -> dict[Key, bytes | None]:
        """Deprecated: use ``retrieve_many(request).read_all()``."""
        warnings.warn(
            "FDBClient.read_many() is deprecated; use "
            "retrieve_many(request).read_all()",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.retrieve_many(request).read_all()

    # ------------------------------------------------------------------- wipe
    def wipe(self, request) -> WipeReport:
        """Remove whole datasets — index entries AND store data — and report
        what was removed.  Accepts a full identifier, a dataset key, or a
        request with spans over the dataset keywords (each matched dataset
        is wiped); all dataset keywords must be present.

        Wiping is dataset-granular: single-valued non-dataset keywords (a
        full identifier) are accepted and ignored, but a NARROWING span on
        one (``step=0/to/2``, ``param=*``, multi-value lists) would suggest
        a subset wipe this API cannot do — that raises instead of silently
        deleting the whole dataset."""
        tr = self._trace
        with tr.span("client.wipe") as sp:
            req = self._validated_request(request)
            self._wipe_validate(req)
            # a wipe must see everything THIS client archived — queued or
            # unpublished fields would otherwise dodge catalogue-resolved spans
            # (deferred-visibility backends) and dangle or survive; flushing
            # first makes wipe-after-archive well-defined on every facade
            self.flush()
            ds_req = Request({k: req[k] for k in self.schema.dataset_keys})
            report = WipeReport()
            for ds, entries in self._wipe_targets(ds_req):
                report = report + self._wipe_dataset(ds, entries)
            if tr.enabled:
                sp.set("entries_removed", report.entries_removed)
                sp.set("bytes_freed", report.bytes_freed)
            return report

    def _wipe_validate(self, req: Request) -> None:
        """The wipe request contract, shared by every facade INCLUDING the
        remote client (which validates before paying a network round): all
        dataset keywords present, no narrowing span on a non-dataset one."""
        missing = [k for k in self.schema.dataset_keys if k not in req]
        if missing:
            raise KeyError(
                f"wipe request missing dataset keywords {missing} "
                f"(schema {self.schema.name})"
            )
        narrowed = [
            kw for kw in req
            if kw not in self.schema.dataset_keys
            and not (req[kw].is_exact and len(req[kw].values()) == 1)
        ]
        if narrowed:
            raise ValueError(
                f"wipe removes whole datasets; non-dataset keywords {narrowed} "
                "carry narrowing spans that cannot be honoured — drop them "
                "(or pass single values) to wipe the matched datasets"
            )

    def _wipe_targets(self, ds_req: Request) -> list[tuple[Key, list | None]]:
        """The dataset keys a wipe request names (with their listings when
        resolving already produced them): the cartesian product when every
        span is an exact value list, else whatever the catalogue resolves —
        a range like ``date=20200101/to/20260101`` wipes the datasets that
        actually exist, not millions of no-op products, and the resolving
        listing is reused for the report instead of listing twice."""
        if all(ds_req[kw].is_exact for kw in self.schema.dataset_keys):
            import itertools

            spans = [
                [(kw, v) for v in ds_req[kw].values()]
                for kw in self.schema.dataset_keys
            ]
            return [(Key(c), None) for c in itertools.product(*spans)]
        groups: dict[Key, list] = {}
        for e in self._list(ds_req):
            groups.setdefault(e.key.subset(self.schema.dataset_keys), []).append(e)
        return list(groups.items())

    # -------------------------------------------------------------- telemetry
    def stats_snapshot(self) -> dict:
        """One consistent, JSON-ready merge of this client's telemetry."""
        from ..metrics.iostats import IOStats

        return IOStats.merged(self.io_stats()).snapshot()

    # -------------------------------------------------------------- lifecycle
    def close(self) -> None:
        self.flush()

    def __enter__(self) -> "FDBClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
