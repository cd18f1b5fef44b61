"""SelectFDB — metadata-driven routing across heterogeneous FDB tiers.

ECMWF's operational deployment never runs a single FDB: a ``select``
composition routes every request by metadata between an operational hot FDB
on NVM and the cold parallel-filesystem archive (paper §1.3; "DAOS as HPC
Storage, a view from NWP").  This facade reproduces that: an ordered list of
``(match, client)`` rules plus an optional default tier, where *match* is any
MARS-style request fragment (``class=od,stream=oper`` — spans, ranges and
wildcards all work) and *client* is any :class:`~repro.core.client.FDBClient`
(a plain FDB, an AsyncFDB, a router, even another SelectFDB).

Routing semantics:

- ``archive``/``retrieve`` route one identifier to the FIRST rule whose
  match covers it, else to the default tier; an archive that no tier accepts
  raises (a silently dropped field is operationally worse than an error),
  while an unroutable retrieve returns None (cache semantics — the key
  cannot exist anywhere);
- ``list``/``wipe``/partial ``retrieve_many`` fan out over every tier whose
  rule COULD intersect the request (plus the default, which can hold
  anything), and merge the per-tier results — ``ListEntry`` streams
  concatenate, :class:`~repro.core.client.WipeReport`s aggregate through
  ``WipeReport.__add__`` (which dedupes dataset names across tiers);
- tiers may use DIFFERENT schemas (the paper's per-backend keyword
  placement: ``NWP_SCHEMA_DAOS`` hot, ``NWP_SCHEMA_POSIX`` cold) as long as
  they agree on the keyword *set* and the dataset keywords — the level split
  below the dataset is a per-tier layout detail the router never sees.

The shared client surface (reads, MARS retrieval, wipe validation, context
management) comes from :class:`FDBClient`; this class adds only the tiering.
Build one declaratively with ``{"type": "select", ...}`` through
:func:`~repro.core.config.build_fdb`.
"""

from __future__ import annotations

import threading
from typing import Iterator, Mapping, Sequence

from .catalogue import ListEntry
from .client import FDBClient, WipeReport
from .datahandle import DataHandle
from .keys import Key
from .request import Request, Span, as_request
from .schema import Schema

__all__ = ["SelectFDB"]


def _spans_intersect(a: Span, b: Span) -> bool:
    """Could some value satisfy both spans?  Wildcards intersect everything.
    Enumerable spans are checked against the other side's ``contains`` in
    BOTH directions: membership can be spelling-sensitive on one side and
    numeric on the other (``step=06`` meets ``step=0/to/12/by/6`` only via
    the range's numeric ``contains``, never via its canonical enumeration)."""
    if a.is_wildcard or b.is_wildcard:
        return True
    av, bv = a.values(), b.values()
    if av is not None and any(b.contains(v) for v in av):
        return True
    if bv is not None and any(a.contains(v) for v in bv):
        return True
    # an enumerable side whose every value the other side rejects is
    # conclusively disjoint; two non-enumerable spans cannot be disproven
    return av is None and bv is None


class SelectFDB(FDBClient):
    def __init__(
        self,
        rules: Sequence[tuple],
        default: FDBClient | None = None,
        *,
        shared: Sequence[FDBClient] = (),
    ):
        """``rules``: ordered ``(match, client)`` or ``(match, client, name)``
        tuples — *match* is a :class:`Request`, MARS text, or mapping; first
        match wins; *name* (optional) labels the tier for lifecycle policies
        (``from_tier``/``to_tier``).  ``default``: the tier for identifiers
        no rule covers (optional — without it, unmatched archives raise).
        ``shared``: tiers this facade does NOT own — flush/drain still reach
        them, ``close()`` leaves them open (config builds list prebuilt
        pass-through subtrees here, so closing the tree never closes a
        caller's client)."""
        self._shared = {id(c) for c in shared}
        self._rules: list[tuple[Request, FDBClient]] = []
        names: dict[int, str] = {}
        for rule in rules:
            match, client, *rest = rule
            self._rules.append((as_request(match), client))
            if rest and rest[0] is not None:
                names.setdefault(id(client), str(rest[0]))
        self._default = default
        tiers: dict[int, FDBClient] = {}
        for _, client in self._rules:
            tiers.setdefault(id(client), client)
        if default is not None:
            tiers.setdefault(id(default), default)
            names.setdefault(id(default), "default")
        if not tiers:
            raise ValueError("SelectFDB needs at least one rule or a default tier")
        #: distinct tier clients, in rule order (default last)
        self.tiers: tuple[FDBClient, ...] = tuple(tiers.values())
        #: per-tier labels aligned with ``tiers`` (rule ``name`` or ``tierN``)
        self.tier_names: tuple[str, ...] = tuple(
            names.get(id(c), f"tier{i}") for i, c in enumerate(self.tiers)
        )
        if len(set(self.tier_names)) != len(self.tier_names):
            raise ValueError(f"select tier names must be unique: {self.tier_names}")
        self._tier_by_name = dict(zip(self.tier_names, self.tiers))
        # migration placement overlay: dataset Key -> {full Key -> owning
        # tier}.  Consulted BEFORE the static rules so a moved field resolves
        # to its new tier without config edits; written only through
        # place()/clear_placement() under the lock.
        self._overlay: dict[Key, dict[Key, FDBClient]] = {}
        self._overlay_mu = threading.Lock()
        self.schema: Schema = self.tiers[0].schema
        # tiers may split levels differently (per-backend keyword placement)
        # but must agree on WHAT the keywords are and which form a dataset —
        # the select layer validates requests and wipes against one schema
        for t in self.tiers[1:]:
            if set(t.schema.all_keys) != set(self.schema.all_keys) or tuple(
                t.schema.dataset_keys
            ) != tuple(self.schema.dataset_keys):
                raise ValueError(
                    f"select tiers must agree on keywords and dataset keys: "
                    f"schema {t.schema.name!r} is incompatible with {self.schema.name!r}"
                )
        # a rule naming keywords outside the schema could never match a valid
        # identifier — that is a dead tier, i.e. a config typo: fail now
        for match, _ in self._rules:
            self.schema.request_levels(match)
        # tier-attribution for trace spans: position in rule order
        self._tier_index = {id(c): i for i, c in enumerate(self.tiers)}

    # ------------------------------------------------------------------ routing
    def route(self, key: Key | Mapping[str, str]) -> FDBClient | None:
        """The tier that owns *key*: placement overlay first (a migrated
        field lives where the migrator put it, whatever the static rules
        say), then the first matching rule, then the default, else None."""
        key = self._as_key(key)
        if self._overlay:
            ds = key.subset(self.schema.dataset_keys)
            with self._overlay_mu:
                placed = self._overlay.get(ds)
                if placed is not None:
                    client = placed.get(key)
                    if client is not None:
                        return client
        for match, client in self._rules:
            if match.matches(key):
                return client
        return self._default

    # ---------------------------------------------------------- placement overlay
    def resolve_tier(self, tier: FDBClient | str) -> FDBClient:
        """Map a tier name (or a tier client, validated) to the client."""
        if isinstance(tier, str):
            try:
                return self._tier_by_name[tier]
            except KeyError:
                raise ValueError(
                    f"unknown select tier {tier!r}; have {self.tier_names}"
                ) from None
        if id(tier) not in self._tier_index:
            raise ValueError("placement target is not a tier of this SelectFDB")
        return tier

    def place(self, key: Key | Mapping[str, str], tier: FDBClient | str) -> None:
        """Pin *key* to *tier* in the overlay (atomic per key).  The migrator
        uses this twice per field: first to pin the SOURCE tier while the
        copy is in flight (so the destination's freshly-catalogued duplicate
        stays invisible), then to flip to the destination — at no point does
        a reader see zero or two authoritative copies."""
        client = self.resolve_tier(tier)
        key = self._as_key(key)
        ds = key.subset(self.schema.dataset_keys)
        with self._overlay_mu:
            self._overlay.setdefault(ds, {})[key] = client

    def placement(self, key: Key | Mapping[str, str]) -> FDBClient | None:
        """The overlay entry for *key*, or None if it follows the static rules."""
        key = self._as_key(key)
        ds = key.subset(self.schema.dataset_keys)
        with self._overlay_mu:
            placed = self._overlay.get(ds)
            return None if placed is None else placed.get(key)

    def clear_placement(self, key: Key | Mapping[str, str]) -> None:
        key = self._as_key(key)
        ds = key.subset(self.schema.dataset_keys)
        with self._overlay_mu:
            placed = self._overlay.get(ds)
            if placed is not None:
                placed.pop(key, None)
                if not placed:
                    del self._overlay[ds]

    def overlay_snapshot(self) -> dict:
        """Counts per tier name — how many fields the overlay has pinned."""
        name_of = {id(c): n for n, c in self._tier_by_name.items()}
        out: dict[str, int] = {}
        with self._overlay_mu:
            for placed in self._overlay.values():
                for client in placed.values():
                    n = name_of.get(id(client), f"tier{self._tier_index[id(client)]}")
                    out[n] = out.get(n, 0) + 1
        return out

    def _overlay_tiers(self, request: Request) -> list[FDBClient]:
        """Tiers the overlay pins keys to, for datasets *request* could
        touch — these must join any fan-out even when no static rule of
        theirs intersects the request."""
        if not self._overlay:
            return []
        out: dict[int, FDBClient] = {}
        with self._overlay_mu:
            for ds, placed in self._overlay.items():
                if ds.matches({k: s for k, s in request.items() if k in ds}):
                    for client in placed.values():
                        out.setdefault(id(client), client)
        return list(out.values())

    def _route_or_raise(self, key: Key | Mapping[str, str]) -> FDBClient:
        client = self.route(key)
        if client is None:
            raise ValueError(
                f"no select rule matches identifier {dict(self._as_key(key))!r} "
                "and no default tier is configured"
            )
        return client

    def _matching_tiers(self, request: Request) -> list[FDBClient]:
        """Distinct tiers a request fans out to: every tier with a rule that
        could intersect it, plus the default (which can hold anything a rule
        declined), in rule order."""
        out: dict[int, FDBClient] = {}
        for match, client in self._rules:
            if all(
                kw not in request or _spans_intersect(span, request[kw])
                for kw, span in match.items()
            ):
                out.setdefault(id(client), client)
        if self._default is not None:
            out.setdefault(id(self._default), self._default)
        for client in self._overlay_tiers(request):
            out.setdefault(id(client), client)
        return list(out.values())

    # --------------------------------------------------------------------- write
    def archive(self, key: Key | Mapping[str, str], data: bytes) -> None:
        tr = self._trace
        with tr.span("select.archive") as sp:
            client = self._route_or_raise(key)
            if tr.enabled:
                sp.set("tier", self._tier_index[id(client)])
            client.archive(key, data)

    def archive_batch(self, items: Sequence[tuple[Key | Mapping[str, str], bytes]]) -> None:
        tr = self._trace
        with tr.span("select.archive_batch") as sp:
            groups: dict[int, tuple[FDBClient, list]] = {}
            for key, data in items:
                client = self._route_or_raise(key)
                groups.setdefault(id(client), (client, []))[1].append((key, data))
            if tr.enabled:
                sp.set("n_items", len(items))
                sp.set("n_tiers", len(groups))
            for client, group in groups.values():
                with tr.span("select.tier_archive") as tsp:
                    if tr.enabled:
                        tsp.set("tier", self._tier_index[id(client)])
                        tsp.set("n_items", len(group))
                    client.archive_batch(group)

    def archive_fields(self, keys, fields, *, nbits=None) -> None:
        """Route the batch BEFORE packing: each tier packs its own slice at
        its own width, so a ``{"type": "codec", "nbits": 16}`` hot tier and
        a 24-bit cold tier coexist behind one call (the paper's per-tier
        layout choice, applied to the codec)."""
        from .codec import take_fields

        tr = self._trace
        with tr.span("select.archive_fields") as sp:
            keys = list(keys)
            groups: dict[int, tuple[FDBClient, list[int]]] = {}
            for i, key in enumerate(keys):
                client = self._route_or_raise(key)
                groups.setdefault(id(client), (client, []))[1].append(i)
            if tr.enabled:
                sp.set("n_fields", len(keys))
                sp.set("n_tiers", len(groups))
            for client, idxs in groups.values():
                with tr.span("select.tier_archive_fields") as tsp:
                    if tr.enabled:
                        tsp.set("tier", self._tier_index[id(client)])
                        tsp.set("n_fields", len(idxs))
                    client.archive_fields(
                        [keys[i] for i in idxs], take_fields(fields, idxs), nbits=nbits
                    )

    def flush(self) -> None:
        for tier in self.tiers:
            tier.flush()

    def drain(self) -> None:
        # forward the write barrier — an AsyncFDB tier would otherwise skip it
        for tier in self.tiers:
            tier.drain()

    # ---------------------------------------------------------------------- read
    def _retrieve_routed(self, key: Key | Mapping[str, str], client: FDBClient) -> DataHandle | None:
        """Retrieve from the tier ``route`` picked, re-routing once on a
        miss: between resolving the route and the catalogue lookup a
        migration flip may have moved the key (and removed the source
        copy), so a miss from a now-stale tier must be retried against the
        CURRENT owner before it counts as absent."""
        h = client.retrieve(key)
        if h is None:
            now = self.route(key)
            if now is not None and now is not client:
                return now.retrieve(key)
        return h

    def retrieve(self, key: Key | Mapping[str, str]) -> DataHandle | None:
        client = self.route(key)
        return None if client is None else self._retrieve_routed(key, client)

    def retrieve_batch(self, keys: Sequence[Key | Mapping[str, str]]) -> list[DataHandle | None]:
        tr = self._trace
        with tr.span("select.retrieve_batch") as sp:
            groups: dict[int, tuple[FDBClient, list[int]]] = {}
            out: list[DataHandle | None] = [None] * len(keys)
            for i, key in enumerate(keys):
                client = self.route(key)
                if client is not None:
                    groups.setdefault(id(client), (client, []))[1].append(i)
            if tr.enabled:
                sp.set("n_keys", len(keys))
                sp.set("n_tiers", len(groups))
            for client, idxs in groups.values():
                with tr.span("select.tier_retrieve") as tsp:
                    if tr.enabled:
                        tsp.set("tier", self._tier_index[id(client)])
                        tsp.set("n_keys", len(idxs))
                    results = client.retrieve_batch([keys[i] for i in idxs])
                for i, r in zip(idxs, results):
                    if r is None:
                        # miss from a tier that may have just lost the key
                        # to a migration flip — re-route before answering
                        now = self.route(keys[i])
                        if now is not None and now is not client:
                            r = now.retrieve(keys[i])
                    out[i] = r
            return out

    def _list(self, request: Request) -> Iterator[ListEntry]:
        """Merged listing across every tier the request could touch.  Tiers
        hold disjoint identifiers (each key routes to exactly one tier), so
        concatenation IS the merge.  Datasets under migration are the one
        exception: mid-copy, a field is catalogued on BOTH the source and the
        destination tier, so for those datasets each entry is yielded only
        from the tier ``route`` currently resolves it to — the merged listing
        never shows duplicates or drops a key, whichever side of the flip a
        concurrent migration is on."""
        with self._overlay_mu:
            ovl_datasets = set(self._overlay)
        ds_keys = self.schema.dataset_keys
        for tier in self._matching_tiers(request):
            for entry in getattr(tier, "_list", tier.list)(request):
                if ovl_datasets and entry.key.subset(ds_keys) in ovl_datasets:
                    if self.route(entry.key) is not tier:
                        continue
                yield entry

    # ---------------------------------------------------------------------- wipe
    def _wipe_dataset(self, dataset_key: Key, entries=None) -> WipeReport:
        """Fan one dataset wipe out across the tiers that could hold any of
        its fields and aggregate the reports (``WipeReport.__add__`` dedupes
        the dataset names).  The caller's merged ``entries`` span tiers, so
        each tier resolves its own listing (``entries=None``) — a tier must
        only count what IT removed."""
        del entries
        ds_req = as_request(dataset_key)
        report = WipeReport()
        for tier in self._matching_tiers(ds_req):
            report = report + tier._wipe_dataset(dataset_key, None)
        # the dataset is gone everywhere — any migration placements for it
        # are now dangling and must not redirect a future re-archive
        with self._overlay_mu:
            self._overlay.pop(self._as_key(dataset_key).subset(self.schema.dataset_keys), None)
        return report

    # ------------------------------------------------------------------ telemetry
    def io_stats(self) -> list:
        """Distinct stats instances across all tiers (shared sinks — e.g.
        one DAOS engine behind two tiers — are deduplicated, so a merged
        snapshot never double-counts)."""
        seen: dict[int, object] = {}
        for tier in self.tiers:
            for s in tier.io_stats():
                seen.setdefault(id(s), s)
        return list(seen.values()) + self._codec_sinks()

    def stats_snapshot(self) -> dict:
        """Merged telemetry plus the per-tier breakdown."""
        snap = super().stats_snapshot()
        snap["tiers"] = [tier.stats_snapshot() for tier in self.tiers]
        overlay = self.overlay_snapshot()
        if overlay:
            snap["overlay"] = overlay
        return snap

    # ------------------------------------------------------------------ lifecycle
    def close(self) -> None:
        # a failing tier must not leave the others unflushed: close every
        # owned tier (shared ones only flush — the caller closes them),
        # then re-raise the first failure
        first_err: Exception | None = None
        for tier in self.tiers:
            try:
                if id(tier) in self._shared:
                    tier.flush()
                else:
                    tier.close()
            except Exception as e:  # noqa: BLE001
                first_err = first_err or e
        if first_err is not None:
            raise first_err
