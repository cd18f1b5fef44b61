"""Metadata keys — the FDB's unit of identity.

All FDB API actions are invoked using scientifically-meaningful metadata: a
*Key* is an ordered set of ``keyword=value`` pairs conforming to a schema
(see :mod:`repro.core.schema`).  Keys are split by the schema into three
sub-keys — dataset / collocation / element — which control storage layout
(paper §1.3).

Stringification joins values with ``':'`` (paper §3: "All dataset,
collocation or element keys are stringified for indexing by joining all
values in the key with a ':' character, which can symmetrically be used to
reconstruct the key").
"""

from __future__ import annotations

from typing import Iterable, Iterator, Mapping

__all__ = ["Key", "key_union"]

_SEP = ":"
# '/' and '*' belong to the request grammar (spans, wildcards): a key token
# containing them would silently change meaning when the key is used as a
# request, so they are forbidden the same way the structural chars are
_FORBIDDEN = {_SEP, "=", ",", "/", "*", "\n"}


def _check_token(tok: str) -> str:
    tok = str(tok)
    for ch in _FORBIDDEN:
        if ch in tok:
            raise ValueError(f"character {ch!r} not allowed in key token {tok!r}")
    return tok


class Key(Mapping[str, str]):
    """An ordered, immutable ``keyword=value`` mapping.

    Order is semantically meaningful: the stringified form joins *values* in
    insertion order, and reconstruction relies on the schema knowing the
    keyword order.
    """

    __slots__ = ("_items", "_hash")

    def __init__(self, items: Mapping[str, str] | Iterable[tuple[str, str]] = (), **kw: str):
        pairs: list[tuple[str, str]] = []
        if isinstance(items, Mapping):
            pairs.extend((k, v) for k, v in items.items())
        else:
            pairs.extend(items)
        pairs.extend(kw.items())
        seen: dict[str, str] = {}
        for k, v in pairs:
            k = _check_token(k)
            v = _check_token(v)
            if k in seen and seen[k] != v:
                raise ValueError(f"conflicting values for keyword {k!r}: {seen[k]!r} vs {v!r}")
            seen[k] = v
        self._items: tuple[tuple[str, str], ...] = tuple(seen.items())
        # order-insensitive: two Keys with the same pairs are equal even if
        # built in different (schema-level) orders, so hash must match too
        self._hash = hash(frozenset(self._items))

    # -- Mapping protocol ---------------------------------------------------
    def __getitem__(self, k: str) -> str:
        for kk, vv in self._items:
            if kk == k:
                return vv
        raise KeyError(k)

    def __iter__(self) -> Iterator[str]:
        return (k for k, _ in self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Key):
            return dict(self._items) == dict(other._items)
        if isinstance(other, Mapping):
            return dict(self._items) == dict(other)
        return NotImplemented

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v}" for k, v in self._items)
        return f"Key({inner})"

    # -- FDB-specific -------------------------------------------------------
    def stringify(self) -> str:
        """Join all *values* with ':' (paper §3)."""
        return _SEP.join(v for _, v in self._items)

    def canonical(self) -> str:
        """Fully self-describing ``k=v,k=v`` form (used in URIs and TOCs)."""
        return ",".join(f"{k}={v}" for k, v in self._items)

    @classmethod
    def from_canonical(cls, s: str) -> "Key":
        if not s:
            return cls()
        return cls((kv.split("=", 1)[0], kv.split("=", 1)[1]) for kv in s.split(","))

    @classmethod
    def destringify(cls, s: str, keywords: Iterable[str]) -> "Key":
        """Reconstruct a Key from its ':'-joined values + the schema's keyword order."""
        kws = list(keywords)
        vals = s.split(_SEP)
        if len(vals) != len(kws):
            raise ValueError(f"cannot destringify {s!r} with keywords {kws}")
        return cls(zip(kws, vals))

    def subset(self, keywords: Iterable[str]) -> "Key":
        return Key((k, self[k]) for k in keywords)

    def matches(self, request: Mapping[str, Iterable[str] | str]) -> bool:
        """True if for every keyword in *request*, our value is within its
        span.  Spans understand the full MARS syntax — explicit lists,
        ``a/to/b/by/c`` ranges and ``*`` wildcards — whether given as
        :class:`~repro.core.request.Span` objects, strings, or iterables."""
        from .request import as_span  # late: request.py imports Key

        for k, span in request.items():
            if k not in self:
                return False
            if not as_span(span).contains(self[k]):
                return False
        return True


def key_union(*keys: Key) -> Key:
    """Combine sub-keys back into a full identifier (conflicts are errors)."""
    pairs: list[tuple[str, str]] = []
    for k in keys:
        pairs.extend(k.items())
    return Key(pairs)
