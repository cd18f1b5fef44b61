"""First-class MARS-style requests — the FDB's query language.

The paper's FDB is driven entirely by scientifically-meaningful metadata
(§1.3); operationally those requests are written in the MARS request
language.  This module gives the reproduction the same first-class type
instead of raw ``Mapping[str, str | Iterable]`` plumbing:

- multi-value spans        ``step=0/6/12``
- numeric ranges           ``step=0/to/240/by/6``  (``by`` defaults to 1)
- wildcards                ``param=*``
- partial requests that simply omit keywords

A :class:`Request` is an ordered, immutable ``keyword -> Span`` mapping with
a parser (:meth:`Request.parse`) and a canonical formatter
(:meth:`Request.format`) that round-trip.  ``Request.expand(schema)`` turns
a *fully-specified* request (every schema keyword present, every span
enumerable) into the cartesian product of full identifiers; *partial*
requests are resolved against the catalogue instead (level-pruned
``list()`` — see :meth:`repro.core.client.FDBClient.retrieve_many`).

Requests remain plain ``Mapping``s, so everything that consumed raw request
dicts (``Key.matches``, ``Schema.request_levels``, both backend catalogues)
keeps working — dicts with string/iterable values are still accepted
everywhere and are normalised through :func:`as_span` (which also gives dict
users the ``/``-span syntax inside string values, since ``/`` can never
appear in a key token).
"""

from __future__ import annotations

import itertools
import re
from typing import Iterable, Iterator, Mapping, Sequence

from .keys import Key

__all__ = [
    "Span",
    "ValuesSpan",
    "RangeSpan",
    "WildcardSpan",
    "WILDCARD",
    "as_span",
    "parse_span",
    "Request",
    "as_request",
    "RequestSyntaxError",
    "UnknownKeywordError",
]


class RequestSyntaxError(ValueError):
    """Malformed MARS request text (bad pair, empty span, broken range)."""


class UnknownKeywordError(KeyError):
    """A request names a keyword the schema does not define.

    Subclasses :class:`KeyError` so legacy callers catching that keep
    working; every request-validating path (``Schema.request_levels``, both
    backend catalogues, all three facades' ``list``) raises THIS type, so a
    bad keyword fails the same way everywhere instead of silently matching
    nothing on some paths.
    """

    def __init__(self, keywords: Sequence[str], schema_name: str):
        super().__init__(
            f"request keywords {sorted(keywords)} not in schema {schema_name}"
        )
        self.keywords = tuple(sorted(keywords))
        self.schema_name = schema_name


# ---------------------------------------------------------------------------
# Spans — the value side of a request pair
# ---------------------------------------------------------------------------

_KW_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


class Span:
    """One request value span.  Immutable; knows how to match, enumerate
    (when finite) and format itself."""

    __slots__ = ()

    def contains(self, value: str) -> bool:
        raise NotImplementedError

    def values(self) -> tuple[str, ...] | None:
        """The explicit values, or None when not enumerable (wildcard)."""
        raise NotImplementedError

    @property
    def is_wildcard(self) -> bool:
        return False

    @property
    def is_exact(self) -> bool:
        """True when the span IS its literal values (a plain value list).
        Ranges are enumerable but NOT exact: they match numerically
        (``06`` is inside ``0/to/12/by/6``), so only the catalogue can say
        which stored spellings they cover."""
        return False

    def format(self) -> str:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.format()!r})"


class ValuesSpan(Span):
    """An explicit value list: ``0/6/12`` (a single value is a 1-list)."""

    __slots__ = ("_values",)

    def __init__(self, values: Iterable[str]):
        vals = tuple(str(v) for v in values)
        if not vals:
            raise RequestSyntaxError("empty value span")
        self._values = vals

    def contains(self, value: str) -> bool:
        return value in self._values

    def values(self) -> tuple[str, ...]:
        return self._values

    @property
    def is_exact(self) -> bool:
        return True

    def format(self) -> str:
        return "/".join(self._values)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ValuesSpan) and other._values == self._values

    def __hash__(self) -> int:
        return hash(("values", self._values))


class RangeSpan(Span):
    """A numeric range ``start/to/stop[/by/step]``: matches numerically, so
    ``0/to/12/by/6`` contains ``"06"`` as well as ``"6"``; enumeration
    preserves the start token's zero-padding width."""

    __slots__ = ("start", "stop", "by", "_pad")

    def __init__(self, start: int, stop: int, by: int = 1, *, pad: int = 0):
        if by < 1:
            raise RequestSyntaxError(f"range step must be >= 1, got {by}")
        if stop < start:
            raise RequestSyntaxError(f"empty range {start}/to/{stop}")
        self.start = start
        self.stop = stop
        self.by = by
        self._pad = pad

    def contains(self, value: str) -> bool:
        try:
            v = int(value)
        except ValueError:
            return False
        return self.start <= v <= self.stop and (v - self.start) % self.by == 0

    def values(self) -> tuple[str, ...]:
        return tuple(
            str(v).zfill(self._pad) for v in range(self.start, self.stop + 1, self.by)
        )

    def format(self) -> str:
        s = f"{str(self.start).zfill(self._pad)}/to/{self.stop}"
        return s if self.by == 1 else f"{s}/by/{self.by}"

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, RangeSpan)
            and (other.start, other.stop, other.by) == (self.start, self.stop, self.by)
        )

    def __hash__(self) -> int:
        return hash(("range", self.start, self.stop, self.by))


class WildcardSpan(Span):
    """``*`` — matches every value of the keyword; not enumerable, so a
    wildcard request is always resolved against the catalogue."""

    __slots__ = ()

    def contains(self, value: str) -> bool:
        return True

    def values(self) -> None:
        return None

    @property
    def is_wildcard(self) -> bool:
        return True

    def format(self) -> str:
        return "*"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, WildcardSpan)

    def __hash__(self) -> int:
        return hash("wildcard")


WILDCARD = WildcardSpan()


def parse_span(text: str) -> Span:
    """Parse the value side of a request pair: ``*``, ``a/b/c`` or
    ``a/to/b[/by/c]`` (``to``/``by`` are case-insensitive, as in MARS)."""
    text = text.strip()
    if not text:
        raise RequestSyntaxError("empty value span")
    if text == "*":
        return WILDCARD
    toks = [t.strip() for t in text.split("/")]
    if any(not t for t in toks):
        raise RequestSyntaxError(f"empty value in span {text!r}")
    low = [t.lower() for t in toks]
    if len(toks) >= 2 and low[1] == "to":
        if len(toks) not in (3, 5) or (len(toks) == 5 and low[3] != "by"):
            raise RequestSyntaxError(
                f"malformed range {text!r} (expected start/to/stop[/by/step])"
            )
        try:
            start, stop = int(toks[0]), int(toks[2])
            by = int(toks[4]) if len(toks) == 5 else 1
        except ValueError as e:
            raise RequestSyntaxError(f"non-numeric range bound in {text!r}") from e
        pad = len(toks[0]) if toks[0].startswith("0") and len(toks[0]) > 1 else 0
        return RangeSpan(start, stop, by, pad=pad)
    return ValuesSpan(toks)


def as_span(value) -> Span:
    """Normalise any accepted request value into a Span.

    - Span           -> itself
    - str            -> parsed MARS span syntax (a plain value parses to a
                        single-value :class:`ValuesSpan`)
    - iterable       -> :class:`ValuesSpan` of its stringified elements
    """
    if isinstance(value, Span):
        return value
    if isinstance(value, str):
        return parse_span(value)
    if isinstance(value, Iterable):
        return ValuesSpan(value)
    return ValuesSpan([value])


# ---------------------------------------------------------------------------
# Request
# ---------------------------------------------------------------------------

_VERBS = ("retrieve", "archive", "list", "wipe", "read")


class Request(Mapping[str, Span]):
    """An ordered, immutable ``keyword -> Span`` mapping, optionally tagged
    with a MARS verb (``retrieve,step=0/6`` — the verb is carried and
    formatted back but does not affect matching)."""

    __slots__ = ("_spans", "verb")

    def __init__(
        self,
        spans: Mapping[str, object] | Iterable[tuple[str, object]] = (),
        *,
        verb: str | None = None,
        **kw: object,
    ):
        pairs: list[tuple[str, object]] = []
        if isinstance(spans, Mapping):
            pairs.extend(spans.items())
        else:
            pairs.extend(spans)
        pairs.extend(kw.items())
        out: dict[str, Span] = {}
        for k, v in pairs:
            k = str(k).strip().lower()
            if not _KW_RE.match(k):
                raise RequestSyntaxError(f"bad request keyword {k!r}")
            span = as_span(v)
            # a silently-dropped duplicate would make a retrieve/wipe act on
            # the wrong subset; identical repeats are harmless
            if k in out and out[k] != span:
                raise RequestSyntaxError(
                    f"conflicting spans for keyword {k!r}: "
                    f"{out[k].format()!r} vs {span.format()!r}"
                )
            out[k] = span
        self._spans: tuple[tuple[str, Span], ...] = tuple(out.items())
        self.verb = verb.lower() if verb else None

    # -- Mapping protocol ---------------------------------------------------
    def __getitem__(self, k: str) -> Span:
        for kk, vv in self._spans:
            if kk == k:
                return vv
        raise KeyError(k)

    def __iter__(self) -> Iterator[str]:
        return (k for k, _ in self._spans)

    def __len__(self) -> int:
        return len(self._spans)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Request):
            return dict(self._spans) == dict(other._spans) and self.verb == other.verb
        if isinstance(other, Mapping):
            try:
                return dict(self._spans) == {k: as_span(v) for k, v in other.items()}
            except (RequestSyntaxError, TypeError):
                return False
        return NotImplemented

    def __hash__(self) -> int:
        return hash((frozenset(self._spans), self.verb))

    def __repr__(self) -> str:
        return f"Request({self.format()!r})"

    # -- parse / format -----------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "Request":
        """Parse MARS request text: ``[verb,] kw=span, kw=span, ...``.
        Commas separate pairs; whitespace and newlines are insignificant."""
        parts = [p.strip() for p in text.split(",")]
        parts = [p for p in parts if p]
        verb = None
        if parts and "=" not in parts[0]:
            verb = parts[0].lower()
            if verb not in _VERBS:
                raise RequestSyntaxError(f"unknown request verb {parts[0]!r}")
            parts = parts[1:]
        pairs: list[tuple[str, Span]] = []
        for part in parts:
            if "=" not in part:
                raise RequestSyntaxError(f"malformed request pair {part!r}")
            k, _, v = part.partition("=")
            pairs.append((k.strip(), parse_span(v)))
        return cls(pairs, verb=verb)

    def format(self) -> str:
        """Canonical single-line MARS text; ``parse(format(r)) == r``."""
        pairs = ",".join(f"{k}={span.format()}" for k, span in self._spans)
        return f"{self.verb},{pairs}" if self.verb else pairs

    # -- semantics ----------------------------------------------------------
    def is_full(self, schema) -> bool:
        """True when every schema keyword is present with an enumerable span
        — exactly the requests :meth:`expand` can turn into identifiers."""
        return all(
            kw in self and self[kw].values() is not None for kw in schema.all_keys
        )

    def is_exact(self, schema) -> bool:
        """True when every schema keyword is present with an *exact* span
        (plain value lists, no ranges/wildcards) — the requests whose
        client-side expansion is guaranteed to agree with catalogue
        matching, spelling for spelling."""
        return all(kw in self and self[kw].is_exact for kw in schema.all_keys)

    def expand(self, schema) -> list[Key]:
        """The cartesian product of a fully-specified request, one full field
        identifier per combination, in schema keyword order (the classic
        MARS expansion).  Partial or wildcard requests cannot be expanded
        without a catalogue — retrieve them through
        :meth:`~repro.core.client.FDBClient.retrieve_many` instead."""
        unknown = set(self) - set(schema.all_keys)
        if unknown:
            raise UnknownKeywordError(unknown, schema.name)
        spans: list[list[tuple[str, str]]] = []
        for kw in schema.all_keys:
            if kw not in self:
                raise KeyError(
                    f"request missing schema keyword {kw!r} (schema {schema.name}); "
                    "partial requests expand via the catalogue (retrieve_many/list)"
                )
            vals = self[kw].values()
            if vals is None:
                raise ValueError(
                    f"cannot expand wildcard span for keyword {kw!r}; "
                    "wildcard requests resolve via the catalogue (retrieve_many/list)"
                )
            spans.append([(kw, v) for v in vals])
        return [Key(combo) for combo in itertools.product(*spans)]

    def matches(self, key: Key | Mapping[str, str]) -> bool:
        """True if every requested keyword is present in *key* with a value
        inside its span (the request side of :meth:`Key.matches`)."""
        for kw, span in self._spans:
            if kw not in key:
                return False
            if not span.contains(key[kw]):
                return False
        return True


def as_request(request) -> Request:
    """Normalise any accepted request form into a :class:`Request`:
    Request (as-is), MARS text, or a mapping with str/iterable/Span values
    (a :class:`Key` is a mapping, so keys are valid fully-specified
    requests)."""
    if isinstance(request, Request):
        return request
    if isinstance(request, str):
        return Request.parse(request)
    if request is None:
        return Request()
    if isinstance(request, Mapping):
        return Request(request)
    raise TypeError(f"cannot interpret {type(request).__name__} as a request")
