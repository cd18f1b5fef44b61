"""FDB schema — splits a full field identifier into the three sub-keys.

Paper §1.3: "The schema defines not only the valid field identifier keys and
values, but also how the FDB will internally split the identifiers provided
by the user processes into three sub-identifiers which control how the Store
backend lays out data in the storage system":

  (1) dataset key     — the dataset a field belongs to (e.g. one forecast run)
  (2) collocation key — fields sharing it should be collocated in storage
  (3) element key     — identifies the field within a collocated dataset

Paper §5.1 found that the *placement* of keywords between levels is a
performance knob: ``number``/``levelist`` at the collocation level is optimal
for the DAOS backend (each writer gets an exclusive index KV), while having
them at element level is best for POSIX (writers already keep private
indexes).  The schema is therefore configurable, and the two presets used in
the paper are provided.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

from .keys import Key

__all__ = [
    "Schema",
    "SplitKey",
    "NWP_SCHEMA_DAOS",
    "NWP_SCHEMA_POSIX",
    "CHECKPOINT_SCHEMA",
    "DATASET_SCHEMA",
]


@dataclass(frozen=True)
class SplitKey:
    dataset: Key
    collocation: Key
    element: Key

    def full(self) -> Key:
        from .keys import key_union

        return key_union(self.dataset, self.collocation, self.element)


@dataclass(frozen=True)
class Schema:
    """Keyword lists per level, plus optional value validators."""

    name: str
    dataset_keys: Sequence[str]
    collocation_keys: Sequence[str]
    element_keys: Sequence[str]
    # optional: keyword -> allowed values (None = any)
    values: Mapping[str, frozenset[str] | None] = field(default_factory=dict)

    @property
    def all_keys(self) -> tuple[str, ...]:
        return tuple(self.dataset_keys) + tuple(self.collocation_keys) + tuple(self.element_keys)

    def validate(self, key: Key) -> None:
        missing = [k for k in self.all_keys if k not in key]
        if missing:
            raise KeyError(f"identifier {key!r} missing schema keywords {missing} (schema {self.name})")
        extra = [k for k in key if k not in self.all_keys]
        if extra:
            raise KeyError(f"identifier {key!r} has keywords {extra} not in schema {self.name}")
        for k, allowed in self.values.items():
            if allowed is not None and k in key and key[k] not in allowed:
                raise ValueError(f"value {key[k]!r} not allowed for keyword {k!r} in schema {self.name}")

    def split(self, key: Key) -> SplitKey:
        self.validate(key)
        return SplitKey(
            dataset=key.subset(self.dataset_keys),
            collocation=key.subset(self.collocation_keys),
            element=key.subset(self.element_keys),
        )

    # -- destringify helpers (symmetric reconstruction, paper §3) -----------
    def dataset_from_string(self, s: str) -> Key:
        return Key.destringify(s, self.dataset_keys)

    def collocation_from_string(self, s: str) -> Key:
        return Key.destringify(s, self.collocation_keys)

    def element_from_string(self, s: str) -> Key:
        return Key.destringify(s, self.element_keys)

    def expand(self, request: Mapping[str, Iterable[str] | str]) -> list[Key]:
        """Deprecated: use :meth:`Request.expand(schema)
        <repro.core.request.Request.expand>` — the first-class request type
        also understands ranges and wildcards."""
        import warnings

        from .request import as_request

        warnings.warn(
            "Schema.expand(request) is deprecated; use "
            "Request.expand(schema) (repro.core.request)",
            DeprecationWarning,
            stacklevel=2,
        )
        # the old expand silently ignored extra keywords — a compat shim
        # must not be stricter than the API it shims
        known = {k: v for k, v in request.items() if k in self.all_keys}
        return as_request(known).expand(self)

    def request_levels(self, request: Mapping[str, Iterable[str] | str]):
        """Split a (possibly partial) request's keywords by level.  Unknown
        keywords raise :class:`~repro.core.request.UnknownKeywordError` —
        the one rejection path every facade and backend shares."""
        from .request import UnknownKeywordError

        unknown = set(request) - set(self.all_keys)
        if unknown:
            raise UnknownKeywordError(unknown, self.name)
        ds = {k: v for k, v in request.items() if k in self.dataset_keys}
        co = {k: v for k, v in request.items() if k in self.collocation_keys}
        el = {k: v for k, v in request.items() if k in self.element_keys}
        return ds, co, el


# ---------------------------------------------------------------------------
# The two NWP schema presets from the paper (§5.1, Fig. 2).
# ---------------------------------------------------------------------------

#: DAOS-optimal: number/levelist at the *collocation* level → each writer
#: process owns an exclusive index KV, minimising index contention.
NWP_SCHEMA_DAOS = Schema(
    name="nwp-daos",
    dataset_keys=("class", "stream", "expver", "date", "time"),
    collocation_keys=("type", "levtype", "number", "levelist"),
    element_keys=("step", "param"),
)

#: POSIX-optimal: number/levelist at the *element* level (writers already
#: keep independent per-process indexes in the POSIX backend).
NWP_SCHEMA_POSIX = Schema(
    name="nwp-posix",
    dataset_keys=("class", "stream", "expver", "date", "time"),
    collocation_keys=("type", "levtype"),
    element_keys=("step", "param", "number", "levelist"),
)

#: Checkpoint plane of the training framework: one dataset per run, one
#: collocation per (step, host-group), elements are parameter shards.  The
#: writer-exclusive collocation mirrors the paper's DAOS-optimal layout.
CHECKPOINT_SCHEMA = Schema(
    name="checkpoint",
    dataset_keys=("run", "kind"),
    collocation_keys=("step", "writer"),
    element_keys=("param", "shard"),
)

#: Data pipeline plane: training shards.
DATASET_SCHEMA = Schema(
    name="dataset",
    dataset_keys=("corpus", "split"),
    collocation_keys=("epoch", "producer"),
    element_keys=("batch", "part"),
)
