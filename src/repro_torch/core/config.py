"""Declarative FDB configuration — compose any FDB tree from plain data.

The paper's FDB is never instantiated by hand in production: ECMWF composes
it from a configuration tree that selects among backends (``local`` /
``select`` / ``dist``) — that is exactly how the operational hot FDB on NVM
coexists with the cold parallel-filesystem archive (§1.3).  This module is
that layer for the reproduction: one :func:`build_fdb` entry point that
turns a plain dict (JSON round-trippable via :class:`FDBConfig`) into any
composition of the four facades, nested arbitrarily:

``{"type": "local", "backend": "posix"|"daos", "schema": ..., ...}``
    one (Catalogue, Store) pair behind a plain :class:`~repro.core.fdb.FDB`.
    ``schema`` is a registered name (``"nwp-daos"``), an inline spec dict,
    or a :class:`Schema` instance; remaining keys are backend params
    (``root``, ``engine``, ``pool``, ``stats``, ``contention``, ...).
    ``"type"`` may be omitted when ``"backend"`` is present.

``{"type": "select", "rules": [{"match": "class=od,stream=oper",
"fdb": {...}, "name": "hot"}, ...], "default": {...}}``
    a :class:`~repro.core.select.SelectFDB` routing every operation by
    first-matching metadata rule — the paper's tiered hot/cold deployment.
    The optional ``name`` labels the tier; lifecycle policies reference
    tiers by these labels (unnamed tiers get ``tierN``/``default``).

``{"type": "dist", "lanes": [{...}, ...]}`` — or
``{"type": "dist", "template": {...}, "n_lanes": N}``
    an :class:`~repro.core.router.FDBRouter` hash-sharding datasets across
    the lanes; the template form substitutes ``{lane}`` in every string
    param (e.g. ``"root": "/data/lane{lane}"``).

``{"type": "async", "inner": {...}, "writers": 4, ...}``
    an :class:`~repro.core.async_fdb.AsyncFDB` wrapping the inner tree
    (owned: closing the facade closes the tree it built).

``{"type": "codec", "nbits": 16, "inner": {...}}``
    a :class:`~repro.core.codec.CodecFDB` tier: ``archive_fields`` packs at
    ``nbits`` (GRIB simple packing through the Pallas kernels) before the
    inner tree's store write, ``retrieve_fields`` decodes the
    self-describing payloads lazily — a hot DAOS tier can pack at 16 bits
    while the cold POSIX archive keeps 24, declaratively per tier.

``{"type": "cache", "max_bytes": N, "ttl_s": S, "inner": {...}}``
    a :class:`~repro.cache.CacheFDB` read-through dissemination tier:
    consistent-hash sharded in-memory chunk cache (LRU by byte budget,
    per-dataset TTL via ``dataset_ttl: [{"match": ..., "ttl_s": ...}]``,
    layout knobs ``shards``/``replicas``) with single-flight coalescing —
    N concurrent identical retrieves cost one inner round — and write-path
    invalidation on ``archive``/``archive_fields``/``wipe``.  Composes
    above select/codec/async/remote unchanged.

``{"type": "lifecycle", "policies": [{"from": "hot", "to": "cold",
"max_age_s": 30, "match": "step=0/to/5"}, ...], "inner": {...}}``
    a :class:`~repro.lifecycle.LifecycleFDB` data-lifecycle engine over the
    SelectFDB found in the inner tree: declarative demotion (age / ``step``
    fragment / access count) and promotion-on-access policies drive online
    batched tier migration through a pin/copy/flip/remove protocol on the
    select placement overlay, so concurrent readers always hit exactly one
    copy.  Optional ``batch_size``.  Composes under cache (moved keys are
    invalidated) and above async/codec/remote tiers unchanged.

Any node may additionally carry ``"trace": true`` (or a mapping with
``capacity`` / ``slow_op_s`` / ``slow_capacity``): a
:class:`~repro.obs.Tracer` is built and installed on the whole subtree via
:func:`~repro.obs.install_tracer`, reachable afterwards as
``client.tracer``.  In practice it sits at the root, tracing the entire
composition.

``{"type": "remote", "addr": "host:port"}`` — or
``{"type": "remote", "inner": {...}}``
    a :class:`~repro.core.remote.RemoteFDB` reaching an FDB served in
    another process over the wire protocol (the paper's compute-node /
    storage-node split).  The ``addr`` form connects to a running
    :class:`~repro.core.remote.FDBServer`; the ``inner`` form builds the
    inner tree, serves it on a loopback socket in-process and owns both —
    the whole composition grammar works on either side of the wire.
    Optional transport knobs: ``pool_size``, ``timeout``, ``retries``,
    ``backoff``.

Backends are pluggable: :func:`register_backend` maps a name to a
``(catalogue_factory, store_factory)`` pair, so tests can register
in-memory or fault-injecting backends and route to them from config without
touching this module.  ``make_fdb``/``make_router`` are thin shims over
:func:`build_fdb`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Iterator, Mapping, Sequence

from .catalogue import Catalogue
from .client import FDBClient
from .schema import (
    CHECKPOINT_SCHEMA,
    DATASET_SCHEMA,
    NWP_SCHEMA_DAOS,
    NWP_SCHEMA_POSIX,
    Schema,
)
from .store import Store

__all__ = [
    "ConfigError",
    "FDBConfig",
    "build_fdb",
    "register_backend",
    "registered_backends",
    "register_schema",
    "schema_from_config",
    "schema_to_config",
]


class ConfigError(ValueError):
    """A config tree that cannot be validated, built, or serialised."""


# ---------------------------------------------------------------------------
# Schema registry — lets configs name schemas instead of embedding them
# ---------------------------------------------------------------------------

_SCHEMAS: dict[str, Schema] = {}


def register_schema(schema: Schema, *, overwrite: bool = False) -> Schema:
    """Make ``schema`` referencable from configs by its ``name``."""
    if not overwrite and _SCHEMAS.get(schema.name, schema) != schema:
        raise ConfigError(
            f"schema {schema.name!r} already registered with a different "
            "definition (pass overwrite=True to replace)"
        )
    _SCHEMAS[schema.name] = schema
    return schema


for _s in (NWP_SCHEMA_DAOS, NWP_SCHEMA_POSIX, CHECKPOINT_SCHEMA, DATASET_SCHEMA):
    register_schema(_s)


def schema_from_config(spec) -> Schema:
    """Resolve a config schema spec: a registered name, an inline
    ``{"name", "dataset_keys", "collocation_keys", "element_keys"[, "values"]}``
    dict, or a :class:`Schema` instance."""
    if isinstance(spec, Schema):
        return spec
    if isinstance(spec, str):
        try:
            return _SCHEMAS[spec]
        except KeyError:
            raise ConfigError(
                f"unknown schema {spec!r} (registered: {sorted(_SCHEMAS)})"
            ) from None
    if isinstance(spec, Mapping):
        try:
            return Schema(
                name=spec["name"],
                dataset_keys=tuple(spec["dataset_keys"]),
                collocation_keys=tuple(spec["collocation_keys"]),
                element_keys=tuple(spec["element_keys"]),
                values={
                    k: (None if v is None else frozenset(str(x) for x in v))
                    for k, v in spec.get("values", {}).items()
                },
            )
        except KeyError as e:
            raise ConfigError(f"inline schema spec missing field {e}") from None
    raise ConfigError(f"cannot interpret {type(spec).__name__} as a schema spec")


def schema_to_config(schema: Schema):
    """The JSON-able form of a schema: its registered name when that resolves
    back to the same schema, else the inline spec dict."""
    if _SCHEMAS.get(schema.name) == schema:
        return schema.name
    spec = {
        "name": schema.name,
        "dataset_keys": list(schema.dataset_keys),
        "collocation_keys": list(schema.collocation_keys),
        "element_keys": list(schema.element_keys),
    }
    if schema.values:
        spec["values"] = {
            k: (None if v is None else sorted(v)) for k, v in schema.values.items()
        }
    return spec


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------

#: a factory receives the resolved schema and the local config's params dict
CatalogueFactory = Callable[[Schema, dict], Catalogue]
StoreFactory = Callable[[Schema, dict], Store]


@dataclass(frozen=True)
class BackendSpec:
    name: str
    catalogue_factory: CatalogueFactory
    store_factory: StoreFactory
    #: optional params normaliser, run once before both factories — validate,
    #: fill defaults, materialise shared resources (e.g. one DAOS engine that
    #: both factories must receive)
    prepare: Callable[[dict], dict] | None = None
    #: schema used when the config omits one
    default_schema: Schema | None = None


_BACKENDS: dict[str, BackendSpec] = {}


def register_backend(
    name: str,
    catalogue_factory: CatalogueFactory,
    store_factory: StoreFactory,
    *,
    prepare: Callable[[dict], dict] | None = None,
    default_schema: Schema | None = None,
    overwrite: bool = False,
) -> None:
    """Register a named (Catalogue, Store) backend pair for ``local``
    configs.  Each factory is called as ``factory(schema, params)`` where
    ``params`` is the config dict minus ``type``/``backend``/``schema``."""
    if name in _BACKENDS and not overwrite:
        raise ConfigError(
            f"backend {name!r} already registered (pass overwrite=True to replace)"
        )
    _BACKENDS[name] = BackendSpec(
        name, catalogue_factory, store_factory, prepare, default_schema
    )


def registered_backends() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


# -- the two paper backends register themselves -----------------------------

def _posix_prepare(params: dict) -> dict:
    if params.get("root") is None:
        raise ConfigError("posix backend requires root=")
    if params.get("stats") is None:
        from .posix import PosixStats

        # one fresh sink per tier, shared by its catalogue + store: several
        # posix tiers in one config tree must not all funnel into the
        # process-global POSIX_STATS, or every per-tier breakdown
        # (SelectFDB/FDBRouter stats_snapshot) would show the same merged
        # traffic (make_fdb passes POSIX_STATS explicitly to keep its
        # documented process-global default)
        params["stats"] = PosixStats(name=f"posix:{params['root']}")
    return params


def _posix_catalogue(schema: Schema, params: dict) -> Catalogue:
    from .posix import PosixCatalogue

    return PosixCatalogue(
        params["root"], schema,
        stats=params.get("stats"), contention=params.get("contention"),
    )


def _posix_store(schema: Schema, params: dict) -> Store:
    from .posix import PosixStore

    extra = {k: v for k, v in params.items() if k not in ("root", "stats", "contention")}
    return PosixStore(
        params["root"],
        stats=params.get("stats"), contention=params.get("contention"), **extra,
    )


def _daos_prepare(params: dict) -> dict:
    if params.get("stats") is not None:
        raise ConfigError(
            "daos backend does not take stats= (engine.stats is the telemetry sink)"
        )
    params.pop("stats", None)
    engine = params.get("engine")
    contention = params.pop("contention", None)
    if engine is None:
        from .daos import DaosEngine

        engine = DaosEngine(contention=contention)
    elif contention is not None:
        # the engine is caller-owned: attach a model where there is none,
        # but never silently replace one already wired into its accounting
        if engine.contention is None:
            engine.contention = contention
        elif engine.contention is not contention:
            raise ConfigError(
                "conflicting contention models: the engine already carries one; "
                "pass either engine= (with its model) or contention=, not two "
                "different models"
            )
    params["engine"] = engine
    return params


def _daos_catalogue(schema: Schema, params: dict) -> Catalogue:
    from .daos_backend import DaosCatalogue

    return DaosCatalogue(params["engine"], schema, pool=params.get("pool", "fdb"))


def _daos_store(schema: Schema, params: dict) -> Store:
    from .daos_backend import DaosStore

    extra = {k: v for k, v in params.items() if k not in ("engine", "pool")}
    return DaosStore(params["engine"], pool=params.get("pool", "fdb"), **extra)


register_backend(
    "posix", _posix_catalogue, _posix_store,
    prepare=_posix_prepare, default_schema=NWP_SCHEMA_POSIX,
)
register_backend(
    "daos", _daos_catalogue, _daos_store,
    prepare=_daos_prepare, default_schema=NWP_SCHEMA_DAOS,
)


# ---------------------------------------------------------------------------
# Validation + JSON round-trip
# ---------------------------------------------------------------------------

_TYPES = ("local", "select", "dist", "async", "codec", "remote", "cache", "lifecycle")


def _config_type(cfg: Mapping) -> str:
    t = cfg.get("type")
    if t is None and "backend" in cfg:
        return "local"  # shorthand: {"backend": "posix", ...}
    if t not in _TYPES:
        raise ConfigError(
            f"unknown FDB config type {t!r} (expected one of {_TYPES}, "
            "or a 'backend' key for the local shorthand)"
        )
    return t


def _validate_trace(spec) -> None:
    if spec is None or isinstance(spec, bool):
        return
    if isinstance(spec, Mapping):
        allowed = {"capacity", "slow_op_s", "slow_capacity", "proc"}
        unknown = set(spec) - allowed
        if unknown:
            raise ConfigError(
                f"unknown trace option(s) {sorted(unknown)} "
                f"(expected a subset of {sorted(allowed)})"
            )
        for k in ("capacity", "slow_capacity"):
            v = spec.get(k)
            if v is not None and (not isinstance(v, int) or isinstance(v, bool) or v < 1):
                raise ConfigError(f"trace {k!r} must be a positive int, got {v!r}")
        v = spec.get("slow_op_s")
        if v is not None and (not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0):
            raise ConfigError(f"trace 'slow_op_s' must be a non-negative number, got {v!r}")
        return
    raise ConfigError(
        f"trace must be a bool or an options mapping, got {type(spec).__name__}"
    )


def validate_config(config: Mapping) -> None:
    """Structural validation of a config tree, without building anything —
    unknown types, missing required fields and malformed rules all raise
    :class:`ConfigError` here, not halfway through construction."""
    if isinstance(config, FDBClient):
        return  # an already-built client is a valid (programmatic) leaf
    if not isinstance(config, Mapping):
        raise ConfigError(f"config must be a mapping, got {type(config).__name__}")
    _validate_trace(config.get("trace"))
    t = _config_type(config)
    if t == "local":
        if not config.get("backend"):
            raise ConfigError("local config requires 'backend'")
    elif t == "select":
        rules = config.get("rules", ())
        if not isinstance(rules, (list, tuple)):
            raise ConfigError("select 'rules' must be a list")
        for rule in rules:
            if not isinstance(rule, Mapping) or "match" not in rule or "fdb" not in rule:
                raise ConfigError("each select rule needs 'match' and 'fdb'")
            name = rule.get("name")
            if name is not None and not isinstance(name, str):
                raise ConfigError(f"select rule 'name' must be a string, got {name!r}")
            validate_config(rule["fdb"])
        if not rules and config.get("default") is None:
            raise ConfigError("select config needs 'rules' and/or 'default'")
        if config.get("default") is not None:
            validate_config(config["default"])
    elif t == "dist":
        lanes = config.get("lanes")
        if lanes is not None:
            if not isinstance(lanes, (list, tuple)) or not lanes:
                raise ConfigError("dist 'lanes' must be a non-empty list")
            for lane in lanes:
                validate_config(lane)
        else:
            template, n = config.get("template"), config.get("n_lanes")
            if template is None or n is None:
                raise ConfigError("dist config needs 'lanes' or 'template' + 'n_lanes'")
            if not isinstance(n, int) or n < 1:
                raise ConfigError(f"dist n_lanes must be a positive int, got {n!r}")
            validate_config(template)
    elif t == "async":
        if config.get("inner") is None:
            raise ConfigError("async config requires 'inner'")
        validate_config(config["inner"])
    elif t == "codec":
        if config.get("inner") is None:
            raise ConfigError("codec config requires 'inner'")
        nbits = config.get("nbits", 16)
        if not isinstance(nbits, int) or not 1 <= nbits <= 32:
            raise ConfigError(
                f"codec nbits must be an int in [1, 32], got {nbits!r}"
            )
        validate_config(config["inner"])
    elif t == "cache":
        if config.get("inner") is None:
            raise ConfigError("cache config requires 'inner'")
        mb = config.get("max_bytes")
        if mb is not None and (not isinstance(mb, int) or isinstance(mb, bool) or mb < 1):
            raise ConfigError(f"cache max_bytes must be a positive int, got {mb!r}")
        for knob in ("shards", "replicas"):
            v = config.get(knob)
            if v is not None and (not isinstance(v, int) or isinstance(v, bool) or v < 1):
                raise ConfigError(f"cache {knob!r} must be a positive int, got {v!r}")
        ttl = config.get("ttl_s")
        if ttl is not None and (not isinstance(ttl, (int, float)) or isinstance(ttl, bool) or ttl < 0):
            raise ConfigError(f"cache ttl_s must be a non-negative number, got {ttl!r}")
        neg = config.get("negative_ttl")
        if neg is not None and (not isinstance(neg, (int, float)) or isinstance(neg, bool) or neg < 0):
            raise ConfigError(f"cache negative_ttl must be a non-negative number, got {neg!r}")
        rules = config.get("dataset_ttl", ())
        if not isinstance(rules, (list, tuple)):
            raise ConfigError("cache 'dataset_ttl' must be a list")
        for rule in rules:
            if not isinstance(rule, Mapping) or "match" not in rule or "ttl_s" not in rule:
                raise ConfigError("each cache dataset_ttl rule needs 'match' and 'ttl_s'")
        validate_config(config["inner"])
    elif t == "lifecycle":
        if config.get("inner") is None:
            raise ConfigError("lifecycle config requires 'inner'")
        policies = config.get("policies")
        if not isinstance(policies, (list, tuple)) or not policies:
            raise ConfigError("lifecycle config needs a non-empty 'policies' list")
        from ..lifecycle.policy import LifecyclePolicy

        for p in policies:
            try:
                LifecyclePolicy.from_dict(p)
            except ValueError as e:
                raise ConfigError(str(e)) from None
        bs = config.get("batch_size")
        if bs is not None and (not isinstance(bs, int) or isinstance(bs, bool) or bs < 1):
            raise ConfigError(f"lifecycle batch_size must be a positive int, got {bs!r}")
        validate_config(config["inner"])
    elif t == "remote":
        addr, inner = config.get("addr"), config.get("inner")
        if (addr is None) == (inner is None):
            raise ConfigError(
                "remote config requires exactly one of 'addr' (connect to a "
                "running server) or 'inner' (serve the inner tree in-process)"
            )
        if inner is not None:
            validate_config(inner)
        for knob, kind in (("pool_size", int), ("retries", int),
                           ("timeout", (int, float)), ("backoff", (int, float))):
            v = config.get(knob)
            if v is not None and (not isinstance(v, kind) or isinstance(v, bool)):
                raise ConfigError(f"remote {knob!r} must be a number, got {v!r}")


def _jsonable(obj, path: str = "$"):
    """Deep-convert a config tree into plain JSON types; Schemas serialise
    through :func:`schema_to_config`, live objects (engines, stats sinks,
    contention models) are rejected — they are not declarative."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, Schema):
        return schema_to_config(obj)
    if isinstance(obj, Mapping):
        return {str(k): _jsonable(v, f"{path}.{k}") for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v, f"{path}[{i}]") for i, v in enumerate(obj)]
    raise ConfigError(
        f"config value at {path} ({type(obj).__name__}) is not JSON-serialisable — "
        "replace live objects (engines, stats, contention models) with "
        "config-expressible parameters"
    )


def _copy_tree(obj):
    """Copy a config tree's container structure (dicts/lists), sharing the
    leaves — later caller mutation of a nested list/dict cannot reach the
    copy, while live leaf objects (engines, prebuilt clients) stay shared
    rather than being deep-copied into useless clones."""
    if isinstance(obj, Mapping):
        return {k: _copy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_copy_tree(v) for v in obj]
    return obj


class FDBConfig(Mapping):
    """A validated, immutable FDB config tree.

    Plain dicts work everywhere an FDBConfig does (``build_fdb`` takes
    either); this wrapper adds eager structural validation and the JSON
    round-trip (:meth:`to_json` / :meth:`from_json` / :meth:`from_file`).
    The tree is copied on construction (containers, not leaves), so
    mutating the source dict afterwards cannot invalidate it.
    """

    __slots__ = ("_cfg",)

    def __init__(self, config: Mapping):
        if isinstance(config, FDBConfig):
            config = config._cfg
        validate_config(config)
        self._cfg = _copy_tree(config)

    # -- Mapping protocol ---------------------------------------------------
    def __getitem__(self, k: str):
        return self._cfg[k]

    def __iter__(self) -> Iterator[str]:
        return iter(self._cfg)

    def __len__(self) -> int:
        return len(self._cfg)

    def __repr__(self) -> str:
        return f"FDBConfig({self._cfg!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, FDBConfig):
            return self._cfg == other._cfg
        if isinstance(other, Mapping):
            return self._cfg == dict(other)
        return NotImplemented

    # -- round-trip ---------------------------------------------------------
    def to_dict(self) -> dict:
        """The plain-JSON-types form of this config (deep copy)."""
        return _jsonable(self._cfg)

    def to_json(self, *, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=False)

    @classmethod
    def from_json(cls, text: str) -> "FDBConfig":
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise ConfigError(f"malformed config JSON: {e}") from e
        return cls(data)

    @classmethod
    def from_file(cls, path: str) -> "FDBConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- construction -------------------------------------------------------
    def build(self) -> FDBClient:
        return build_fdb(self._cfg)


# ---------------------------------------------------------------------------
# build_fdb — the one entry point
# ---------------------------------------------------------------------------

def build_fdb(config: Mapping) -> FDBClient:
    """Construct the FDB composition tree a config describes (see module
    docstring for the grammar).  Accepts a plain dict or an
    :class:`FDBConfig`; returns the root :class:`FDBClient` — closing it
    closes everything the config built.  An already-built
    :class:`FDBClient` is accepted anywhere a subtree is expected (e.g. an
    existing FDB as an ``async`` inner or a ``select`` tier); it passes
    through unchanged and stays caller-owned — closing the built tree
    flushes it but leaves it open."""
    if isinstance(config, FDBClient):
        return config
    if isinstance(config, FDBConfig):
        config = dict(config)
    validate_config(config)
    trace_spec = config.get("trace") if isinstance(config, Mapping) else None
    if trace_spec is not None:
        # strip before dispatch — a local node would otherwise hand "trace"
        # to the backend factories as an unknown param
        config = {k: v for k, v in config.items() if k != "trace"}
        client = build_fdb(config)
        if trace_spec:
            from ..obs.tracer import install_tracer, make_tracer

            install_tracer(client, make_tracer(trace_spec))
        return client
    t = _config_type(config)
    if t == "local":
        return _build_local(config)
    if t == "select":
        return _build_select(config)
    if t == "dist":
        return _build_dist(config)
    if t == "codec":
        return _build_codec(config)
    if t == "remote":
        return _build_remote(config)
    if t == "cache":
        return _build_cache(config)
    if t == "lifecycle":
        return _build_lifecycle(config)
    return _build_async(config)


def _build_local(cfg: Mapping) -> FDBClient:
    name = cfg["backend"]
    spec = _BACKENDS.get(name)
    if spec is None:
        raise ConfigError(
            f"unknown FDB backend {name!r} (registered: {list(registered_backends())})"
        )
    schema_spec = cfg.get("schema", spec.default_schema)
    if schema_spec is None:
        raise ConfigError(f"backend {name!r} config requires 'schema'")
    schema = schema_from_config(schema_spec)
    params = {k: v for k, v in cfg.items() if k not in ("type", "backend", "schema")}
    if spec.prepare is not None:
        params = spec.prepare(params)
    from .fdb import FDB

    return FDB(spec.catalogue_factory(schema, params), spec.store_factory(schema, params))


def _close_built(cfgs: Sequence, clients: Sequence[FDBClient]) -> None:
    """Close the clients a failed composite build constructed so far.
    Prebuilt pass-through subtrees stay open (the caller owns them); close
    errors are suppressed — the original failure is the one to surface."""
    for sub_cfg, client in zip(cfgs, clients):
        if not isinstance(sub_cfg, FDBClient):
            try:
                client.close()
            except Exception:  # noqa: BLE001
                pass


def _build_subtrees(cfgs: Sequence) -> list[FDBClient]:
    """Build each subtree in order; a failure closes the ones already built
    before re-raising, so a half-constructed composite never leaks stores."""
    built: list[FDBClient] = []
    try:
        for sub_cfg in cfgs:
            built.append(build_fdb(sub_cfg))
    except BaseException:
        _close_built(cfgs, built)
        raise
    return built


def _build_select(cfg: Mapping) -> FDBClient:
    from .select import SelectFDB

    rule_cfgs = list(cfg.get("rules", ()))
    sub_cfgs = [rule["fdb"] for rule in rule_cfgs]
    default_cfg = cfg.get("default")
    if default_cfg is not None:
        sub_cfgs.append(default_cfg)
    clients = _build_subtrees(sub_cfgs)
    try:
        default = clients[-1] if default_cfg is not None else None
        return SelectFDB(
            [(rule["match"], c, rule.get("name")) for rule, c in zip(rule_cfgs, clients)],
            default=default,
            shared=[c for sub, c in zip(sub_cfgs, clients)
                    if isinstance(sub, FDBClient)],
        )
    except BaseException:
        # SelectFDB's own validation (schema compatibility, dead rules)
        # failed after every tier was built: release them
        _close_built(sub_cfgs, clients)
        raise


def _substitute_lane(obj, lane: int):
    """Deep-copy a dist template, substituting ``{lane}`` in string values
    (``root``/``pool``/stats names) so each lane gets distinct resources."""
    if isinstance(obj, str):
        return obj.replace("{lane}", str(lane))
    if isinstance(obj, Mapping):
        return {k: _substitute_lane(v, lane) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_substitute_lane(v, lane) for v in obj]
    return obj


def _build_dist(cfg: Mapping) -> FDBClient:
    from .router import FDBRouter

    lanes_cfg = cfg.get("lanes")
    if lanes_cfg is None:
        lanes_cfg = [
            _substitute_lane(cfg["template"], i) for i in range(cfg["n_lanes"])
        ]
    lanes = _build_subtrees(lanes_cfg)
    try:
        return FDBRouter(
            lanes,
            shared=[lane for sub, lane in zip(lanes_cfg, lanes)
                    if isinstance(sub, FDBClient)],
        )
    except BaseException:
        _close_built(lanes_cfg, lanes)
        raise


def _build_codec(cfg: Mapping) -> FDBClient:
    from .codec import CodecFDB

    inner_cfg = cfg["inner"]
    inner = build_fdb(inner_cfg)
    try:
        # same ownership rule as async: the tier owns what the config built
        # beneath it; a prebuilt pass-through inner stays caller-owned
        owns = cfg.get("owns_inner", not isinstance(inner_cfg, FDBClient))
        return CodecFDB(inner, nbits=cfg.get("nbits", 16), owns_inner=owns)
    except BaseException:
        _close_built([inner_cfg], [inner])
        raise


def _build_cache(cfg: Mapping) -> FDBClient:
    from ..cache import CacheFDB

    inner_cfg = cfg["inner"]
    inner = build_fdb(inner_cfg)
    try:
        kw = {
            k: cfg[k]
            for k in ("max_bytes", "ttl_s", "dataset_ttl", "shards", "replicas", "negative_ttl")
            if k in cfg
        }
        # same ownership rule as async/codec: the tier owns what the config
        # built beneath it; a prebuilt pass-through inner stays caller-owned
        owns = cfg.get("owns_inner", not isinstance(inner_cfg, FDBClient))
        return CacheFDB(inner, owns_inner=owns, **kw)
    except BaseException:
        _close_built([inner_cfg], [inner])
        raise


def _build_lifecycle(cfg: Mapping) -> FDBClient:
    from ..lifecycle import LifecycleFDB

    inner_cfg = cfg["inner"]
    inner = build_fdb(inner_cfg)
    try:
        kw = {k: cfg[k] for k in ("batch_size",) if k in cfg}
        # same ownership rule as async/codec/cache
        owns = cfg.get("owns_inner", not isinstance(inner_cfg, FDBClient))
        return LifecycleFDB(inner, cfg["policies"], owns_inner=owns, **kw)
    except BaseException:
        _close_built([inner_cfg], [inner])
        raise


def _build_remote(cfg: Mapping) -> FDBClient:
    from .remote import FDBServer, RemoteFDB

    kw = {
        k: cfg[k]
        for k in ("pool_size", "timeout", "retries", "backoff")
        if k in cfg
    }
    if cfg.get("addr") is not None:
        return RemoteFDB(cfg["addr"], **kw)
    # self-hosted: build the inner tree, serve it on a loopback socket and
    # hand the server to the client — one close() tears everything down.
    # A prebuilt pass-through inner stays caller-owned (the server flushes
    # it on stop but does not close it), same rule as async/codec tiers.
    inner_cfg = cfg["inner"]
    inner = build_fdb(inner_cfg)
    server = None
    try:
        owns = cfg.get("owns_inner", not isinstance(inner_cfg, FDBClient))
        server = FDBServer(
            inner,
            host=cfg.get("host", "127.0.0.1"),
            port=cfg.get("port", 0),
            owns_fdb=owns,
        )
        server.start()
        return RemoteFDB(server=server, **kw)
    except BaseException:
        if server is not None:
            server._owns_fdb = False  # close the inner exactly once, below
            server.stop()
        _close_built([inner_cfg], [inner])
        raise


def _build_async(cfg: Mapping) -> FDBClient:
    from .async_fdb import AsyncFDB

    kw = {
        k: cfg[k]
        for k in ("writers", "batch_size", "queue_depth", "readers", "read_batch_size")
        if k in cfg
    }
    inner_cfg = cfg["inner"]
    inner = build_fdb(inner_cfg)
    try:
        # the facade owns what the config built beneath it, so one close()
        # tears down the whole tree; a prebuilt pass-through inner stays
        # caller-owned (owns_inner overrides either way)
        owns = cfg.get("owns_inner", not isinstance(inner_cfg, FDBClient))
        return AsyncFDB(inner, owns_fdb=owns, **kw)
    except BaseException:
        _close_built([inner_cfg], [inner])
        raise
