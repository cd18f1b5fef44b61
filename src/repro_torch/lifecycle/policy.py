"""Declarative lifecycle policies: who moves where, and when.

A policy names a source and destination tier (the ``name`` labels of the
SelectFDB rules underneath) and the condition that triggers the move:

- **demotion** (background): fields older than ``max_age_s`` — age on
  whatever clock the engine was given, virtual in the discrete-event
  sweeps, monotonic wall time otherwise — and/or fields read at most
  ``max_accesses`` times, optionally restricted to a MARS fragment
  (``step=0/to/5`` — exactly the "old forecast steps drain to the cold
  archive" story);
- **promotion** (on access): a field read ``promote_after`` or more times
  while sitting on the source tier is queued for migration to the hot
  tier at the next engine cycle.

Conditions compose with AND; a policy with no condition at all is
rejected (it would migrate everything on every scan).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

from ..core.keys import Key
from ..core.request import Request, as_request

__all__ = ["LifecyclePolicy"]


@dataclass(frozen=True)
class LifecyclePolicy:
    from_tier: str
    to_tier: str
    name: str = ""
    #: MARS fragment the field must match (None = any field on from_tier)
    match: Request | None = None
    #: demote: minimum age (engine-clock seconds) before the field may move
    max_age_s: float | None = None
    #: demote: only move fields accessed at most this many times
    max_accesses: int | None = None
    #: promote: queue the field after this many accesses on from_tier
    promote_after: int | None = field(default=None)

    def __post_init__(self):
        if self.from_tier == self.to_tier:
            raise ValueError(f"policy {self.name!r}: from_tier == to_tier ({self.from_tier!r})")
        if self.promote_after is not None:
            if self.promote_after < 1:
                raise ValueError(f"policy {self.name!r}: promote_after must be >= 1")
            if self.max_age_s is not None or self.max_accesses is not None:
                raise ValueError(
                    f"policy {self.name!r}: promote_after excludes max_age_s/max_accesses"
                )
        elif self.max_age_s is None and self.max_accesses is None:
            raise ValueError(
                f"policy {self.name!r}: needs a condition "
                "(max_age_s, max_accesses, or promote_after)"
            )
        if self.max_age_s is not None and self.max_age_s < 0:
            raise ValueError(f"policy {self.name!r}: max_age_s must be >= 0")

    @property
    def kind(self) -> str:
        return "promote" if self.promote_after is not None else "demote"

    def applies(self, key: Key) -> bool:
        return self.match is None or self.match.matches(key)

    def due(self, *, age_s: float, accesses: int) -> bool:
        """Demotion condition for one field (promotion is event-driven —
        the engine checks ``promote_after`` at access time, not here)."""
        if self.kind != "demote":
            return False
        if self.max_age_s is not None and age_s < self.max_age_s:
            return False
        if self.max_accesses is not None and accesses > self.max_accesses:
            return False
        return True

    @classmethod
    def from_dict(cls, cfg: Mapping) -> "LifecyclePolicy":
        """Build from a config mapping (the ``policies`` list of a
        ``{"type": "lifecycle"}`` node).  ``from``/``to`` are accepted as
        spellings of ``from_tier``/``to_tier``."""
        if not isinstance(cfg, Mapping):
            raise ValueError(f"lifecycle policy must be a mapping, got {type(cfg).__name__}")
        known = {
            "name", "from", "to", "from_tier", "to_tier",
            "match", "max_age_s", "max_accesses", "promote_after",
        }
        unknown = set(cfg) - known
        if unknown:
            raise ValueError(f"lifecycle policy has unknown options {sorted(unknown)}")
        from_tier = cfg.get("from_tier", cfg.get("from"))
        to_tier = cfg.get("to_tier", cfg.get("to"))
        if not from_tier or not to_tier:
            raise ValueError("lifecycle policy needs 'from' and 'to' tier names")
        match = cfg.get("match")
        return cls(
            from_tier=str(from_tier),
            to_tier=str(to_tier),
            name=str(cfg.get("name", f"{from_tier}->{to_tier}")),
            match=None if match is None else as_request(match),
            max_age_s=None if cfg.get("max_age_s") is None else float(cfg["max_age_s"]),
            max_accesses=None if cfg.get("max_accesses") is None else int(cfg["max_accesses"]),
            promote_after=None if cfg.get("promote_after") is None else int(cfg["promote_after"]),
        )
