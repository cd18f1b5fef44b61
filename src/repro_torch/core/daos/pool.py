"""DAOS pools and containers.

A *pool* is reserved space distributed across targets; a pool serves multiple
transactional object stores called *containers*, each with its own address
space (paper §2).  Containers own the objects and the OID allocator
(``daos_cont_alloc_oids`` hands out contiguous ranges — clients cache a range
to avoid a server round-trip per object creation, paper §3.1.2).
"""

from __future__ import annotations

import threading
from typing import Literal

from .objects import OC_S1, ArrayObject, KVObject, ObjectId

__all__ = ["Pool", "Container"]


class Container:
    def __init__(self, label: str, pool: "Pool"):
        self.label = label
        self.pool = pool
        self._objects: dict[ObjectId, KVObject | ArrayObject] = {}
        self._mu = threading.Lock()
        # OID 0 is reserved for the well-known root/dataset KV (paper §3.2.2)
        self._next_oid_lo = 1

    # -- OID allocation ------------------------------------------------------
    def alloc_oids(self, count: int) -> int:
        """Allocate a contiguous range of `count` OIDs; returns the base lo-bits."""
        with self._mu:
            base = self._next_oid_lo
            self._next_oid_lo += count
            return base

    # -- object creation/open --------------------------------------------------
    def open_kv(self, oid: ObjectId, *, create: bool = True, oclass: str = OC_S1) -> KVObject:
        with self._mu:
            obj = self._objects.get(oid)
            if obj is None:
                if not create:
                    raise KeyError(f"kv object {oid} not found in container {self.label}")
                obj = KVObject(oid, oclass)
                self._objects[oid] = obj
            if not isinstance(obj, KVObject):
                raise TypeError(f"object {oid} is not a KV object")
            return obj

    def create_array(self, oid: ObjectId, *, oclass: str = OC_S1, cell_size: int = 1, chunk_size: int = 1 << 20) -> ArrayObject:
        with self._mu:
            if oid in self._objects:
                raise FileExistsError(f"array object {oid} already exists in {self.label}")
            obj = ArrayObject(oid, oclass, cell_size, chunk_size)
            self._objects[oid] = obj
            return obj

    def open_array(self, oid: ObjectId) -> ArrayObject:
        obj = self._objects.get(oid)
        if obj is None:
            raise FileNotFoundError(f"array object {oid} not found in container {self.label}")
        if not isinstance(obj, ArrayObject):
            raise TypeError(f"object {oid} is not an Array object")
        return obj

    def open_array_with_attrs(self, oid: ObjectId, *, cell_size: int = 1, chunk_size: int = 1 << 20, oclass: str = OC_S1) -> ArrayObject:
        """``daos_array_open_with_attrs``: open without the attr-fetch round
        trip by supplying the attributes client-side; creates on first use
        (paper §5.3 lists this as one of the write-path optimisations)."""
        with self._mu:
            obj = self._objects.get(oid)
            if obj is None:
                obj = ArrayObject(oid, oclass, cell_size, chunk_size)
                self._objects[oid] = obj
            if not isinstance(obj, ArrayObject):
                raise TypeError(f"object {oid} is not an Array object")
            return obj

    def destroy_object(self, oid: ObjectId) -> bool:
        """``daos_obj_punch``: drop one object and its extents.  True if the
        object existed.  Subsequent opens raise as if it never was — the
        OID is NOT recycled (allocator state is untouched)."""
        with self._mu:
            return self._objects.pop(oid, None) is not None

    # -- admin ----------------------------------------------------------------
    def object_count(self) -> int:
        return len(self._objects)

    def destroy_contents(self) -> None:
        with self._mu:
            self._objects.clear()
            self._next_oid_lo = 1


class Pool:
    def __init__(self, label: str, n_targets: int = 12, scm_bytes: int = 1 << 40):
        self.label = label
        self.n_targets = n_targets
        self.scm_bytes = scm_bytes
        self._containers: dict[str, Container] = {}
        self._mu = threading.Lock()

    def create_container(self, label: str, *, exist_ok: bool = False) -> Container:
        with self._mu:
            if label in self._containers:
                if exist_ok:
                    return self._containers[label]
                raise FileExistsError(f"container {label!r} already exists in pool {self.label!r}")
            cont = Container(label, self)
            self._containers[label] = cont
            return cont

    def open_container(self, label: str) -> Container:
        cont = self._containers.get(label)
        if cont is None:
            raise FileNotFoundError(f"container {label!r} not found in pool {self.label!r}")
        return cont

    def has_container(self, label: str) -> bool:
        return label in self._containers

    def destroy_container(self, label: str, *, missing_ok: bool = False) -> None:
        with self._mu:
            if label not in self._containers and missing_ok:
                return
            del self._containers[label]

    def list_containers(self) -> list[str]:
        return sorted(self._containers)
