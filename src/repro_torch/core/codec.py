"""The GRIB codec on the wire path (paper §1.2, ROADMAP "Pallas GRIB codec").

Real FDB traffic is GRIB: every field is bit-packed (scale/offset + n-bit
codes) before it touches the object store, so the bandwidth that matters
operationally is the *effective* (pre-codec) field throughput, not the wire
byte rate — both DAOS-vs-Lustre studies (arXiv 2404.03107, 2211.09162)
report field throughput.  This module fuses the
:mod:`repro_torch.kernels.grib_pack` CUDA kernels into the archive/retrieve
hot path.  It is the port of ``repro.core.codec`` and keeps its wire format
byte for byte, so payloads written by either package decode in the other:

- :func:`encode_fields` packs a WHOLE batch of ``(F, H, W)`` fields in one
  ``grib_pack`` kernel launch (one launch per distinct field shape when the
  batch is ragged) and frames each field as a self-describing wire payload;
- :func:`decode_payloads` batch-unpacks payloads the same way (one
  ``grib_unpack`` launch per shape group);
- :class:`DecodedFieldSet` is the lazy read-side view: a partial
  ``retrieve_many`` slice decodes chunk by chunk, each chunk in one kernel
  launch, as it is consumed;
- :class:`CodecFDB` is the declarative facade — ``{"type": "codec",
  "nbits": 16, "inner": {...}}`` in :func:`~repro.core.config.build_fdb` —
  that fixes the pack width per tier, so a hot DAOS tier can pack at 16
  bits while the cold POSIX archive keeps 24.

Wire payload layout (little-endian, 32-byte header + code stream)::

    offset  size  field
    0       4     magic  b"GRPK"
    4       1     version (=1)
    5       1     nbits   (code width; container dtype is derived from it)
    6       2     reserved (zero)
    8       4     height  (uint32)
    12      4     width   (uint32)
    16      8     ref     (float64 — per-field reference value, i.e. min)
    24      8     scale   (float64 — quantisation step)
    32      H*W*itemsize  codes (uint8/uint16/uint32 from ``payload_dtype``)

The header makes codec'd and raw datasets coexist in one catalogue:
:func:`is_codec_payload` distinguishes them, and the byte-level client
surface (``retrieve``/``read``/``list``/``wipe``) never looks inside.
Telemetry: every pack/unpack records wire bytes AND effective (pre-codec)
bytes into the owning client's codec :class:`~repro_torch.metrics.IOStats`
sink, so ``stats_snapshot()`` reports the compression win.

Device: fields are packed and unpacked on ``device`` (default
:func:`repro_torch.device.default_device`, the CUDA card), in the hand-written
kernels there and in their plain PyTorch version on the CPU.  Fields may be
numpy arrays or torch tensors on any device; decoded fields come back as
float32 numpy arrays, as in the reference.
"""

from __future__ import annotations

import struct
import threading
import time
from collections import Counter
from typing import Iterator, Mapping, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.grib_pack import grib_pack, grib_unpack, payload_dtype
from ..obs.tracer import NULL_TRACER
from .client import FDBClient, WipeReport
from .datahandle import DataHandle
from .fieldset import FieldSet
from .keys import Key
from .request import Request
from .schema import Schema

__all__ = [
    "CODEC_HEADER_SIZE",
    "CodecError",
    "CodecFDB",
    "CodecHeader",
    "DecodedFieldSet",
    "decode_payloads",
    "encode_fields",
    "is_codec_payload",
    "kernel_launches",
    "parse_header",
    "reset_kernel_launches",
    "take_fields",
    "wire_size",
]


class CodecError(ValueError):
    """A payload that is not (or not consistently) a codec wire frame."""


_MAGIC = b"GRPK"
_VERSION = 1
_HEADER_FMT = "<4sBBHIIdd"  # magic, version, nbits, reserved, H, W, ref, scale
CODEC_HEADER_SIZE = struct.calcsize(_HEADER_FMT)  # 32 bytes

#: pack/unpack kernel-launch counters — the batch-fusion contract ("one
#: launch per batch") is asserted in tests against these, not inferred
_LAUNCHES: Counter = Counter()
_LAUNCH_MU = threading.Lock()


def kernel_launches() -> dict:
    """Snapshot of cumulative {'pack': n, 'unpack': m} kernel launches."""
    with _LAUNCH_MU:
        return {"pack": _LAUNCHES["pack"], "unpack": _LAUNCHES["unpack"]}


def reset_kernel_launches() -> None:
    with _LAUNCH_MU:
        _LAUNCHES.clear()


def _count_launch(kind: str) -> None:
    with _LAUNCH_MU:
        _LAUNCHES[kind] += 1


class CodecHeader:
    """Parsed wire header of one codec payload."""

    __slots__ = ("nbits", "height", "width", "ref", "scale")

    def __init__(self, nbits: int, height: int, width: int, ref: float, scale: float):
        self.nbits = nbits
        self.height = height
        self.width = width
        self.ref = ref
        self.scale = scale

    @property
    def dtype(self) -> np.dtype:
        return payload_dtype(self.nbits)

    @property
    def body_size(self) -> int:
        return self.height * self.width * self.dtype.itemsize

    def __repr__(self) -> str:
        return (
            f"CodecHeader(nbits={self.nbits}, shape=({self.height}, "
            f"{self.width}), ref={self.ref!r}, scale={self.scale!r})"
        )


def wire_size(shape: tuple[int, int], nbits: int) -> int:
    """Exact wire bytes of one encoded (H, W) field at ``nbits``."""
    h, w = shape
    return CODEC_HEADER_SIZE + h * w * payload_dtype(nbits).itemsize


def is_codec_payload(data: bytes) -> bool:
    """True when *data* starts with a codec wire header (raw payloads in the
    same catalogue return False — coexistence is a header check away)."""
    return len(data) >= CODEC_HEADER_SIZE and data[:4] == _MAGIC


def parse_header(payload: bytes, *, context: str = "") -> CodecHeader:
    """Parse and validate one payload's header; :class:`CodecError` names
    what is wrong (and for which field, when the caller supplies context)."""
    where = f" for {context}" if context else ""
    if len(payload) < CODEC_HEADER_SIZE:
        raise CodecError(
            f"payload{where} is {len(payload)} bytes — shorter than the "
            f"{CODEC_HEADER_SIZE}-byte codec header (raw, truncated, or not "
            "a codec payload)"
        )
    magic, version, nbits, _reserved, h, w, ref, scale = struct.unpack_from(
        _HEADER_FMT, payload
    )
    if magic != _MAGIC:
        raise CodecError(
            f"payload{where} does not carry the codec magic {_MAGIC!r} — "
            "this dataset was archived raw; retrieve it with the byte-level "
            "API (retrieve/read) instead of retrieve_fields"
        )
    if version != _VERSION:
        raise CodecError(f"unsupported codec payload version {version}{where}")
    hdr = CodecHeader(nbits, h, w, ref, scale)
    body = len(payload) - CODEC_HEADER_SIZE
    if body != hdr.body_size:
        raise CodecError(
            f"payload{where} declares a ({h}, {w}) field of {nbits}-bit codes "
            f"({hdr.body_size} bytes, {hdr.dtype.name} container) but carries "
            f"{body} bytes — corrupt or mis-framed"
        )
    return hdr


def take_fields(fields, idxs: Sequence[int]):
    """Index a field batch — an ``(F, H, W)`` array or tensor, or a sequence
    of 2-D arrays — by positions (routing facades split batches per
    tier/lane)."""
    if isinstance(fields, np.ndarray):
        return fields[np.asarray(idxs, dtype=np.intp)]
    if isinstance(fields, torch.Tensor):
        return fields[torch.as_tensor(idxs, dtype=torch.long, device=fields.device)]
    return [fields[i] for i in idxs]


def _as_tensor(f) -> torch.Tensor:
    """One field or batch as a float32 tensor, on the device it already
    lies on (numpy arrays become CPU tensors without a copy)."""
    if isinstance(f, torch.Tensor):
        return f.to(torch.float32)
    f = np.asarray(f, dtype=np.float32)
    if not f.flags.writeable:
        f = f.copy()  # torch.from_numpy warns on read-only buffers
    return torch.from_numpy(f)


def _as_field_list(fields) -> list[torch.Tensor]:
    """Normalise the accepted batch forms to a list of 2-D float32 fields."""
    if isinstance(fields, (np.ndarray, torch.Tensor)):
        if fields.ndim == 2:
            fields = fields[None]
        if fields.ndim != 3:
            raise CodecError(
                f"fields must be (F, H, W) or a sequence of (H, W) arrays, "
                f"got ndim={fields.ndim}"
            )
        arr = _as_tensor(fields)
        return [arr[i] for i in range(arr.shape[0])]
    out = []
    for i, f in enumerate(fields):
        f = _as_tensor(f)
        if f.ndim != 2:
            raise CodecError(f"field {i} must be 2-D (H, W), got shape {tuple(f.shape)}")
        out.append(f)
    return out


def _settle(tr, dev: torch.device) -> None:
    """When tracing, wait for the card so that the span just closing holds
    the device work it launched (kernels and copies are asynchronous).  The
    untraced path never synchronises here."""
    if tr.enabled and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def encode_fields(fields, *, nbits: int = 16, stats=None, tracer=None,
                  device=None) -> list[bytes]:
    """Bit-pack a batch of fields into wire payloads.

    ``fields`` is an ``(F, H, W)`` array or a sequence of ``(H, W)`` arrays.
    The WHOLE batch goes through ONE ``grib_pack`` kernel launch (one per
    distinct shape when ragged) — the per-launch dispatch cost is amortised
    exactly like the backends amortise per-op I/O costs in
    ``archive_batch``.  Returns one payload per field, in input order.
    ``tracer`` records one ``codec.pack`` span per kernel launch with
    effective/wire bytes, and inside it one child span per step:
    ``.gather`` (the batch onto the device), ``.kernel`` (stats and pack),
    ``.to_host`` (codes, ref and scale), ``.narrow`` (int32 codes to the
    container dtype) and ``.frame`` (headers and payload bytes).
    ``device`` is where the fields are packed (None: the default device).
    """
    dtype = payload_dtype(nbits)  # validates nbits before any device work
    tr = tracer if tracer is not None else NULL_TRACER
    flist = _as_field_list(fields)
    if not flist:
        return []
    dev = resolve_device(device)
    t0 = time.perf_counter()
    payloads: list[bytes | None] = [None] * len(flist)
    groups: dict[tuple[int, int], list[int]] = {}
    for i, f in enumerate(flist):
        groups.setdefault(tuple(f.shape), []).append(i)
    for shape, idxs in groups.items():
        h, w = shape
        with tr.span("codec.pack") as sp:
            with tr.span("codec.pack.gather"):
                batch = torch.stack([flist[i].to(dev) for i in idxs])  # (f, H, W) float32
                _settle(tr, dev)
            with tr.span("codec.pack.kernel"):
                _count_launch("pack")
                codes, ref, scale = grib_pack(batch, nbits=nbits, device=dev)
                _settle(tr, dev)
            with tr.span("codec.pack.to_host"):
                codes = codes.cpu().numpy()
                ref = ref.cpu().numpy().astype(np.float64)
                scale = scale.cpu().numpy().astype(np.float64)
            with tr.span("codec.pack.narrow"):
                codes = codes.astype(dtype)
            with tr.span("codec.pack.frame"):
                for j, i in enumerate(idxs):
                    header = struct.pack(
                        _HEADER_FMT, _MAGIC, _VERSION, nbits, 0, h, w, ref[j], scale[j]
                    )
                    payloads[i] = header + codes[j].tobytes()
            if tr.enabled:
                sp.set("nbits", nbits)
                sp.set("fields", len(idxs))
                sp.set("shape", [h, w])
                sp.set("effective_bytes", len(idxs) * h * w * 4)
                sp.set("wire_bytes", len(idxs) * wire_size(shape, nbits))
    if stats is not None:
        # effective (pre-codec) bytes only — the WIRE bytes of these
        # payloads are counted by the backend sinks when they land, so the
        # merged snapshot's bytes_written stays the true wire total and
        # effective/wire is the compression win
        stats.record(
            "codec_pack",
            seconds=time.perf_counter() - t0,
            effective_w=sum(f.numel() * f.element_size() for f in flist),
            count=len(flist),
        )
    return payloads  # type: ignore[return-value]


def decode_payloads(
    payloads: Sequence[bytes | None],
    *,
    stats=None,
    labels: Sequence | None = None,
    tracer=None,
    device=None,
) -> list[np.ndarray | None]:
    """Unpack wire payloads back to float32 fields.

    ``None`` entries (absent fields) pass through.  All payloads decode in
    ONE ``grib_unpack`` kernel launch per distinct field shape.  ``labels``
    (e.g. the MARS keys) contextualise :class:`CodecError` messages.
    ``tracer`` records one ``codec.unpack`` span per kernel launch with
    effective/wire bytes, and inside it one child span per step:
    ``.widen`` (container codes to int32, header scalars to float32),
    ``.to_card``, ``.kernel`` and ``.to_host`` (the decoded fields).
    ``device`` is where the codes are unpacked (None: the default device).
    """
    tr = tracer if tracer is not None else NULL_TRACER
    t0 = time.perf_counter()
    dev = resolve_device(device) if any(p is not None for p in payloads) else None
    out: list[np.ndarray | None] = [None] * len(payloads)
    headers: list[CodecHeader | None] = [None] * len(payloads)
    groups: dict[tuple[int, int, int], list[int]] = {}
    for i, p in enumerate(payloads):
        if p is None:
            continue
        ctx = str(labels[i]) if labels is not None else ""
        hdr = parse_header(p, context=ctx)
        headers[i] = hdr
        groups.setdefault((hdr.height, hdr.width, hdr.nbits), []).append(i)
    for (h, w, nbits), idxs in groups.items():
        with tr.span("codec.unpack") as sp:
            with tr.span("codec.unpack.widen"):
                dtype = payload_dtype(nbits)
                codes = np.stack(
                    [
                        np.frombuffer(payloads[i], dtype=dtype, offset=CODEC_HEADER_SIZE)
                        .reshape(h, w)
                        .astype(np.int32)
                        for i in idxs
                    ]
                )
                ref = np.asarray([headers[i].ref for i in idxs], dtype=np.float32)
                scale = np.asarray([headers[i].scale for i in idxs], dtype=np.float32)
            with tr.span("codec.unpack.to_card"):
                codes_d = torch.from_numpy(codes).to(dev)
                ref_d = torch.from_numpy(ref).to(dev)
                scale_d = torch.from_numpy(scale).to(dev)
                _settle(tr, dev)
            with tr.span("codec.unpack.kernel"):
                _count_launch("unpack")
                decoded = grib_unpack(codes_d, ref_d, scale_d, device=dev)
                _settle(tr, dev)
            with tr.span("codec.unpack.to_host"):
                decoded = decoded.cpu().numpy()
            for j, i in enumerate(idxs):
                out[i] = decoded[j]
            if tr.enabled:
                sp.set("nbits", nbits)
                sp.set("fields", len(idxs))
                sp.set("shape", [h, w])
                sp.set("effective_bytes", len(idxs) * h * w * 4)
                sp.set("wire_bytes", sum(len(payloads[i]) for i in idxs))
    if stats is not None:
        # effective bytes only; the wire reads were counted by the backend
        stats.record(
            "codec_unpack",
            seconds=time.perf_counter() - t0,
            effective_r=sum(a.nbytes for a in out if a is not None),
            count=sum(1 for p in payloads if p is not None),
        )
    return out


class DecodedFieldSet:
    """The lazy result of :meth:`FDBClient.retrieve_fields`.

    Wraps a :class:`~repro.core.fieldset.FieldSet` and decodes on first
    touch, chunk by chunk — iterating a partial ``retrieve_many`` slice
    pays one backend fetch AND one ``grib_unpack`` launch per chunk, never
    per field.  Decoded arrays are memoised; the underlying byte handles
    are read and closed as each chunk resolves.
    """

    def __init__(
        self, fieldset: FieldSet, *, chunk: int | None = 64, stats=None, tracer=None
    ):
        self._fs = fieldset
        self._chunk = max(1, len(fieldset) if chunk is None else chunk)
        self._stats = stats
        self._tracer = tracer
        self._arrays: list[np.ndarray | None | type(...)] = [...] * len(fieldset)
        self._mu = threading.Lock()

    # ------------------------------------------------------------- resolution
    def _decode_range(self, lo: int, hi: int) -> None:
        with self._mu:
            idxs = [j for j in range(lo, hi) if self._arrays[j] is ...]
            if not idxs:
                return
            payloads: list[bytes | None] = []
            for j in idxs:
                h = self._fs.handle_at(j)
                if h is None:
                    payloads.append(None)
                else:
                    try:
                        payloads.append(h.read())
                    finally:
                        h.close()
            decoded = decode_payloads(
                payloads,
                stats=self._stats,
                labels=[self._fs.keys[j] for j in idxs],
                tracer=self._tracer,
            )
            for j, a in zip(idxs, decoded):
                self._arrays[j] = a

    # -------------------------------------------------------------- container
    @property
    def keys(self) -> tuple[Key, ...]:
        return self._fs.keys

    def __len__(self) -> int:
        return len(self._fs)

    def __iter__(self) -> Iterator[tuple[Key, np.ndarray | None]]:
        n = len(self._fs)
        for lo in range(0, n, self._chunk):
            hi = min(lo + self._chunk, n)
            self._decode_range(lo, hi)
            for j in range(lo, hi):
                yield self._fs.keys[j], self._arrays[j]

    def items(self) -> Iterator[tuple[Key, np.ndarray | None]]:
        return iter(self)

    def __getitem__(self, key: Key | Mapping[str, str]) -> np.ndarray | None:
        key = key if isinstance(key, Key) else Key(key)
        try:
            i = self._fs.keys.index(key)
        except ValueError:
            raise KeyError(key) from None
        lo = (i // self._chunk) * self._chunk
        self._decode_range(lo, min(lo + self._chunk, len(self._fs)))
        return self._arrays[i]

    def __repr__(self) -> str:
        resolved = sum(1 for a in self._arrays if a is not ...)
        return f"DecodedFieldSet({len(self._arrays)} fields, {resolved} decoded)"

    # ------------------------------------------------------------ convenience
    def read_all(self) -> dict[Key, np.ndarray | None]:
        """Decode everything: ONE whole-batch backend fetch (the fieldset's
        amortised path), then one unpack launch per field shape."""
        self._fs.handles()  # whole-set resolve in one vectored fetch
        self._decode_range(0, len(self._fs))
        return dict(zip(self._fs.keys, self._arrays))

    def missing(self) -> list[Key]:
        """Keys whose field is absent from the FDB."""
        self._fs.handles()
        self._decode_range(0, len(self._fs))
        return [k for k, a in zip(self._fs.keys, self._arrays) if a is None]

    def arrays(self) -> np.ndarray:
        """The whole set stacked as one ``(F, H, W)`` array — raises
        :class:`CodecError` when fields are absent or shapes are ragged."""
        all_ = self.read_all()
        absent = [k for k, a in all_.items() if a is None]
        if absent:
            raise CodecError(f"cannot stack: {len(absent)} absent fields {absent[:3]}")
        mats = [self._arrays[j] for j in range(len(self._fs))]
        shapes = {a.shape for a in mats}
        if len(shapes) > 1:
            raise CodecError(f"cannot stack ragged field shapes {sorted(shapes)}")
        return np.stack(mats)


class CodecFDB(FDBClient):
    """A codec tier: any inner :class:`FDBClient` with the pack width fixed
    declaratively (``{"type": "codec", "nbits": N, "inner": ...}``).

    Byte-level operations pass straight through — raw and codec'd datasets
    coexist in the inner catalogue — while :meth:`archive_fields` packs at
    this tier's ``nbits`` (the whole batch in one kernel launch) and
    :meth:`retrieve_fields` decodes lazily per chunk.  The codec telemetry
    sink rides in :meth:`io_stats`, so effective-vs-wire bytes surface in
    every ``stats_snapshot()`` up the composition tree.
    """

    def __init__(self, inner: FDBClient, *, nbits: int = 16, owns_inner: bool = True):
        payload_dtype(nbits)  # validate the width before accepting the tier
        self.inner = inner
        self.schema: Schema = inner.schema
        self._codec_nbits = nbits
        self._owns_inner = owns_inner
        self._fieldset_batch = inner._fieldset_batch

    @property
    def nbits(self) -> int:
        return self._codec_nbits

    # ------------------------------------------------------------ pass-through
    def archive(self, key: Key | Mapping[str, str], data: bytes) -> None:
        self.inner.archive(key, data)

    def archive_batch(self, items) -> None:
        self.inner.archive_batch(items)

    def retrieve(self, key: Key | Mapping[str, str]) -> DataHandle | None:
        return self.inner.retrieve(key)

    def retrieve_batch(self, keys) -> list[DataHandle | None]:
        return self.inner.retrieve_batch(keys)

    def retrieve_many(self, request) -> FieldSet:
        # the inner facade's fan-out/amortisation (AsyncFDB reader pool,
        # router scatter) must drive the fetch, not this wrapper's default
        return self.inner.retrieve_many(request)

    def flush(self) -> None:
        self.inner.flush()

    def drain(self) -> None:
        self.inner.drain()

    def _list(self, request: Request):
        return getattr(self.inner, "_list", self.inner.list)(request)

    def _wipe_dataset(self, dataset_key: Key, entries=None) -> WipeReport:
        return self.inner._wipe_dataset(dataset_key, entries)

    # ------------------------------------------------------------- telemetry
    def io_stats(self) -> list:
        return list(self.inner.io_stats()) + self._codec_sinks()

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._owns_inner:
            self.inner.close()
        else:
            self.inner.flush()

    def __repr__(self) -> str:
        return f"CodecFDB(nbits={self._codec_nbits}, inner={self.inner!r})"
