"""Quickstart: the FDB public API in ~80 lines, on the PyTorch/CUDA port.

Archives a few synthetic weather fields through both backends, retrieves
them, lists a step slice, shows the semantics difference the paper is built
around (DAOS: visible at archive; POSIX: visible at flush), and builds the
paper's tiered hot/cold deployment from one declarative JSON config.
The twin of ``examples/quickstart.py``: GRIB packing runs in the port's
hand-written CUDA kernels on the card, or in their plain PyTorch version
when the CPU is asked for.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np

from repro_torch.core import FDBConfig, Key, NWP_SCHEMA_DAOS, NWP_SCHEMA_POSIX, Request, make_fdb
from repro_torch.core.daos import DaosEngine
from repro_torch.device import resolve_device, set_default_device
from repro_torch.fields import synthetic_field
from repro_torch.kernels.grib_pack import pack_to_bytes, unpack_from_bytes


def field_key(member: int, step: int, param: str, cls: str = "od") -> Key:
    return Key(
        {"class": cls, "stream": "oper", "expver": "0001", "date": "20240603",
         "time": "1200", "type": "ef", "levtype": "sfc", "number": str(member),
         "levelist": "0", "step": str(step), "param": param}
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    set_default_device(dev)  # every codec call below, config-built tiers included

    # --- a 2-D weather field, GRIB-packed on the card (CUDA kernel path) ----
    field = synthetic_field("2t")  # (181, 360) global 2m-temperature slice
    payload, meta = pack_to_bytes(field)
    print(f"field {field.shape} float32 -> {len(payload)} packed bytes "
          f"(16-bit GRIB simple packing on {dev})")

    # --- DAOS backend: MVCC object store, immediate visibility --------------
    # every facade is a context manager: close() flushes and tears down
    engine = DaosEngine()
    with make_fdb("daos", schema=NWP_SCHEMA_DAOS, engine=engine) as writer, \
         make_fdb("daos", schema=NWP_SCHEMA_DAOS, engine=engine) as reader:
        writer.archive(field_key(0, 0, "2t"), payload)
        print("daos: visible before flush? ->", reader.read(field_key(0, 0, "2t")) is not None)

        # --- write an ensemble, list a transposed step slice ----------------
        for member in range(4):
            for step in range(3):
                for param in ("2t", "10u"):
                    writer.archive(field_key(member, step, param), payload)
        writer.flush()
        step0 = list(reader.list(Request.parse("step=0")))
        print(f"list(step=0): {len(step0)} fields "
              f"(4 members x 2 params; the field archived above was replaced)")

        # --- MARS-style partial retrieve: ranges, wildcards, lazy FieldSet --
        fieldset = reader.retrieve_many(Request.parse("number=0/to/2,param=*,step=1/2"))
        print(f"retrieve_many(number=0/to/2,param=*,step=1/2): {len(fieldset)} fields, "
              f"aggregated handle = {fieldset.handle().size} bytes")

        # --- retrieve + unpack roundtrip ------------------------------------
        got = reader.read(field_key(2, 1, "10u"))
        restored = unpack_from_bytes(got, meta)
        err = np.abs(restored - field).max()
        print(f"roundtrip max abs error: {err:.4f} (quantisation quantum "
              f"{(field.max()-field.min())/65535:.4f})")

    # --- POSIX backend: O_APPEND TOC, visible at flush ----------------------
    with tempfile.TemporaryDirectory() as td:
        with make_fdb("posix", schema=NWP_SCHEMA_POSIX, root=td) as pw, \
             make_fdb("posix", schema=NWP_SCHEMA_POSIX, root=td) as pr:
            pw.archive(field_key(0, 0, "2t"), payload)
            print("posix: visible before flush? ->", pr.read(field_key(0, 0, "2t")) is not None)
            pw.flush()
            print("posix: visible after flush?  ->", pr.read(field_key(0, 0, "2t")) is not None)

    # --- declarative config: the paper's tiered hot/cold FDB from JSON ------
    # operational stream (class=od) routes to hot DAOS NVM, everything else
    # to the cold POSIX archive — each tier with its optimal schema (§5.1)
    with tempfile.TemporaryDirectory() as td:
        config = FDBConfig({
            "type": "select",
            "rules": [{"match": "class=od",
                       "fdb": {"backend": "daos", "schema": "nwp-daos"}}],
            "default": {"backend": "posix", "schema": "nwp-posix", "root": td},
        })
        assert FDBConfig.from_json(config.to_json()) == config  # JSON round-trip
        with config.build() as tiered:
            tiered.archive(field_key(0, 0, "2t", cls="od"), payload)      # hot
            tiered.archive(field_key(0, 0, "2t", cls="rd"), payload)      # cold
            tiered.flush()
            merged = list(tiered.list(Request.parse("param=2t")))
            print(f"tiered select: {len(merged)} fields across "
                  f"{len(tiered.tiers)} tiers (hot daos + cold posix)")
            report = tiered.wipe({"class": "od/rd", "stream": "oper",
                                  "expver": "0001", "date": "20240603", "time": "1200"})
            print(f"tiered wipe: {report.entries_removed} entries, "
                  f"{report.bytes_freed} bytes across {len(report.datasets)} datasets")

    # --- GRIB codec fused on the wire path ----------------------------------
    # archive_fields bit-packs the WHOLE batch in one grib_pack kernel launch
    # before it touches the store; payloads are self-describing (32-byte
    # header), so codec'd and raw datasets coexist in one catalogue, and
    # retrieve_fields unpacks lazily per chunk on the way back out
    with tempfile.TemporaryDirectory() as td:
        config = FDBConfig({
            "type": "codec", "nbits": 16,
            "inner": {"backend": "posix", "schema": "nwp-posix", "root": td},
        })
        with config.build() as codec_fdb:
            params = ("2t", "10u", "10v")
            keys = [field_key(0, 0, p) for p in params]
            fields = np.stack([synthetic_field(p) for p in params])
            codec_fdb.archive_fields(keys, fields)   # one kernel launch
            codec_fdb.flush()
            got = codec_fdb.retrieve_fields({**dict(keys[0]), "param": list(params)})
            err = np.abs(got.arrays() - fields).max()
            snap = codec_fdb.stats_snapshot()
            eff, wire = snap["effective_bytes_written"], snap["bytes_written"]
            print(f"codec tier: {fields.shape} fields round-tripped "
                  f"(max err {err:.4f}); effective {eff / 1024:.0f} KiB over "
                  f"wire {wire / 1024:.0f} KiB = x{eff / wire:.2f} bandwidth win")

    # --- wipe reports what it removed (index entries AND store bytes) -------
    with tempfile.TemporaryDirectory() as td:
        with make_fdb("posix", schema=NWP_SCHEMA_POSIX, root=td) as scratch:
            scratch.archive(field_key(9, 0, "2t"), payload)
            scratch.flush()
            report = scratch.wipe(field_key(9, 0, "2t"))
            print(f"wipe: {report.entries_removed} entries, {report.bytes_freed} bytes freed")


if __name__ == "__main__":
    main()
