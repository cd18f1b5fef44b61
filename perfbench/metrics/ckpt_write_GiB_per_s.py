"""GiB/s of the window's checkpoint writes into the FDB: their bytes over
their seconds on the writer thread, from hand-over to publication
(``CheckpointManager.timings``, ``bytes`` and ``write_s``)."""


def read(run: dict):
    saves = run.get("saves")
    if not saves:
        return None
    return sum(r["bytes"] for r in saves) / sum(r["write_s"] for r in saves) / 2**30
