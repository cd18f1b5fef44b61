"""Mean seconds the step loop stood still for each checkpoint of the window:
the snapshot of the train state to host memory (``CheckpointManager.timings``,
``snapshot_s``)."""


def read(run: dict):
    saves = run.get("saves")
    return sum(r["snapshot_s"] for r in saves) / len(saves) if saves else None
