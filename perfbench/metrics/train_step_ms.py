"""Mean milliseconds of the window's training steps that did not save
(``TrainReport.step_s``, the loss read every step), from fetching the batch
to the end of the optimizer update."""


def read(run: dict):
    steps = run.get("step_s")
    return 1e3 * sum(steps) / len(steps) if steps else None
