"""The share of the traced window in which the card ran no operation: one
less the union of its kernels, copies and fills (``torch.profiler``) over
the window."""


def read(run: dict):
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
