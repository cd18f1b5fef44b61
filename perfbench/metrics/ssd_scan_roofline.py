"""K4's share of its roofline in the traced window: the least time of its
calls (the benchmark's bound for the call's shapes, by bytes or by
operations, whichever is longer) over the device time of its two launches,
``ssd_chunk_state`` and ``ssd_chunk_scan``."""

from perfbench import roofline, tracing


def read(run: dict):
    trace = run.get("trace")
    if not trace:
        return None
    state_s, states = tracing.kernel_time(trace, "ssd_chunk_state")
    scan_s, scans = tracing.kernel_time(trace, "ssd_chunk_scan")
    if not scans or states != scans:
        return None
    mix, itemsize = run["mix"], 2 if run["config"]["dtype"] in ("bfloat16", "float16") else 4
    bound, _ = roofline.ssd_bound(**roofline.ssd_shape(run["config"], mix["batch"], mix["seq"]),
                                  itemsize=itemsize)
    return 100.0 * scans * bound / (state_s + scan_s)
