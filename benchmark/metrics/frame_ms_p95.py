"""The 95th percentile, over all frames of the window, of a frame's latency
from the render call to its synchronize (host clock), in ms."""
from benchmark import stats


def read(record):
    if record.kind != "frame" or not record.latencies_s:
        return None
    return 1e3 * stats.percentile(record.latencies_s, 95.0)
