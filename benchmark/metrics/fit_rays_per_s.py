"""Primary rays of every fit step finished in the window (the whole
frame's, on any number of chips), over all of the window's seconds."""
from benchmark import stats


def read(record):
    if record.kind != "fit":
        return None
    return stats.rate(record.units * record.rays, record.window_s)
