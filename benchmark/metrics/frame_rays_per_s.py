"""Primary rays of every frame finished in the window, over all of the
window's seconds."""
from benchmark import stats


def read(record):
    if record.kind != "frame":
        return None
    return stats.rate(record.units * record.rays, record.window_s)
