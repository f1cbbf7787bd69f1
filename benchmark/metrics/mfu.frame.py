"""The whole frame's share of the chip's FP32 peak, in %: the probe
frames' operations (the kept frames and the last; ``opcount`` on the
reference's own forward of each frame's eye), over the time each frame
holds on the device's time line, from its forward's launch to the next
frame's or the window's end, times the peak."""
from benchmark import harness


def read(record):
    if record.kind != "frame":
        return None
    return harness.step_mfu(record)
