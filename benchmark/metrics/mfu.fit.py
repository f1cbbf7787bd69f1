"""The whole fit step's share of the chip's FP32 peak, in %: the probe
steps' operations (the first step of each job the window started; the
forward and the adjoint, ``opcount`` on the reference's own forward), over
the time each step holds on the device's time line, from its forward's
launch to the next step's (its launches, copies and idle gaps alike),
times the peak.  Each probe step's own work over its own time: no step's
count stands in for another's."""
from benchmark import harness


def read(record):
    if record.kind != "fit":
        return None
    return harness.step_mfu(record)
