"""K4, the two-phase adjoint of a fit step (csrc/adjoint_packed.cu: the
live list, the adjoint and the column sums), as a share of its roofline:
the least time for the work the probe steps' adjoints need
(``opcount.adjoint_work``), over the device time of those steps' K4
launches in the trace, in %."""
from benchmark import harness


def read(record):
    if record.kind != "fit":
        return None
    return harness.roofline(record, "k4", *harness.K4_KERNELS)
