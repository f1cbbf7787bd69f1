"""K3, the packed chain forward of a fit step (csrc/render_chain.cu), as a
share of its roofline: the least time the data sheet allows for the work
the probe steps' forwards need (the first step of each job the window
started: ``opcount.forward_work``, packed), over the device time of those
steps' launches in the trace, in %."""
from benchmark import harness


def read(record):
    if record.kind != "fit":
        return None
    return harness.roofline(record, "k3", harness.CHAIN_KERNEL)
