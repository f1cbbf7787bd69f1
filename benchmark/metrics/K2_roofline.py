"""K2, the chain forward of a frame (csrc/render_chain.cu), as a share of
its roofline: the least time for the work the probe frames need (the kept
frames and the last: ``opcount.forward_work`` on the reference's own
forward), over those frames' launches in the trace, in %."""
from benchmark import harness


def read(record):
    if record.kind != "frame":
        return None
    return harness.roofline(record, "k2", harness.CHAIN_KERNEL)
