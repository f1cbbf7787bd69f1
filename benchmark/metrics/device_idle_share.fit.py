"""The device's idle share of a traced fit window: 1 - the union of its
kernel, copy and set intervals over the traced window, in %."""


def read(record):
    if record.kind != "fit" or record.trace is None:
        return None
    return 100.0 * (1.0 - record.trace.busy_s / record.trace.window_s)
