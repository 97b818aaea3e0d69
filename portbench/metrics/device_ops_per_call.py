"""Device operations (kernels, copies, fills) the window ran, per timed
call: an exact count of what the entry points launch."""

LAYER = "entry points"
MOVES = "rx_samples_per_s"


def read(trace, cell):
    if trace.calls <= 0 or not trace.ops:
        return None
    return len(trace.ops) / trace.calls
