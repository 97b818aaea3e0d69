"""The share of the traced window in which no operation ran on the
device: 1 - (union of the device operations' intervals) / window."""

LAYER = "device (one H100)"
MOVES = "rx_samples_per_s"


def read(trace, cell):
    if trace.window_s <= 0.0 or not trace.ops:
        return None
    return 1.0 - trace.busy_s() / trace.window_s
