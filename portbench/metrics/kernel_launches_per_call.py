"""Hand-written kernel launches per timed call, as the program counts
them: its ``launch.<entry>`` events, one a launch that
``ops/cuda/_lib.check`` passed, over the calls of the window that also
traces the host.  Beside ``device_ops_per_call`` (every device operation)
it tells the port's kernels from torch's own."""

from portbench.program_records import per_call

LAYER = "entry points"
MOVES = "rx_samples_per_s"


def read(trace, cell):
    return per_call(trace, "launch.")
