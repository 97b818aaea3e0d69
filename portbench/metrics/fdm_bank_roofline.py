"""The FDM analysis bank's share of its roofline: the least time of the
bank's work at the cell's shapes over the device time a call inside the
``portbench.fdm_bank`` range (``fdm.fdm_demux_stream``).

The work is what the algorithm needs, whatever computes it: the wideband
int16 read once, the subchannels' int16 written once, the carried history
read and written; the branch FIRs' ``2 Q`` operations a wideband sample and
the slot transform as a real FFT of ``N`` points a block, ``2.5 N log2 N``
operations (not the dense cosine product the program runs, so that a bank
that moves to an FFT cannot read above 100 %); float32 at 67 TFLOP/s,
bytes at 3.35 TB/s."""

import math

from portbench import frozen_roofline

LAYER = "FDM bank"
MOVES = "rx_samples_per_s"


def work_ms(cell) -> float:
    n = cell.traffic["fdm"]["nslots"]
    q = cell.traffic["fdm"]["taps_per_branch"]
    wide = cell.frames * cell.modem["frame_size"] * n
    blocks = wide // n
    nbytes = wide * 2 + cell.channels * blocks * 2 + 2 * ((q - 1) * n
                                                         + n - 1) * 4
    flops = wide * 2 * q + blocks * 2.5 * n * math.log2(n) \
        + cell.channels * blocks
    return frozen_roofline.bound(nbytes, flops)[0]


def read(trace, cell):
    trace = trace.spanned or trace
    if "fdm" not in cell.traffic:
        return None
    t = trace.time_s(lambda o: o.span == "portbench.fdm_bank")
    if t <= 0.0 or trace.calls <= 0:
        return None
    return 100.0 * work_ms(cell) * 1e-3 * trace.calls / t
