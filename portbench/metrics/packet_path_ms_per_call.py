"""Device milliseconds a call of the packet path outside the Viterbi
kernel: the operations launched inside the ``portbench.packet_path`` range
(soft bits, the cut, deinterleave, descramble, CRC) less the decoder's."""

from portbench.metrics.viterbi_roofline import KERNELS as DECODER

LAYER = "packet path"
MOVES = "rx_samples_per_s"


def read(trace, cell):
    trace = trace.spanned or trace
    inside = [o for o in trace.ops if o.span == "portbench.packet_path"]
    if not inside or trace.calls <= 0:
        return None
    t = sum(o.end - o.start for o in inside
            if not any(k in o.name for k in DECODER)) / 1e9
    return 1e3 * t / trace.calls
