"""The Viterbi kernel's share of its roofline: the least time of decoding
a call's packets (``frozen_roofline.viterbi_work``: LLRs in, info bits
out, 64 states x 4 operations a trellis step) over the summed device time
a call of the kernels named here."""

from portbench import frozen_roofline
from portbench.metrics import kernel_share

LAYER = "FEC decoders"
MOVES = "rx_samples_per_s"
KERNELS = ("viterbi",)


def packets(cell) -> int:
    """Packets a call: the call's soft bits cut into frames of the code."""
    m = cell.modem
    bits = cell.samples_per_call // int(m["fs"] // m["rs"]) * 2
    fb = 2 * (8 * cell.config["packet"]["payload_bytes"] + 16 + 6)
    return -(-bits // fb)


def read(trace, cell):
    if cell.config.get("packet") is None:
        return None
    return kernel_share(trace, KERNELS,
                        frozen_roofline.viterbi_work(packets(cell))[0])
