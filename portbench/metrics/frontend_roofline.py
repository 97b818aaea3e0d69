"""The RX front-end kernel's share of its roofline: the least time of the
front-end's work at the cell's shapes (``frozen_roofline.frontend_work``,
time-major, no power output) over the summed device time a call of the
kernels named here."""

from portbench import frozen_roofline
from portbench.metrics import kernel_share

LAYER = "RX front-end kernel"
MOVES = "rx_samples_per_s"
KERNELS = ("frontend_kernel", "frontend_general_kernel")


def work_ms(cell) -> float | None:
    m = cell.modem
    if (m["frame_size"], m["ntaps"]) != (512, 127) or m.get("agc"):
        return None
    return frozen_roofline.frontend_work(
        cell.channels, cell.frames, int(m["fs"] // m["rs"]), True, False)[0]


def read(trace, cell):
    bound = work_ms(cell)
    return None if bound is None else kernel_share(trace, KERNELS, bound)
