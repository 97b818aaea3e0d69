"""The Costas kernel's share of its roofline: the least time of the loop's
work at the cell's shapes (``frozen_roofline.costas_work``: (T, C) planes
in, derotated planes, bits, frame trace and state out, about 22 float
operations a symbol) over the summed device time a call of the kernels
named here."""

from portbench import frozen_roofline
from portbench.metrics import kernel_share

LAYER = "Costas kernel"
MOVES = "rx_samples_per_s"
KERNELS = ("costas",)


def work_ms(cell) -> float:
    m = cell.modem
    nsym = m["frame_size"] // int(m["fs"] // m["rs"])
    return frozen_roofline.costas_work(cell.channels, cell.frames * nsym,
                                       nsym)[0]


def read(trace, cell):
    return kernel_share(trace, KERNELS, work_ms(cell))
