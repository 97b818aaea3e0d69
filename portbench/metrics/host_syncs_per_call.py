"""Blocking host-device transfers per timed call, as the program counts
them at each site (its ``sync.<site>`` events: a pageable copy to the
card, a copy or a scalar read back) over the calls of the window that
also traces the host.  Each one stalls the host until the card has run
everything queued before it."""

from portbench.program_records import per_call

LAYER = "entry points"
MOVES = "rx_samples_per_s"


def read(trace, cell):
    return per_call(trace, "sync.")
