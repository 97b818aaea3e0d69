"""Seconds the process spent loading the kernel library, building it
first where its sources were never built in this checkout: the program's
``kernels.load`` span (``ops/cuda/_lib.library``), kept whether a profiler
records or not.  Part of ``setup_s``; a build shows as the
``kernels.build`` counter."""

import time

from portbench.program_records import records

LAYER = "kernel library"
MOVES = "setup_s"


def read(trace, cell):
    recs = records(0, time.time_ns())
    loads = [r for r in (recs or ()) if r[:2] == ("span", "kernels.load")]
    if not loads:
        return None
    return sum(r[3] - r[2] for r in loads) / 1e9
