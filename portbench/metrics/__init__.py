"""Per-layer metrics, one file a metric, found by the metric's name in
``BENCHMARK.json``.  Each file holds the metric's ``LAYER`` (as PERF.md
names it), the end-to-end metric it ``MOVES``, and ``read(trace, cell)``:
its value from a ``portbench.trace.Trace`` of the cell's traced window, or
None where the trace holds nothing it reads (the harness then leaves the
metric out).  A roofline metric's work function and kernel names sit in its
own file."""

from __future__ import annotations

import importlib


def reader(name: str):
    """The module of the metric ``name``."""
    return importlib.import_module(f"portbench.metrics.{name}")


def kernel_share(trace, kernels: tuple, bound_ms: float) -> float | None:
    """``bound_ms`` a call over the summed device time a call of the
    operations whose names hold one of ``kernels``, in percent; None if
    the trace has none."""
    t = trace.time_s(lambda o: any(k in o.name for k in kernels))
    if t <= 0.0 or trace.calls <= 0:
        return None
    return 100.0 * bound_ms * 1e-3 * trace.calls / t
