"""The program's own records of a traced window: the spans and counter
events ``qpsk_tpu_torch.tracing`` stamped on the profiler's clock, which
the per-layer metrics ``kernel_launches_per_call``,
``host_syncs_per_call``, ``idle_inside_program_share`` and
``kernel_load_s`` read.  A checkout whose program has no such module
gives None, and those metrics are left out."""

from __future__ import annotations


def records(t0_ns: int, t1_ns: int) -> list | None:
    """The program's records that meet ``[t0_ns, t1_ns]``: tuples ``(kind,
    name, start_ns, end_ns, value)``, ``kind`` "span" (``value`` its
    depth) or "count" (``value`` the count); None without the module."""
    try:
        from qpsk_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.records(t0_ns, t1_ns)


def per_call(trace, prefix: str) -> float | None:
    """Counter events named ``prefix``* per timed call of the window that
    also traces the host (its start is the first call's range, so every
    event of its calls and no other falls in it); None where the program
    recorded no span there."""
    trace = trace.spanned or trace
    recs = records(trace.t0, trace.t1)
    if not recs or trace.calls <= 0 \
            or not any(r[0] == "span" for r in recs):
        return None
    n = sum(r[4] for r in recs if r[0] == "count" and r[1].startswith(prefix))
    return n / trace.calls
