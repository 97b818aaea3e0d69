"""The port's own spans and counters, recorded while a ``torch.profiler``
session records.

* ``span(name)``: a context manager around one stage of the program.
* ``count(name, n=1)``: a counter event where the work happens: a kernel
  launch (``launch.<entry>``, counted by ``ops/cuda/_lib.check``), a
  blocking host-device transfer (``sync.<site>``), an ``nvcc`` build
  (``kernels.build``), a launch plan's build (``plan.build``,
  ``ops/cuda/_lib.plan``).
* ``records(t0_ns, t1_ns)``: the spans and counter events in a window, as
  plain tuples ``(kind, name, start_ns, end_ns, value)``: ``kind`` is
  ``"span"`` (``value``: how many spans of the thread were open around
  it, 0 for a top-level span) or ``"count"`` (``value``: the count;
  ``start_ns == end_ns`` but for a launch, whose record spans the C call,
  and a build).

Recording is on exactly while a profiler session records
(``torch.autograd.profiler._is_profiler_enabled``, which ``start()`` and
``stop()`` of every ``torch.profiler`` session set, whatever its
activities): then a span also opens a ``qpsk.<name>`` record function,
so the stage shows in the profiler's own trace (the Chrome trace of
``utils.debug.trace``).  Off, ``span`` and ``count`` cost one flag test.
The record function is torch's ``_RecordFunctionFast``, 1.7 us a span
under a profiler on the H100's host where ``torch.profiler
.record_function`` costs 10-15 us, about a fortieth of the host's time
of a gateway call each.  The one-off lifecycle records, the ``kernels.load`` span and the
``kernels.build`` and ``plan.build`` counters (``ops/cuda/_lib.py``), are
kept whether a profiler records or not.

Stamps are ``time.time_ns()``, the clock the profiler converts its own
events to, so the records line up with a profiler trace's device
operations: on the H100 within the few microseconds of a launch call in
most sessions, and up to 0.2 ms apart in some (``PERF.md``).  The records
sit in a ring of ``RING`` entries: past it the oldest go, counted in
``dropped``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

RING = 1 << 20

_ring = collections.deque(maxlen=RING)
_lock = threading.Lock()
_local = threading.local()
_OFF = contextlib.nullcontext()
# records the ring dropped, oldest first, since the process started
dropped = 0


def _append(record: tuple) -> None:
    global dropped
    if len(_ring) == _ring.maxlen:
        # a lock taken on every append would double a span's cost; only
        # a full ring drops, so only then is the count updated under it
        with _lock:
            dropped += 1
    _ring.append(record)


class _Span:
    __slots__ = ("name", "rf", "start", "depth")

    def __init__(self, name: str, profiled: bool):
        self.name = name
        self.rf = _RecordFunctionFast(f"qpsk.{name}") if profiled else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.depth = getattr(_local, "depth", 0)
        _local.depth = self.depth + 1
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.depth = self.depth
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _append(("span", self.name, self.start, end, self.depth))
        return False


def span(name: str, always: bool = False):
    """A context manager that records the stage ``name`` while a profiler
    records (or, with ``always``, a lifecycle stage, in any case)."""
    if _profiler._is_profiler_enabled:
        return _Span(name, True)
    return _Span(name, False) if always else _OFF


def count(name: str, n: int = 1, always: bool = False,
          start_ns: int | None = None) -> None:
    """Record ``n`` events of ``name`` now while a profiler records (or,
    with ``always``, in any case); ``start_ns`` stamps when the counted
    work began."""
    if always or _profiler._is_profiler_enabled:
        end = time.time_ns()
        _append(("count", name, end if start_ns is None else start_ns, end,
                 n))


def records(t0_ns: int, t1_ns: int) -> list:
    """The records whose stamps meet ``[t0_ns, t1_ns]``, oldest end
    first."""
    held = list(_ring)
    return [r for r in held if r[2] <= t1_ns and r[3] >= t0_ns]
