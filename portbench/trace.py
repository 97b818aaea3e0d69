"""The traced window (``--trace 1``): ``torch.profiler`` over chained calls,
reduced to the device's operations, the ``portbench.<stage>`` ranges the
system's calls ran in (``portbench/generators``), and which range launched
each operation.  The per-layer metrics (``portbench/metrics``) read a
``Trace``."""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

_LAUNCH_PREFIXES = ("cuda", "cu")


@dataclasses.dataclass
class Op:
    name: str
    start: int        # ns
    end: int
    span: str | None  # the portbench range that launched it


@dataclasses.dataclass
class Trace:
    ops: list
    ranges: list      # (name, start ns, end ns) on the host
    calls: int
    window_s: float
    t0: int           # ns, the window's start on the profiler's clock
    t1: int
    attributed: float  # the share of ops whose launch was found
    spanned: "Trace | None" = None  # the window with the host's ranges

    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device: the union of
        the operations' intervals within the window."""
        total, end = 0, self.t0
        for s, e in sorted((max(o.start, self.t0), min(o.end, self.t1))
                           for o in self.ops):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total / 1e9

    def time_s(self, pred) -> float:
        return sum(o.end - o.start for o in self.ops if pred(o)) / 1e9

    def breakdown(self) -> dict:
        """The ten device operations with the most time, and the ten
        longest idle stretches summed by what the host was doing when each
        began (the innermost ``portbench`` range, or ``host``)."""
        by_name = collections.Counter()
        for o in self.ops:
            by_name[o.name[:80]] += (o.end - o.start) / 1e9
        gaps = collections.Counter()
        end = self.t0
        for o in sorted(self.ops, key=lambda o: o.start):
            if o.start > end:
                gaps[self._host_at(end)] += (o.start - end) / 1e9
            end = max(end, o.end)
        if self.t1 > end:
            gaps[self._host_at(end)] += (self.t1 - end) / 1e9
        return {"device_ops": [[n, s] for n, s in by_name.most_common(10)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(10)]}

    def _host_at(self, t: int) -> str:
        return _span_at(self.ranges, t) or "host"


def profiler(host: bool):
    """A profiler of the device's operations, and with ``host`` (or on a
    machine without a card, where it traces nothing else) of the host's
    ranges and launches too."""
    acts = []
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if host or not acts:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def reduce(prof, calls: int, window_s: float) -> Trace:
    """A ``Trace`` of a finished ``profiler()`` over ``calls`` calls in a
    window of ``window_s`` seconds on the host's clock, which starts at the
    first range or launch on the profiler's clock."""
    events = prof.profiler.kineto_results.events()
    ranges, launches, device = [], {}, []
    for e in events:
        if _is_device(e):
            if not e.is_user_annotation() and e.duration_ns() > 0:
                device.append(e)
            continue
        name = e.name()
        if name.startswith("portbench."):
            ranges.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith(_LAUNCH_PREFIXES):
            launches[e.correlation_id()] = e.start_ns()
    ranges.sort(key=lambda r: r[1])
    ops, found = [], 0
    for e in device:
        launch = launches.get(e.linked_correlation_id(),
                              launches.get(e.correlation_id()))
        found += launch is not None
        ops.append(Op(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                      _span_at(ranges, launch) if launch is not None
                      else None))
    firsts = [r[1] for r in ranges[:1]] + [min(launches.values())] \
        if launches else [r[1] for r in ranges[:1]]
    t0 = min(firsts) if firsts else min((o.start for o in ops), default=0)
    t1 = max([t0 + int(window_s * 1e9)] + [o.end for o in ops])
    return Trace(ops=ops, ranges=ranges, calls=calls, window_s=window_s,
                 t0=t0, t1=t1, attributed=found / len(ops) if ops else 0.0)


def _span_at(ranges: list, t: int) -> str | None:
    """The range of ``ranges`` (sorted by start, none nested in another)
    that holds ``t``."""
    k = bisect.bisect_right(ranges, t, key=lambda r: r[1]) - 1
    return ranges[k][0] if k >= 0 and t < ranges[k][2] else None
