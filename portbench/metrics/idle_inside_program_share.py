"""The share of the device-only traced window in which the device was idle
while the host was inside the program: the device's idle stretches (the
window less the union of its operations) met with the union of the
program's top-level spans (``rx_stream`` and the like), over the window.
The rest of ``device_idle_share`` is idle while the host was outside the
program (the caller's loop, the benchmark)."""

from portbench.program_records import records

LAYER = "device (one H100)"
MOVES = "rx_samples_per_s"


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def read(trace, cell):
    recs = records(trace.t0, trace.t1)
    if not recs or not trace.ops or trace.window_s <= 0.0:
        return None
    spans = _union((max(r[2], trace.t0), min(r[3], trace.t1))
                   for r in recs if r[0] == "span" and r[4] == 0)
    if not spans:
        return None
    busy = _union((max(o.start, trace.t0), min(o.end, trace.t1))
                  for o in trace.ops)
    idle, end = [], trace.t0
    for s, e in busy:
        if s > end:
            idle.append((end, s))
        end = max(end, e)
    if trace.t1 > end:
        idle.append((end, trace.t1))
    both, k = 0, 0
    for s, e in idle:
        while k < len(spans) and spans[k][1] <= s:
            k += 1
        j = k
        while j < len(spans) and spans[j][0] < e:
            both += min(e, spans[j][1]) - max(s, spans[j][0])
            j += 1
    return both / 1e9 / trace.window_s
