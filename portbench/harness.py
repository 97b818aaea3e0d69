"""One run of one cell: set-up, the measured window, the judge, the result.

Set-up (``setup_s``, on the host's clock from the process's start): the
imports, the cell's stimulus made on the device from the seed by its
generator (``portbench.generators``), the program's state, its first call
from that state (whose outputs the judge keeps) and ``warmup_calls`` more,
which build the kernels and warm every shape the window uses.  The window
chains the program's calls over the stimulus's
period, the state carried from call to call, until ``seconds`` have passed
on the host's clock, then waits for the device: ``rx_samples_per_s`` is
every channel sample of every call over the whole of that time.  With
``trace`` two windows run under ``torch.profiler`` instead, and the
per-layer metrics are read from them: one of at most ``TRACE_SECONDS``
that traces the device alone (its idle share and its operations, free of
the profiler's host-side cost), then one of at most ``SPAN_SECONDS`` that
also traces the host's ``portbench.<stage>`` ranges and launches, which
attribute each operation to the stage that launched it.
Then the peak of device memory is read and the judge compares the first
call and the window's last with the reference.
"""

from __future__ import annotations

import time

import torch

from portbench import judge
from portbench import trace as tracing
from portbench.cell import load
from portbench.metrics import reader

TRACE_SECONDS = 2.0   # the device-only traced window
SPAN_SECONDS = 1.0    # the traced window with the host's ranges


def _window(system, state, calls, i, seconds, device, prof) -> tuple:
    """Chain calls from call ``i`` until ``seconds`` have passed, then wait
    for the device.  Returns (state, the state before the last call, its
    outputs, the next call's index, the calls made, the seconds)."""
    n = len(calls)
    if prof is not None:
        prof.start()
    count = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        before = state
        state, out = system.call(state, calls[i % n])
        i += 1
        count += 1
        if time.perf_counter() >= deadline:
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    return state, before, out, i, count, elapsed


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(root, workload: str, seed: int, seconds: float, trace: bool,
        device, t_start: float, wrap=None) -> dict:
    """The result of one run (the keys the benchmark prints) and, under
    ``"info"``, what it prints beside them.  ``wrap`` replaces the system
    under test by ``wrap(system)`` (the tests' broken programs)."""
    cuda = torch.device(device).type == "cuda"
    cell = load(root, workload)
    stim = cell.gen.make(cell, seed, device)
    system = cell.gen.System(cell, device, stim, spans=trace)
    if wrap is not None:
        system = wrap(system)
    calls = stim["calls"]
    n = len(calls)
    first_state, first_out = system.call(system.init(), calls[0])
    state, i = first_state, 1
    for _ in range(cell.traffic["warmup_calls"]):
        state, _ = system.call(state, calls[i % n])
        i += 1
    _sync(device)
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    if trace:
        prof = tracing.profiler(host=False)
        state, before, out, i, count, elapsed = _window(
            system, state, calls, i, min(seconds, TRACE_SECONDS), device,
            prof)
        tr = tracing.reduce(prof, count, elapsed)
        prof = tracing.profiler(host=True)
        state, before, out, i, count2, elapsed2 = _window(
            system, state, calls, i, min(seconds, SPAN_SECONDS), device,
            prof)
        tr.spanned = tracing.reduce(prof, count2, elapsed2)
        del prof
        count += count2
    else:
        state, before, out, i, count, elapsed = _window(
            system, state, calls, i, seconds, device, None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    result = {"correct": None, "attempted": count, "failed": None}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = reader(m["name"]).read(tr, cell)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        breakdown = {"device_ops": tr.breakdown()["device_ops"],
                     "idle_gaps": tr.spanned.breakdown()["idle_gaps"]}
        attributed = tr.spanned.attributed
        del tr
    else:
        for m in cell.end_to_end:
            if m["name"] == "rx_samples_per_s":
                metrics[m["name"]] = {
                    "value": count * cell.samples_per_call / elapsed,
                    "unit": m["unit"]}
            elif m["name"] == "setup_s":
                metrics[m["name"]] = {"value": setup_s, "unit": m["unit"]}
    records = [judge.Compared(0, None, system.view(first_state, first_out)),
               judge.Compared(i - 1, system.view(before),
                              system.view(state, out))]
    del first_state, first_out, before, state, out
    worst, checks, failed, each = judge.judge(cell, stim, records, device)
    result.update(correct=failed == 0, failed=failed, metrics=metrics,
                  device=dev)
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    info = {k: v for k, v in worst.items() if k not in checks}
    for name, got in zip(("start", "last"), each):
        info.update({f"{name}.{k}": v for k, v in got.items()})
    info["window_calls"] = count
    if trace:
        info["ops_attributed"] = attributed
    result["info"] = info
    return result
