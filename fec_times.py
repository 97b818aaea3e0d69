#!/usr/bin/env python3
"""Times of the torch port's two FEC decoder kernels at the batch sizes the
coded paths give them, on one NVIDIA GPU.

    python3 fec_times.py [ROOT]

ROOT is a checkout of this repository (default: the directory of this
script).  The script imports ``qpsk_tpu_torch`` from ROOT, builds its
kernels and times ``viterbi_decode`` and ``ldpc_decode`` through their
wrappers on random LLRs: 156 packets (a channel's tracked extraction),
4096 (the rate point of ``chip_smoke.py``) and 16 768 (a channel's sync
hunt), Viterbi also 67 072 (the 8PSK hunt).  Only the wrappers' public
signatures are used, so one copy of the script can time two checkouts in
one call, each in a process of its own, to compare two commits on the same
card:

    python3 fec_times.py archive/parent; python3 fec_times.py

Each time is taken twice: the kernel alone (20 launches captured into a
CUDA graph, replayed 10 times between CUDA events, so the host's launch
rate does not bound a kernel of a few microseconds) and launched from the
host (CUDA events around 50 wrapper calls).  The last line is one JSON
object ``{"card": ..., "root": ..., "ms": {"viterbi": {"156": [graph,
graph, host], ...}, "ldpc": {...}}}``.  Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

BATCHES = {"viterbi": (156, 4096, 16768, 67072), "ldpc": (156, 4096, 16768)}


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Mean milliseconds of device time per call of ``fn``: ``launches``
    calls captured into one CUDA graph, replayed ``replays`` times between
    CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def host_ms(fn, iters: int = 50) -> float:
    """Mean milliseconds per call of ``fn`` launched from the host, by
    CUDA events around ``iters`` calls after 3 warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fec_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from qpsk_tpu_torch.ops.cuda import _lib
    from qpsk_tpu_torch.ops.cuda import ldpc_kernel as lk
    from qpsk_tpu_torch.ops.cuda import viterbi_kernel as vk
    from qpsk_tpu_torch.packet import ConvCode, LdpcCode

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; kernels of {root}")
    _lib.library()
    dev = torch.device("cuda", 0)
    conv, ldpc = ConvCode(), LdpcCode(k=256)
    decoders = {"viterbi": (524, lambda x: vk.viterbi_decode(conv, x, 256)),
                "ldpc": (512, lambda x: lk.ldpc_decode(ldpc, x))}
    gen = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for name, (n, decode) in decoders.items():
        out[name] = {}
        for b in BATCHES[name]:
            llrs = torch.randn((b, n), generator=gen, device=dev)
            times = [graph_ms(lambda: decode(llrs)), graph_ms(lambda: decode(llrs)),
                     host_ms(lambda: decode(llrs))]
            out[name][str(b)] = times
            print(f"  {name:8s} at {b:5d} packets: kernel alone {times[0]:.4f} / "
                  f"{times[1]:.4f} ms, launched from the host {times[2]:.4f} ms")
    print(json.dumps({"card": card, "root": root, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
