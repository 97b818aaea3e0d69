"""Helpers of the scale-out tests (``tests/test_torch_parallel.py``,
``test_torch_multihost.py``, ``test_torch_benchmarks.py``): gloo ranks in
worker processes that import only the port, joined on a ``FileStore`` in
the test's directory (no ports, so parallel test workers never collide),
the whole lot under one deadline.

A worker is ``HEAD + body + TAIL``: ``HEAD`` reads the rank, the world
size, the store and the shared directory ``io`` from its arguments,
starts the group and defines ``gather``; ``TAIL`` waits for every rank,
destroys the group and prints ``WORKER_OK <rank>``.
"""

import os
import subprocess
import sys
import time

WORLD = 4

HEAD = r'''
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from qpsk_tpu_torch.parallel import multihost

rank, world, store, io = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
multihost.initialize(f"file://{store}", world, rank, device="cpu")


def gather(t):
    """``t`` of every rank, concatenated on the leading axis in rank
    order, as numpy."""
    t = torch.as_tensor(t).contiguous()
    g = t.new_empty((world * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(g, t)
    return g.numpy()
'''

TAIL = r'''
dist.barrier()
dist.destroy_process_group()
print("WORKER_OK", rank, flush=True)
'''


def spawn_ranks(body: str, io, timeout_s: float, world: int = WORLD) -> None:
    """Run ``HEAD + body + TAIL`` as ranks 0..world-1 with ``io`` as their
    shared directory (the store at ``io/store``); raises with their
    output if one fails or the lot outlives ``timeout_s``."""
    io = str(io)
    worker = os.path.join(io, "worker.py")
    with open(worker, "w") as fh:
        fh.write(HEAD + body + TAIL)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    store = os.path.join(io, "store")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(world), store, io],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in text, \
            f"rank {r} exited {p.returncode}:\n{text[-3000:]}"
