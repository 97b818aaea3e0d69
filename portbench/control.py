"""The control: ``portbench.reference`` put in the program's place and
computed one step below the precision each stage states, the step a later
change could be tempted to take.  The modem's matched filter states
float32, which the program's kernel keeps by three float16 tensor-core
passes: the control rounds the filter's samples and taps to float16, one
pass.  Each cell's generator adds its own stages' (``Control`` in
``portbench.generators``): the Viterbi decoder's path metrics in bfloat16,
the FDM bank's cosine product in TF32.  ``correct`` has to come out false on it.

Run on the card at a cell's own size::

    python3 -m portbench.control --workload qpsk2400.gw8192 --seeds 1 2 3

prints, for each seed, the judge's numbers of the control's first two calls
and those of the program's first two calls on the same stimulus, which is
how the limits' upper and lower readings are read (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

from portbench import judge


def first_two(cell, stim: dict, system, device) -> dict:
    """The judge's numbers of ``system``'s first two calls on ``stim``
    (call 0 from the initial state, call 1 from call 0's state), each the
    worse of the two, and under ``"each"`` the two calls' own."""
    calls = stim["calls"]
    st0 = system.init()
    st1, out0 = system.call(st0, calls[0])
    st2, out1 = system.call(st1, calls[1 % len(calls)])
    recs = [judge.Compared(0, None, system.view(st1, out0)),
            judge.Compared(1, system.view(st1), system.view(st2, out1))]
    worst, _, _, each = judge.judge(cell, stim, recs, device)
    return {**worst, "each": each}


def main(argv=None) -> int:
    from portbench.cell import load

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = load(pathlib.Path.cwd(), args.workload)
    for seed in args.seeds:
        stim = cell.gen.make(cell, seed, dev)
        rec = {"seed": seed,
               "control": first_two(cell, stim,
                                    cell.gen.Control(cell, dev, stim), dev),
               "program": first_two(cell, stim,
                                    cell.gen.System(cell, dev, stim), dev)}
        print(json.dumps(rec), flush=True)
        del stim
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
