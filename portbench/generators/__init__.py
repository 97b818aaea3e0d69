"""Traffic generators, one module a kind of cell, found by the name that a
traffic file (``portbench/traffic/<mix>.json``) gives under
``"generator"``, the same way the per-layer metrics are found.

A generator module holds all that is particular to its kind of cell:

* ``check(cell)``: raise ValueError where the configuration is not one
  this generator drives;
* ``channels(cell)``: the receiver channels a call carries;
* ``make(cell, seed, device)``: the stimulus, made on the device from the
  seed: a dict with ``calls`` (one contiguous input tensor a call of one
  period, which the window replays), ``warm_freq`` (each loop's start
  frequency) and ``judged`` (the channels the judge compares), and
  whatever its ``numbers`` reads;
* ``System(cell, device, stim, spans)``: the program's calls on the timed
  path (``init()``, ``call(state, x)``, ``view(state, out)``), each stage
  inside a ``portbench.<stage>`` range where ``spans`` is set;
* ``numbers(cell, stim, rec, device, last)``: the compared numbers of one
  call, worked out again by ``portbench.reference`` (``portbench.judge``);
* ``Control(cell, device, stim)``: ``System``'s interface over
  the reference one precision step below the configuration's
  (``portbench.control``).

A new kind of cell is a new module here; it may build on these.
"""

from __future__ import annotations

import contextlib
import importlib

import torch


def find(name: str):
    """The generator module ``name``; ValueError if there is none."""
    mod = f"portbench.generators.{name}"
    try:
        return importlib.import_module(mod)
    except ModuleNotFoundError as e:
        if e.name != mod:
            raise
        raise ValueError(f"unknown generator {name!r}") from None


def span(name: str, on: bool):
    """A ``portbench.<name>`` range for the traced window, or nothing."""
    return (torch.profiler.record_function(f"portbench.{name}") if on
            else contextlib.nullcontext())
