"""The control, the reference one precision step below the configuration's
in the program's place, comes out as not correct; the program's own first
calls come out correct."""

import pytest
import torch

from portbench.cell import load
from portbench.control import first_two
from portbench.tests.conftest import CELLS


def _over(cell, got):
    lim = cell.limits()
    return [n for n, v in got.items() if n in lim and v > lim[n]]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails(tiny_root, workload):
    dev = torch.device("cpu")
    cell = load(tiny_root, workload)
    stim = cell.gen.make(cell, 31, dev)
    got = first_two(cell, stim, cell.gen.Control(cell, dev, stim),
                    dev)
    assert _over(cell, got), got
    own = first_two(cell, stim, cell.gen.System(cell, dev, stim), dev)
    assert not _over(cell, own), own
