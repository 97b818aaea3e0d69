"""The frozen roofline copy gives the program's ``utils/roofline.py``
values at the cells' shapes, and the metrics' bounds come from it."""

import json

import pytest

from portbench import frozen_roofline as frozen
from portbench.cell import load
from portbench.metrics import (costas_roofline, fdm_bank_roofline,
                               frontend_roofline, viterbi_roofline)
from portbench.tests.conftest import REPO, write_root
from qpsk_tpu_torch.utils import roofline as live


@pytest.mark.parametrize("c", [8192, 1023])
def test_frontend_and_costas_match(c):
    assert frozen.frontend_work(c, 8, 4, True, False) == \
        live.frontend_work(c, 8, 4, True, False)
    assert frozen.costas_work(c, 1024, 128) == live.costas_work(c, 1024, 128)


def test_viterbi_matches():
    assert frozen.viterbi_work(32018) == live.fec_work("viterbi", 32018)


def _repo_cell(tmp_path, config: str, traffic: str):
    """A cell of a repository configuration and traffic file."""
    mix = json.loads((REPO / "portbench" / "traffic" / f"{traffic}.json")
                     .read_text())
    name = f"{config}.{traffic}"
    return load(write_root(tmp_path, {name: (config, traffic)}, (mix,)),
                name)


def test_metric_bounds_at_the_cells(tmp_path):
    gw = load(REPO, "qpsk2400.gw8192")
    assert frontend_roofline.work_ms(gw) == \
        live.frontend_work(8192, 8, 4, True, False)[0]
    assert costas_roofline.work_ms(gw) == live.costas_work(8192, 1024,
                                                           128)[0]
    coded = _repo_cell(tmp_path, "qpsk2400-conv", "coded8192")
    bits = 8192 * coded.frames * 256
    assert viterbi_roofline.packets(coded) == -(-bits // 524)


def test_fdm_bank_bound(tmp_path):
    """The bank's bound at 2048 slots x 8 frames: its bytes and an FFT's
    operations, 7-8 us."""
    fdm = _repo_cell(tmp_path, "qpsk2400", "fdm2048")
    assert fdm.channels == 1023
    assert 0.007 < fdm_bank_roofline.work_ms(fdm) < 0.008
