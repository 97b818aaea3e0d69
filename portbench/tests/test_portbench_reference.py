"""The reference agrees with the program's plain PyTorch path on tiny
seamless stimuli, every whole packet of the coded link arrives, and
``failed`` reads 0."""

import time

import pytest
import torch

from portbench import harness, stimulus
from portbench.cell import load
from portbench.reference import packet as ref_packet
from portbench.tests.conftest import CELLS


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_program_agrees_with_reference(tiny_root, workload):
    res = harness.run(tiny_root, workload, 2**31 + 11, 0.3, False,
                      torch.device("cpu"), time.perf_counter())
    assert res["correct"], res
    assert res["failed"] == 0
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name
    if "conv" in workload:
        assert res["info"]["packets_lost"] == 0


def test_stimulus_repeats_from_its_seed(tiny_root):
    cell = load(tiny_root, "qpsk2400.tiny")
    a = cell.gen.make(cell, 5, torch.device("cpu"))["calls"]
    b = cell.gen.make(cell, 5, torch.device("cpu"))["calls"]
    c = cell.gen.make(cell, 6, torch.device("cpu"))["calls"]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_packets_decode_to_their_payload():
    gen = torch.Generator().manual_seed(1)
    pay, frame = stimulus.packets(gen, 6, 30, torch.device("cpu"))
    assert frame.shape == (6, 524)
    got, ok = ref_packet.decode((1.0 - 2.0 * frame).float(), 240)
    assert ok.all() and torch.equal(got, pay)


def test_crc_known_answer():
    data = torch.tensor([list(b"123456789")])
    assert int(ref_packet.crc16(data)[0]) == 0x29B1
