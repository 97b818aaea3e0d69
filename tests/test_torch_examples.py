"""The port's examples (``qpsk_tpu_torch/examples``) on the CPU, each at
the smallest size at which its links still decode, through its ``main``:
the decode lines they print (sync, packets, PER) must show the links
working, as the JAX twins' do at their sizes."""

import re

import torch

from qpsk_tpu_torch.examples import (end_to_end, modulation_family,
                                     streaming_receiver)

torch.set_num_threads(2)


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_end_to_end(capsys):
    assert end_to_end.main(["--device", "cpu", "--frames", "40",
                            "--fdm-frames", "16"]) == 0
    out = _lines(capsys)
    acq = float(re.search(r"acquisition: ([+-][\d.]+) Hz", out[0]).group(1))
    assert abs(acq - 137.0) < 5.0
    assert re.search(r"score [34]/4", out[2])
    ok, n = map(int, re.search(r"packets: (\d+)/(\d+)", out[3]).groups())
    assert n >= 28 and ok >= n - 1
    ok, n = map(int, re.search(r"coded @ 6 dB: (\d+)/(\d+)", out[4]).groups())
    assert n >= 28 and ok >= 0.75 * n
    fdm = [tuple(map(int, re.search(r"(\d+)/(\d+) CRC-pass", ln).groups()))
           for ln in out[5:]]
    assert len(fdm) == 3 and all(n >= 6 and ok == n for ok, n in fdm)


def test_modulation_family(capsys):
    assert modulation_family.main(["--device", "cpu", "--frames", "32"]) == 0
    rows = [ln.split() for ln in _lines(capsys)[1:]]
    assert [r[0] for r in rows] == ["bpsk", "qpsk", "8psk", "16qam"]
    for r in rows:
        assert r[3] == "4/4", r
        ok, n = int(r[4].rstrip("/")), int(r[5])
        assert n >= 10 and ok == n, r


def test_streaming_receiver(capsys):
    assert streaming_receiver.main(["--device", "cpu", "--packets",
                                    "16"]) == 0
    out = _lines(capsys)
    good = int(re.search(r"decoded (\d+) CRC-good", out[0]).group(1))
    assert good >= 24
    assert "resyncs=1" in out[1] and out[2] == "ok"
    first, second, total = map(int, re.search(
        r"resume: (\d+)\+(\d+) packets .* == (\d+)", out[3]).groups())
    assert first + second == total >= 8
