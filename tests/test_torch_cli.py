"""The port's command line (``python -m qpsk_tpu_torch``) against the JAX
package's (``python -m qpsk_tpu``), in process, with ``--device cpu``:
noiseless ``loopback`` runs give the JAX CLI's JSON (``per``,
``sync_score``, ``packets`` and ``sync_rotation_deg`` equal,
``detected_offset_hz`` within 0.05, ``evm_rms`` within 1e-3) for the
default link, the convolutional code and DQPSK (``test_torch_cli_modes.py``
and ``test_torch_cli_options.py`` hold the other flags); the noisy links
decode; the error exits match; without a card and without ``--device
cpu`` the CLI exits non-zero, ``python -m qpsk_tpu_torch`` included.  The payloads of both CLIs come
from ``np.random.default_rng(--seed)``; their noise does not match
(``torch.Generator`` against JAX keys), so only noiseless runs are
compared number for number."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from qpsk_tpu import cli as jcli
from qpsk_tpu_torch import cli as tcli
from torch_cli_common import assert_same_link, loopback_both, records, run

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("argv", [
    ["--frames", "20"],
    ["--frames", "20", "--fec", "conv"],
    ["--frames", "20", "--differential"],
], ids=["default", "conv", "dqpsk"])
def test_noiseless_loopback_matches_jax(capsys, argv):
    assert_same_link(*loopback_both(capsys, argv))


@pytest.mark.parametrize("argv", [
    ["--snr-db", "14"],
    ["--snr-db", "14", "--payload-bytes", "64"],
    ["--snr-db", "6", "--fec", "conv", "--frames", "20"],
], ids=["snr14", "snr14_payload64", "conv6"])
def test_noisy_loopback_decodes(capsys, argv):
    """With the port's own noise: no packet lost at 14 dB (the JAX CLI's
    test), every coded packet at 6 dB within a few."""
    rc, lines, _ = run(capsys, tcli, ["loopback", "--frames", "20"] + argv)
    assert rc == 0
    (rec,) = records(lines)
    assert rec["sync_score"] >= 3 and abs(rec["detected_offset_hz"]
                                          - 50.0) < 3.0
    if "conv" in argv:
        assert rec["per"] <= 0.2 and rec["sync_score"] >= 6
    else:
        assert rec["per"] == 0.0


@pytest.mark.parametrize("argv", [
    ["loopback", "--frames", "4"],
    ["fdm", "--frames", "7"],
    ["sweep", "--snr-db", "3,x"],
    ["tx", "--io-rate", "9601", "--stream-in", "-", "--out", "-"],
    ["rx", "-", "--stream", "--io-rate", "9601"],
    ["rx", "x.wav", "--stream"],
], ids=["frames", "fdm_frames", "snr_list", "tx_io_rate", "rx_io_rate",
        "stream_wav"])
def test_error_exits_match_jax(capsys, argv):
    """The JAX CLI's rc and message for bad arguments."""
    got = []
    for mod in (jcli, tcli):
        rc, _, err = run(capsys, mod, argv)
        got.append((rc, err[-1] if err else ""))
    assert got[1] == got[0] and got[1][0] == 2, got


def test_no_card_exits_without_device_cpu(capsys, monkeypatch):
    """Without a card the CLI refuses the default ``--device cuda`` with
    code 2 and a message, before any work; it never falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["loopback", "--frames", "20"], ["sweep"],
                 ["rx", "nothing.raw"], ["fdm"],
                 ["loopback", "--device", "cuda"]):
        assert tcli.main(argv) == 2
        cap = capsys.readouterr()
        assert cap.out == "" and "--device cpu" in cap.err


def test_python_dash_m_entry_point():
    """``python -m qpsk_tpu_torch`` runs the CLI: with no card visible it
    exits 2 unless given ``--device cpu``, with which it decodes."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "qpsk_tpu_torch", "loopback", "--frames",
           "8"]
    p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 2 and "no CUDA device" in p.stderr
    assert p.stdout == ""
    p = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    rec = json.loads(p.stdout)
    assert rec["sync_score"] >= 3 and rec["per"] == 0.0
