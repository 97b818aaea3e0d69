"""The port's ``loopback`` against the JAX CLI's through the deterministic
impairments and the options they pair with (``--device cpu``, in
process): a 40 ppm clock offset with tracking timing, two-ray multipath
with the CMA, a -20 dB level with the AGC, 1200 baud and a Doppler
chirp; then ``sweep`` and ``fdm`` on the port alone (their noise is the
port's own, so they are held to the JAX CLI tests' bounds, not to its
numbers)."""

import pytest
import torch

from qpsk_tpu import cli as jcli
from qpsk_tpu_torch import cli as tcli
from torch_cli_common import assert_same_link, loopback_both, records, run

torch.set_num_threads(2)


@pytest.mark.parametrize("argv", [
    ["--frames", "20", "--clock-ppm", "40", "--timing", "tracking"],
    ["--frames", "20", "--multipath", "0:1.0,4:0.5", "--eq-taps", "9"],
    ["--frames", "20", "--agc", "--level-db", "-20"],
    ["--frames", "24", "--baud", "1200"],
    ["--frames", "20", "--doppler", "2"],
], ids=["clock_tracking", "multipath_cma", "level_agc", "baud1200",
        "doppler"])
def test_noiseless_loopback_options_match_jax(capsys, argv):
    assert_same_link(*loopback_both(capsys, argv))


def test_coded_frames_error_matches_jax(capsys):
    """A coded link needs 16 frames: the JAX CLI's rc and message."""
    argv = ["loopback", "--frames", "12", "--fec", "conv"]
    got = [run(capsys, mod, argv) for mod in (jcli, tcli)]
    assert got[1][0] == got[0][0] == 2 and got[1][2] == got[0][2]


def test_sweep_points(capsys):
    rc, lines, _ = run(capsys, tcli, ["sweep", "--snr-db", "12,14",
                                      "--frames", "24"])
    assert rc == 0
    recs = records(lines)
    assert [r["snr_db"] for r in recs] == [12.0, 14.0]
    assert set(recs[0]) == {"snr_db", "per", "ber", "evm_rms",
                            "detected_hz", "packets", "sync_score"}
    assert recs[1]["per"] == 0.0 and recs[1]["sync_score"] == 4
    assert recs[0]["evm_rms"] > recs[1]["evm_rms"]


def test_fdm_three_channels(capsys):
    rc, lines, _ = run(capsys, tcli, ["fdm", "--frames", "16", "--snr-db",
                                      "18"])
    assert rc == 0
    (rec,) = records(lines)
    assert (rec["nslots"], rec["nchan"], rec["wide_fs"]) == (8, 3, 76800.0)
    for c, ch in enumerate(rec["channels"]):
        assert ch["chan"] == c and ch["carrier_hz"] == (c + 1) * 9600 + 1500
        assert ch["per"] == 0.0 and ch["sync_score"] >= 3
        assert abs(ch["detected_offset_hz"] - 50.0) < 3.0
