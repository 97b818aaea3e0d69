"""The port's ``tx`` and ``rx`` against the JAX CLI's through files
(``--device cpu``, in process): spools and 48 kHz WAVs cross between the
packages with the same decisions, ``rx --stream`` prints the JAX CLI's
hex lines and counters on the same spool (also from stdin, and resumed
through ``--state-file`` across the two packages), ``tx --stream-in``
writes the JAX CLI's PCM within 3 LSB and decodes back, and a malformed
payload line gives the JAX CLI's rc and message."""

import io
import json
import sys

import numpy as np
import pytest
import torch

from qpsk_tpu import cli as jcli
from qpsk_tpu_torch import cli as tcli
from torch_cli_common import load_jax_io, records, run

torch.set_num_threads(2)

CLIS = {"jax": jcli, "torch": tcli}


@pytest.fixture(autouse=True, scope="module")
def _jax_io_built():
    load_jax_io()


def tx_file(capsys, mod, path, *argv):
    rc, lines, _ = run(capsys, mod, ["tx", "--out", str(path)] + list(argv))
    assert rc == 0
    return records(lines)[0]


@pytest.mark.parametrize("suffix,rate", [(".raw", []),
                                         (".wav", ["--io-rate", "48000"])],
                         ids=["spool", "wav48k"])
def test_files_cross_packages(tmp_path, capsys, suffix, rate):
    """Each package's ``tx`` file, received by each package's ``rx``: the
    same frames, sync score, packets and PER (0), offsets within 0.05 Hz;
    the two files within 1 LSB of each other."""
    pcm = {}
    for name, mod in CLIS.items():
        path = tmp_path / f"{name}{suffix}"
        rec = tx_file(capsys, mod, path, "--frames", "20", "--seed", "3",
                      *rate)
        assert rec["sample_rate"] == (48000 if rate else 9600)
        pcm[name] = np.fromfile(path, np.int16)
    assert pcm["jax"].size == pcm["torch"].size
    assert np.abs(pcm["jax"].astype(np.int32) - pcm["torch"]).max() <= 1
    for writer in CLIS:
        path = str(tmp_path / f"{writer}{suffix}")
        got = {}
        for name, mod in CLIS.items():
            rc, lines, _ = run(capsys, mod, ["rx", path])
            assert rc == 0
            (got[name],) = records(lines)
        j, t = got["jax"], got["torch"]
        for key in ("frames", "sync_score", "packets", "per"):
            assert t[key] == j[key], (writer, key, t, j)
        assert abs(t["detected_offset_hz"] - j["detected_offset_hz"]) <= 0.05
        assert t["per"] == 0.0 and t["sync_score"] >= 3


def test_wav_rate_mismatch_matches_jax(tmp_path, capsys):
    path = str(tmp_path / "x.wav")
    tx_file(capsys, tcli, path, "--frames", "8", "--io-rate", "48000")
    got = [run(capsys, mod, ["rx", path, "--io-rate", "44100"])
           for mod in CLIS.values()]
    assert got[0][0] == got[1][0] == 2 and got[0][2] == got[1][2]


def rx_stream(capsys, mod, argv):
    """(hex lines, counters) of ``rx --stream``."""
    rc, lines, err = run(capsys, mod, ["rx"] + argv + ["--stream"])
    assert rc == 0
    return lines, json.loads(err[-1])


def assert_same_counters(j, t):
    assert set(t) == set(j)
    for key in ("frames", "packets", "crc_ok", "crc_failures", "resyncs",
                "synced", "carrier_detect"):
        assert t[key] == j[key], (key, t, j)
    assert abs(t["detected_offset_hz"] - j["detected_offset_hz"]) <= 0.05
    assert abs(t["carrier_snr_db"] - j["carrier_snr_db"]) <= 0.05


def test_rx_stream_matches_jax(tmp_path, capsys, monkeypatch):
    """The same spool, in chunks of 3000 samples from a file and of 32768
    from stdin: the JAX CLI's hex lines and counters; the lines are the
    payloads ``tx --seed 5`` sent."""
    spool = tmp_path / "s.raw"
    tx_file(capsys, jcli, spool, "--frames", "30", "--seed", "5")
    jl, jc = rx_stream(capsys, jcli, [str(spool), "--chunk", "3000"])
    tl, tc = rx_stream(capsys, tcli, [str(spool), "--chunk", "3000"])
    assert tl == jl and len(tl) >= 18
    assert_same_counters(jc, tc)
    from qpsk_tpu_torch.packet.bits import np_bits_to_bytes
    sent = np.random.default_rng(5).integers(0, 2, (30, 240), dtype=np.int32)
    assert set(tl) <= {np_bits_to_bytes(b).tobytes().hex() for b in sent}
    monkeypatch.setattr(sys, "stdin",
                        io.TextIOWrapper(io.BytesIO(spool.read_bytes())))
    sl, sc = rx_stream(capsys, tcli, ["-"])
    assert sl == tl[:len(sl)] and len(sl) >= len(tl) - 1
    assert sc["synced"]


@pytest.mark.parametrize("first,second", [("torch", "torch"),
                                          ("jax", "torch"),
                                          ("torch", "jax")])
def test_state_file_resume_matches_jax(tmp_path, capsys, first, second):
    """A spool cut in two mid-frame: the first half through ``--stream
    --state-file`` of one package, the second resumed by the same or the
    other package, gives the hex lines of the JAX CLI's own cut run."""
    spool = tmp_path / "s.raw"
    tx_file(capsys, jcli, spool, "--frames", "40", "--seed", "8")
    pcm = np.fromfile(spool, np.int16)
    cut = pcm.size // 2 + 777
    a, b = tmp_path / "a.raw", tmp_path / "b.raw"
    pcm[:cut].tofile(a)
    pcm[cut:].tofile(b)
    lines = {}
    for key, (p1, p2) in {"ref": ("jax", "jax"),
                          "got": (first, second)}.items():
        state = str(tmp_path / f"{key}.npz")
        l1, _ = rx_stream(capsys, CLIS[p1], [str(a), "--state-file", state])
        l2, c2 = rx_stream(capsys, CLIS[p2], [str(b), "--state-file", state])
        lines[key] = (l1 + l2, c2)
    assert lines["got"][0] == lines["ref"][0]
    assert len(lines["got"][0]) >= 25
    assert_same_counters(lines["ref"][1], lines["got"][1])


def payload_file(path, n, seed):
    rng = np.random.default_rng(seed)
    hexes = [rng.integers(0, 256, 30, dtype=np.uint8).tobytes().hex()
             for _ in range(n)]
    path.write_text("\n".join(hexes) + "\n")
    return hexes


@pytest.mark.parametrize("rate", [[], ["--io-rate", "8000"]],
                         ids=["modem_rate", "io8000"])
def test_tx_stream_in_matches_jax(tmp_path, capsys, rate):
    """``tx --stream-in``: the JAX CLI's counters, its PCM within 3 LSB
    (the carried phasor), and ``rx --stream`` decodes the lines sent.  At
    8000 S/s M=6 does not divide a packet's samples: the remainder
    carries across lines instead of padding each."""
    hexes = payload_file(tmp_path / "p.hex", 30, 11)
    pcm = {}
    for name, mod in CLIS.items():
        out = tmp_path / f"{name}.raw"
        rc, _, err = run(capsys, mod, ["tx", "--stream-in",
                                       str(tmp_path / "p.hex"), "--out",
                                       str(out)] + rate)
        assert rc == 0
        pcm[name] = (np.fromfile(out, np.int16), json.loads(err[-1]))
    assert pcm["torch"][1] == pcm["jax"][1]
    assert pcm["torch"][1]["packets"] == 30
    assert np.abs(pcm["torch"][0].astype(np.int32) - pcm["jax"][0]).max() <= 3
    got, _ = rx_stream(capsys, tcli, [str(tmp_path / "torch.raw")] + rate)
    assert len(got) >= 15 and set(got) <= set(hexes)


@pytest.mark.parametrize("line", ["zz-not-hex", "00ff"],
                         ids=["not_hex", "short"])
def test_tx_stream_bad_line_matches_jax(tmp_path, capsys, monkeypatch,
                                        line):
    got = []
    for mod in CLIS.values():
        monkeypatch.setattr(sys, "stdin", io.StringIO(line + "\n"))
        rc, _, err = run(capsys, mod, ["tx", "--stream-in", "-", "--out",
                                       str(tmp_path / "o.raw")])
        got.append((rc, err))
    assert got[1] == got[0] and got[1][0] == 2, got
