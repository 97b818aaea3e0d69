"""The port's native IO (``qpsk_tpu_torch.io``, its own copy of
``qpsk_io.cc``) against the JAX package's (``qpsk_tpu.io``): spool and WAV
files written by one package read by the other sample for sample, the
ring's back-pressure, the native CRC, scrambler and interleaver equal to
the port's torch packet ops, and the library built from the port's copy
into ``qpsk_tpu_torch/_build/`` without importing the JAX package, once
when several processes load it at the same time."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import qpsk_tpu.io as jio
import qpsk_tpu_torch.io as tio
from qpsk_tpu_torch.io import native
from qpsk_tpu_torch.packet import (crc16, deinterleave_bits, interleave_bits,
                                   scramble_bits)
from torch_cli_common import load_jax_io

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = {"jax": jio, "torch": tio}


@pytest.fixture(autouse=True, scope="module")
def _jax_io_built():
    load_jax_io()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_spool_crosses_packages(tmp_path, writer, reader):
    """Frames written by one package's ``SpoolWriter`` read by the other's
    ``SpoolReader``; a trailing partial frame ends the iteration."""
    path = str(tmp_path / "s.raw")
    rng = np.random.default_rng(0)
    frames = rng.integers(-32768, 32767, (7, 512), dtype=np.int16)
    with PACKAGES[writer].SpoolWriter(path, 512) as w:
        assert w.write(frames) == 7
    with PACKAGES[reader].SpoolReader(path, 512) as r:
        got = r.read(10)   # more than there is: a short read
    np.testing.assert_array_equal(got, frames)
    with open(path, "ab") as fh:
        fh.write(np.arange(100, dtype=np.int16).tobytes())
    with PACKAGES[reader].SpoolReader(path, 512) as r:
        assert len(list(r)) == 7


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_wav_crosses_packages(tmp_path, writer, reader):
    path = str(tmp_path / "x.wav")
    rng = np.random.default_rng(2)
    pcm = rng.integers(-20000, 20000, 9601, dtype=np.int16)
    PACKAGES[writer].write_wav(path, pcm, 48000)
    got, sr = PACKAGES[reader].read_wav(path)
    assert sr == 48000
    np.testing.assert_array_equal(got, pcm)
    assert pathlib.Path(path).read_bytes()[:44] == _header(pcm.size, 48000)


def _header(n, sr):
    """The 44-byte mono 16-bit PCM WAV header both packages write."""
    import struct
    return struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + 2 * n, b"WAVE",
                       b"fmt ", 16, 1, 1, sr, 2 * sr, 2, 16, b"data", 2 * n)


def test_wav_and_spool_refusals(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    with pytest.raises(OSError):
        tio.read_wav(str(bad))
    with pytest.raises(OSError):
        tio.SpoolReader(str(tmp_path / "missing" / "s.raw"), 512)
    with tio.SpoolWriter(str(tmp_path / "s.raw"), 512) as w:
        with pytest.raises(ValueError):
            w.write(np.zeros((2, 256), np.int16))


def test_ring_backpressure_and_wrap():
    """A full ring takes what fits and says how many; popping frees room;
    the data wraps around the end in order."""
    r = tio.Ring(256)
    a = np.arange(300, dtype=np.int16)
    assert r.push(a) == 256 and r.available == 256
    assert r.push(a) == 0
    np.testing.assert_array_equal(r.pop(200), a[:200])
    b = np.arange(1000, 1150, dtype=np.int16)
    assert r.push(b) == 150
    np.testing.assert_array_equal(r.pop(1000),
                                  np.concatenate([a[200:256], b]))
    assert r.available == 0 and r.pop(5).size == 0
    for bad in (300, 0, -4):
        with pytest.raises(ValueError):
            tio.Ring(bad)


def test_native_crc16_equals_torch_crc():
    rng = np.random.default_rng(4)
    for n in (1, 9, 32, 500):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        assert tio.native_crc16(data) == int(crc16(torch.from_numpy(data)))
        assert tio.native_crc16(data) == jio.native_crc16(data)
    assert tio.native_crc16(np.frombuffer(b"123456789", np.uint8)) == 0x29B1


@pytest.mark.parametrize("nbits", [64, 256, 512, 1000])
def test_native_scramble_equals_torch(nbits):
    bits = np.random.default_rng(nbits).integers(0, 2, nbits, dtype=np.uint8)
    got = tio.native_scramble_bits(bits)
    want = scramble_bits(torch.from_numpy(bits.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.uint8))
    np.testing.assert_array_equal(tio.native_scramble_bits(got), bits)


@pytest.mark.parametrize("nbits", [64, 176, 256, 2048])
def test_native_interleave_equals_torch(nbits):
    bits = np.random.default_rng(nbits).integers(0, 2, nbits, dtype=np.uint8)
    got = tio.native_interleave_bits(bits)
    t = torch.from_numpy(bits.astype(np.int32))
    np.testing.assert_array_equal(got, interleave_bits(t).numpy())
    np.testing.assert_array_equal(
        tio.native_interleave_bits(bits, deinterleave=True),
        deinterleave_bits(t).numpy())
    np.testing.assert_array_equal(
        tio.native_interleave_bits(got, deinterleave=True), bits)


def test_native_interleave_refuses_non_bijective():
    """694 bits: the saturated prime 347 divides it, so the map is not a
    permutation; the native op and the torch op both refuse."""
    bits = np.zeros(694, np.uint8)
    with pytest.raises(ValueError):
        tio.native_interleave_bits(bits)
    with pytest.raises(ValueError):
        interleave_bits(torch.zeros(694, dtype=torch.int32))


def test_library_builds_from_the_ports_copy():
    """In a fresh process: importing ``qpsk_tpu_torch.io`` and using it
    leaves the JAX package unimported, and the loaded library is the one
    built from ``qpsk_tpu_torch/io/qpsk_io.cc`` into
    ``qpsk_tpu_torch/_build/``."""
    code = ("import sys, numpy as np\n"
            "import qpsk_tpu_torch.io as tio\n"
            "from qpsk_tpu_torch.io import native\n"
            "lib = native.load()\n"
            "assert tio.native_crc16(np.zeros(3, np.uint8)) >= 0\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'qpsk_tpu.')) or m == 'qpsk_tpu')\n"
            "print(lib._name)\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    lib = pathlib.Path(out[0])
    assert lib.parent == REPO / "qpsk_tpu_torch" / "_build"
    assert lib.name.startswith("libqpsk_io-") and lib.exists()
    assert out[1] == "", out[1]
    assert native.SRC == REPO / "qpsk_tpu_torch" / "io" / "qpsk_io.cc"


def test_concurrent_builds_make_one_library(tmp_path):
    """Four processes load the library at once into an empty build
    directory: each loads, the exclusive lock lets one build, and no
    temporary file is left."""
    code = ("import sys, pathlib\n"
            "from qpsk_tpu_torch.io import native\n"
            "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "lib = native.load()\n"
            "assert lib.crc16_native(None, 0) == 0xFFFF\n"
            "print(lib._name)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    names = set()
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err
        names.add(out.strip())
    assert len(names) == 1
    files = sorted(f.name for f in tmp_path.iterdir())
    assert files == sorted([pathlib.Path(names.pop()).name,
                            "libqpsk_io.lock"]), files
