"""Native streaming IO (port of ``qpsk_tpu.io``): thin Python wrappers over
the port's own C++ library (``qpsk_io.cc``, built by ``native.load``).

* ``SpoolReader`` / ``SpoolWriter`` — framed int16 PCM spool files with the
  reference's short-read-terminates semantics;
* ``read_wav`` / ``write_wav`` — 16-bit mono WAV;
* ``Ring`` — lock-free SPSC int16 ring buffer for real-time capture ->
  device pipelines;
* ``native_crc16`` / ``native_scramble_bits`` / ``native_interleave_bits``
  — host-side twins of the packet ops (bit for bit equal to
  ``qpsk_tpu_torch.packet``'s).

The file formats are the JAX package's, so a file written by either
package reads in the other.
"""

from __future__ import annotations

import ctypes

import numpy as np

from qpsk_tpu_torch.io.native import load


def _i16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class SpoolWriter:
    """Framed int16 PCM writer (the TX side of qpsk.h:14's spool)."""

    def __init__(self, path: str, frame_len: int):
        self._lib = load()
        self._h = self._lib.spool_open(str(path).encode(), b"wb")
        if not self._h:
            raise OSError(f"cannot open {path}")
        self.frame_len = frame_len

    def write(self, frames: np.ndarray) -> int:
        """Write (..., frame_len) int16 frames; returns the frames
        written."""
        frames = np.ascontiguousarray(frames, dtype=np.int16)
        if frames.shape[-1] != self.frame_len:
            raise ValueError(f"frames of shape {frames.shape}, expected "
                             f"(..., {self.frame_len})")
        nf = int(np.prod(frames.shape[:-1])) if frames.ndim > 1 else 1
        return int(self._lib.spool_write(self._h, _i16p(frames),
                                         self.frame_len, nf))

    def close(self):
        if self._h:
            self._lib.spool_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class SpoolReader:
    """Framed int16 PCM reader; iteration ends on a short read
    (qpsk.c:348-351 semantics)."""

    def __init__(self, path: str, frame_len: int):
        self._lib = load()
        self._h = self._lib.spool_open(str(path).encode(), b"rb")
        if not self._h:
            raise OSError(f"cannot open {path}")
        self.frame_len = frame_len

    def read(self, nframes: int) -> np.ndarray:
        buf = np.empty((nframes, self.frame_len), dtype=np.int16)
        got = int(self._lib.spool_read(self._h, _i16p(buf),
                                       self.frame_len, nframes))
        return buf[:got]

    def __iter__(self):
        while True:
            f = self.read(1)
            if f.shape[0] == 0:
                return
            yield f[0]

    def close(self):
        if self._h:
            self._lib.spool_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    samples = np.ascontiguousarray(samples, dtype=np.int16).ravel()
    rc = load().wav_write(str(path).encode(), _i16p(samples), samples.size,
                          int(sample_rate))
    if rc != 0:
        raise OSError(f"wav_write failed for {path}")


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """(int16 samples, sample rate) of a 16-bit mono PCM WAV file."""
    lib = load()
    sr = ctypes.c_int32(0)
    n = int(lib.wav_read(str(path).encode(), None, 0, ctypes.byref(sr)))
    if n < 0:
        raise OSError(f"wav_read failed for {path}")
    buf = np.empty(n, dtype=np.int16)
    got = int(lib.wav_read(str(path).encode(), _i16p(buf), n,
                           ctypes.byref(sr)))
    return buf[:got], int(sr.value)


class Ring:
    """Lock-free SPSC int16 ring buffer (capacity must be a power of 2).
    ``push`` takes what fits and returns how many it took: the producer
    sees the back-pressure."""

    def __init__(self, capacity: int):
        self._lib = load()
        self._h = self._lib.ring_create(capacity)
        if not self._h:
            raise ValueError("capacity must be a positive power of two")

    def push(self, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, dtype=np.int16).ravel()
        return int(self._lib.ring_push(self._h, _i16p(samples), samples.size))

    def pop(self, n: int) -> np.ndarray:
        buf = np.empty(n, dtype=np.int16)
        got = int(self._lib.ring_pop(self._h, _i16p(buf), n))
        return buf[:got]

    @property
    def available(self) -> int:
        return int(self._lib.ring_available(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None


def native_crc16(data: np.ndarray) -> int:
    """CRC-16/CCITT-FALSE of a byte array."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    return int(load().crc16_native(_u8p(data), data.size))


def native_scramble_bits(bits: np.ndarray, seed: int = 0x4A80) -> np.ndarray:
    """XOR a 0/1 bit array with the DVB keystream (scramble ==
    descramble)."""
    out = np.ascontiguousarray(bits, dtype=np.uint8).copy()
    load().scramble_bits_native(seed, _u8p(out), out.size)
    return out


def native_interleave_bits(bits: np.ndarray, deinterleave: bool = False
                           ) -> np.ndarray:
    """The golden-prime interleaver (or its inverse) over a 0/1 bit
    array."""
    out = np.ascontiguousarray(bits, dtype=np.uint8).copy()
    rc = load().interleave_bits_native(_u8p(out), out.size, int(deinterleave))
    if rc == -2:
        raise ValueError(
            f"interleave of {out.size} bits is not bijective: the saturated "
            f"prime divides nbits (reference defect, interleave.c:52-59) — "
            f"pad or resize the frame")
    if rc != 0:
        raise MemoryError(f"interleave_bits_native failed (rc={rc})")
    return out
