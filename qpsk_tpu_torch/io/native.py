"""ctypes loader for the port's native IO library (``qpsk_io.cc``).

The library is built from the port's own copy of the C++ source by ``g++``
at first use, into the git-ignored ``qpsk_tpu_torch/_build/`` under a name
keyed on a hash of the source and the flags, so an edited source is
rebuilt and a fresh checkout builds its own.  The build writes a
temporary file and renames it into place under an exclusive ``fcntl``
lock on a file beside it: test workers in separate processes that load at
once build it once, and none loads a half-written library.  Nothing here
runs at import time.  Plain C ABI + ctypes, no pybind11.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import subprocess

SRC = pathlib.Path(__file__).resolve().parent / "qpsk_io.cc"
BUILD_DIR = SRC.parents[1] / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def _build() -> pathlib.Path:
    """The library's path, compiled first unless this source and these
    flags were built before."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    lib = BUILD_DIR / f"libqpsk_io-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "libqpsk_io.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not lib.exists():
                tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
                try:
                    subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o",
                                    str(tmp)], check=True, capture_output=True)
                    os.replace(tmp, lib)
                finally:
                    tmp.unlink(missing_ok=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the native library, with every entry's
    argument and result types declared."""
    lib = ctypes.CDLL(str(_build()))

    c = ctypes
    i16p = c.POINTER(c.c_int16)
    u8p = c.POINTER(c.c_uint8)
    i32p = c.POINTER(c.c_int32)

    lib.spool_open.restype = c.c_void_p
    lib.spool_open.argtypes = [c.c_char_p, c.c_char_p]
    lib.spool_read.restype = c.c_int64
    lib.spool_read.argtypes = [c.c_void_p, i16p, c.c_int64, c.c_int64]
    lib.spool_write.restype = c.c_int64
    lib.spool_write.argtypes = [c.c_void_p, i16p, c.c_int64, c.c_int64]
    lib.spool_close.restype = None
    lib.spool_close.argtypes = [c.c_void_p]

    lib.wav_write.restype = c.c_int
    lib.wav_write.argtypes = [c.c_char_p, i16p, c.c_int64, c.c_int32]
    lib.wav_read.restype = c.c_int64
    lib.wav_read.argtypes = [c.c_char_p, i16p, c.c_int64, i32p]

    lib.ring_create.restype = c.c_void_p
    lib.ring_create.argtypes = [c.c_int64]
    lib.ring_push.restype = c.c_int64
    lib.ring_push.argtypes = [c.c_void_p, i16p, c.c_int64]
    lib.ring_pop.restype = c.c_int64
    lib.ring_pop.argtypes = [c.c_void_p, i16p, c.c_int64]
    lib.ring_available.restype = c.c_int64
    lib.ring_available.argtypes = [c.c_void_p]
    lib.ring_destroy.restype = None
    lib.ring_destroy.argtypes = [c.c_void_p]

    lib.crc16_native.restype = c.c_uint16
    lib.crc16_native.argtypes = [u8p, c.c_int64]
    lib.scramble_keystream.restype = None
    lib.scramble_keystream.argtypes = [c.c_uint16, u8p, c.c_int64]
    lib.scramble_bits_native.restype = None
    lib.scramble_bits_native.argtypes = [c.c_uint16, u8p, c.c_int64]
    lib.interleave_permutation_native.restype = None
    lib.interleave_permutation_native.argtypes = [c.c_int64, i32p]
    lib.interleave_bits_native.restype = c.c_int
    lib.interleave_bits_native.argtypes = [u8p, c.c_int64, c.c_int]
    return lib
