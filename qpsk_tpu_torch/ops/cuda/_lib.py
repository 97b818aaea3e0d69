"""Build and load the port's CUDA kernels.

The sources in ``qpsk_tpu_torch/csrc/*.cu`` are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``.  The library is built at first use into the git-ignored
``qpsk_tpu_torch/_build/`` directory, under a name keyed on a hash of the
sources and flags, so an edited source is rebuilt and a fresh checkout
builds its own.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    "qpsk_frontend_tm": [_P] * 11 + [_I, _I, _P, _P, _D, _F, _F, _P],
    "qpsk_costas_tm": [_P] * 10 + [_I, _I, _I, _F, _F, _F, _F, _P],
    "qpsk_tx": [_P] * 7 + [_I, _I, _P, _D, _F, _F, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernels if this set of sources has not been built yet.
    Returns (library path, compiler output; empty if it was built before)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libqpsk_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, sources)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_geometry(cfg) -> None:
    """Raise ``NotImplementedError`` naming the first field of ``cfg`` off
    the geometry the kernels are built for: 127 taps, 4 samples per symbol,
    512-sample frames."""
    for field, name, want in (("ntaps", "ntaps", 127), ("cycles", "fs/rs", 4),
                              ("frame_size", "frame_size", 512)):
        if getattr(cfg, field) != want:
            raise NotImplementedError(
                f"{name}={getattr(cfg, field)!r} is not ported (the kernels "
                f"are built for {name}={want!r})")


def check(rc: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def require(t, name: str, dtype, shape: tuple, device) -> None:
    """Raise ValueError unless ``t`` is a contiguous tensor of ``dtype`` and
    ``shape`` on ``device`` — what a kernel takes by raw pointer."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: the kernel takes a contiguous {dtype} tensor of shape "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a C pointer."""
    return torch.cuda.current_stream(device).cuda_stream
