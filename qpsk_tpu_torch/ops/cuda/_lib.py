"""Build and load the port's CUDA kernels.

The sources in ``qpsk_tpu_torch/csrc/*.cu`` are compiled by ``nvcc`` for
``sm_90a``, one compiler process per source running in parallel, and
linked into one shared library with a plain C interface, loaded with
``ctypes``.  The library is built at first use into the git-ignored
``qpsk_tpu_torch/_build/`` directory, under a name keyed on a hash of the
sources and flags, so an edited source is rebuilt and a fresh checkout
builds its own.  Nothing here runs at import time.  Every launch is a
call of ``launch``, whose ``check`` counts it, always in ``launches`` and,
while a profiler records, as ``launch.<entry>`` in
``qpsk_tpu_torch.tracing``; the load is the ``kernels.load`` span, a build
the ``kernels.build`` counter.  A wrapper keeps the work of a launch that
follows from its geometry alone in a launch plan (``plan``), built on the
geometry's first launch and counted there as ``plan.build``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from qpsk_tpu_torch import tracing

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = _ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v")
LINK_FLAGS = _ARCH + ("-shared",)

# the launches of each C entry since the last ``launches.clear()``
launches = collections.Counter()
# the launch plans kept, by key, the least recently used first (``plan``)
_plans = collections.OrderedDict()
_PLANS_KEPT = 64

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    **dict.fromkeys(("qpsk_frontend_pipe", "qpsk_frontend_gen"),
                    [_P] * 18 + [_I] * 7 + [_P, _P, _D, _F, _F, _P]),
    "qpsk_costas_tm": [_P] * 15 + [_I] * 5 + [_P, _P, _P],
    "qpsk_sincosf": [_P] * 3 + [ctypes.c_longlong, _P],
    "qpsk_tx": [_P] * 11 + [_I] * 4 + [_P, _D, _F, _F, _P],
    "qpsk_tx_gen": [_P] * 12 + [_I] * 4 + [_D, _F, _F, _P],
    "qpsk_viterbi": [_P] * 3 + [_I] * 4 + [ctypes.c_uint] * 2 + [_P],
    "qpsk_viterbi_gen": [_P] * 4 + [_I] * 7 + [_P],
    "qpsk_ldpc": [_P] * 5 + [_I] * 7 + [_F, _P],
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
    """Compile the kernels if this set of sources has not been built yet:
    one ``nvcc -c`` per source, all started together, then one link.
    Returns (library path, compiler output; empty if it was built before)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libqpsk_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    start = time.time_ns()
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in sources]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        failed = [f"{src.name} ({p.returncode}):\n{log}"
                  for src, p, log in zip(sources, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)
    tracing.count("kernels.build", always=True, start_ns=start)
    return lib, "".join(logs)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    with tracing.span("kernels.load", always=True):
        path, _ = build()
        lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_geometry(off) -> None:
    """Raise ``NotImplementedError`` naming the field a kernel does not
    cover: ``off`` is what the kernel module's ``coverage(cfg)`` returns,
    None when it covers the config, else (field, value, what the kernel
    takes).  A wrapper asks this before it launches, on CUDA tensors only:
    a CPU tensor runs the plain version at any geometry."""
    if off is not None:
        name, value, takes = off
        raise NotImplementedError(
            f"{name}={value!r} is not ported to the CUDA kernel (it takes "
            f"{takes}); run it on CPU tensors")


def use_kernel(impl: str, t: torch.Tensor, field: str) -> bool:
    """Whether a wrapper launches its kernel on ``t`` under the lowering
    switch ``field`` = ``impl``: "auto" on a CUDA tensor, "pallas" always
    (on a CPU tensor it raises: the kernels run only on the card); the
    plain lowerings ("scan", "xla") never, on whatever device ``t`` is."""
    if impl == "auto":
        return t.is_cuda
    if impl == "pallas":
        if not t.is_cuda:
            raise RuntimeError(
                f"{field}='pallas' runs the CUDA kernel, but the tensors lie "
                f"on {t.device}; use 'auto' or the plain lowering there")
        return True
    if impl in ("scan", "xla"):
        return False
    raise ValueError(f"unknown {field} {impl!r}")


def launch(entry: str, *args) -> None:
    """Call the library's C entry ``entry`` on ``args`` (one kernel launch)
    and ``check`` its return code; the launch's record spans the call."""
    fn = getattr(library(), entry)
    start = time.time_ns()
    check(fn(*args), entry, start)


def check(rc: int, name: str, start_ns: int | None = None) -> None:
    """Raise if a C entry returned a CUDA error code, else count the
    launch (begun at ``start_ns``, else now)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    launches[name] += 1
    tracing.count(f"launch.{name}", start_ns=start_ns)


def plan(key: tuple, build):
    """The launch plan of ``key`` (a wrapper's geometry: what its launch
    works out from the geometry alone, once): ``build()`` the first time,
    counted as ``plan.build`` in ``qpsk_tpu_torch.tracing`` whether a
    profiler records or not, the same plan after.  A ``build`` that raises
    (a geometry the kernel does not take) keeps nothing.  The ``_PLANS_KEPT``
    plans used last are kept: a caller whose geometry changes from call to
    call (chunks of varying length) rebuilds, and holds no more."""
    found = _plans.get(key)
    if found is None:
        found = _plans[key] = build()
        tracing.count("plan.build", always=True)
        if len(_plans) > _PLANS_KEPT:
            _plans.popitem(last=False)
    else:
        _plans.move_to_end(key)
    return found


def ptr(t):
    """``t``'s data pointer, None for None: a C entry's optional array."""
    return None if t is None else t.data_ptr()


def require(t, name: str, dtype, shape: tuple, device) -> None:
    """Raise ValueError unless ``t`` is a contiguous tensor of ``dtype`` and
    ``shape`` on ``device`` — what a kernel takes by raw pointer."""
    if t.shape != shape or t.dtype != dtype or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: the kernel takes a contiguous {dtype} tensor of shape "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The streaming multiprocessors of the CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a C pointer, read
    anew on every call (the one ``torch.cuda.current_stream`` names)."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)
