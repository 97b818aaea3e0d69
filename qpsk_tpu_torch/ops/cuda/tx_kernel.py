"""TX modulator kernel wrapper (port of ``qpsk_tpu/ops/pallas/tx_kernel.py``,
``tx_modulate_fused``).

``tx_modulate`` maps (C, S) symbols to (C, S*cycles) int16 PCM with the
``TxState`` contract of the staged path (zero-stuffed ``fir_tail``,
unit-phasor ``nco_phase``), so kernel and plain calls chain with each
other.  On a CUDA tensor it is one launch of ``csrc/tx.cu``, which reads
the carried tail's symbol lanes in place and writes the PCM, the new
phase and the new tail, with no other device operation and no copy to the
card; on a CPU tensor it runs ``tx_modulate_plain``: zero-stuff, block FIR,
NCO mix, int16.  The kernel covers (``coverage``) the TPU kernel's gate
(``tx_supported``): any samples per symbol from 2 and any odd ``ntaps``
whose halo is at most 128 symbols, any channel and symbol count.  The
wrapper picks the instance by geometry: ``tx_kernel<CYC>`` (the FIR on the
tensor cores) at 2 to 8 samples per symbol and up to 129 taps, the general
instance (``tx_general_kernel``, a polyphase sum on the CUDA cores, 8
samples a lane, the taps staged from the device copy) everywhere else.  A CUDA call off the coverage
raises ``NotImplementedError`` naming the field before any launch; a CPU
call runs any geometry.  ``cfg.tx_impl`` picks the lowering: "auto" (the
tensor's device), "xla" (the plain version on any device) or "pallas"
(the kernel; a CPU tensor raises).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from qpsk_tpu_torch.config import TAU
from qpsk_tpu_torch.ops import nco
from qpsk_tpu_torch.ops import rrc as rrc_ops
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.cuda import _lib
from qpsk_tpu_torch.ops.modmap import upsample_zero_stuff

# the samples per symbol tx_kernel<CYC> is built for (csrc/tx.cu, one
# template instance each) and its largest tap count (a by-value parameter
# of 129 floats); the halo of every instance (the TPU kernel's _BS)
_FAST_CYCLES, _FAST_MAX_TAPS, _MAX_HALO = range(2, 9), 129, 128


def _halo_syms(ntaps: int, cycles: int) -> int:
    """The TPU kernel's symbol halo (``tx_kernel._halo_syms``)."""
    return (ntaps - 1 + cycles - 1) // cycles + 1


def coverage(cfg):
    """None if the kernel covers ``cfg``, else (field, value, what the
    kernel takes) of the first field off it."""
    if cfg.cycles < 2:
        return "fs/rs", cfg.cycles, "at least 2 samples per symbol"
    if _halo_syms(cfg.ntaps, cfg.cycles) > _MAX_HALO:
        return ("ntaps", cfg.ntaps,
                f"a halo of at most {_MAX_HALO} symbols, (ntaps - 1 + "
                "cycles - 1) // cycles + 1")
    return None


def _fast(cfg) -> bool:
    """Whether ``tx_kernel<CYC>`` takes ``cfg`` (else the general one)."""
    return cfg.cycles in _FAST_CYCLES and cfg.ntaps <= _FAST_MAX_TAPS


def tx_modulate(cfg, symbols: CF32, nco_phase: CF32, fir_tail: CF32,
                tx_offset_hz: float = 0.0):
    """Modulate (C, S) symbols.  Returns (pcm (C, S*cycles) int16,
    new_nco_phase, new_fir_tail); ``cfg.tx_impl`` picks the lowering."""
    if _lib.use_kernel(cfg.tx_impl, symbols.re, "tx_impl"):
        return _launch(cfg, symbols, nco_phase, fir_tail, tx_offset_hz)
    return tx_modulate_plain(cfg, symbols, nco_phase, fir_tail, tx_offset_hz)


def _omega(cfg, tx_offset_hz: float) -> float:
    return TAU * (cfg.center + tx_offset_hz) / cfg.fs


def tx_modulate_plain(cfg, symbols, nco_phase, fir_tail, tx_offset_hz=0.0):
    """The plain PyTorch version of ``tx_modulate``."""
    sig = upsample_zero_stuff(symbols, cfg.cycles)
    block = rrc_ops.tile_block(sig.shape[-1])
    tmat = torch.from_numpy(rrc_ops.toeplitz_taps(rrc_ops.taps_for(cfg), block))
    sig, tail = rrc_ops.fir_block(sig, fir_tail, tmat.to(sig.re.device),
                                  cfg.gain, block)
    sig, phase = nco.mix(sig, nco_phase, _omega(cfg, tx_offset_hz))
    # truncation toward zero, saturating at the int16 range as the JAX
    # package's astype does (at 2 samples per symbol the pulse overshoots
    # full scale)
    pcm = torch.clamp(sig.re * cfg.pcm_scale, -32768.0, 32767.0)
    return pcm.to(torch.int16), phase, tail


@functools.lru_cache(maxsize=None)
def _launch_consts(cfg) -> tuple:
    """(taps (ntaps,) float32, gain) the launch passes by value: the kernel
    splits the taps into float16 hi + lo parts, so they go scaled by the
    power of two that puts this tap set's largest near 2^14 (every part
    then rounds within 2^-22 of it), and the gain carries the inverse
    scale, exactly."""
    taps = np.asarray(rrc_ops.taps_for(cfg), np.float32)
    scale = 2.0 ** (14 - math.ceil(math.log2(float(np.abs(taps).max()))))
    return np.ascontiguousarray(taps * np.float32(scale)), float(cfg.gain) / scale


@functools.lru_cache(maxsize=None)
def _taps_on(cfg, device) -> torch.Tensor:
    """The RRC taps (ntaps,) float32 on ``device``, for the general
    instance, which reads them from device memory."""
    return torch.from_numpy(np.asarray(rrc_ops.taps_for(cfg),
                                       np.float32)).to(device)


def _launch(cfg, symbols, nco_phase, fir_tail, tx_offset_hz):
    _lib.check_geometry(coverage(cfg))
    c, s = symbols.shape
    if c < 1 or s < 1:
        raise ValueError(f"the TX kernel takes C >= 1 channels and S >= 1 "
                         f"symbols, got {(c, s)}")
    dev = symbols.re.device
    ntaps_m1 = cfg.ntaps - 1
    for name, t, shape in (("symbols", symbols, (c, s)),
                           ("nco_phase", nco_phase, (c,)),
                           ("fir_tail", fir_tail, (c, ntaps_m1))):
        for part, plane in zip(("re", "im"), t):
            _lib.require(plane, f"{name}.{part}", torch.float32, shape, dev)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    pcm = empty((c, s * cfg.cycles), torch.int16)
    phase = CF32(empty((c,)), empty((c,)))
    tail = CF32(empty((c, ntaps_m1)), empty((c, ntaps_m1)))
    if not _fast(cfg):
        _lib.launch(
            "qpsk_tx_gen", symbols.re.data_ptr(), symbols.im.data_ptr(),
            fir_tail.re.data_ptr(), fir_tail.im.data_ptr(),
            nco_phase.re.data_ptr(), nco_phase.im.data_ptr(),
            _taps_on(cfg, dev).data_ptr(), pcm.data_ptr(), phase.re.data_ptr(),
            phase.im.data_ptr(), tail.re.data_ptr(), tail.im.data_ptr(), c, s,
            cfg.cycles, cfg.ntaps, _omega(cfg, tx_offset_hz), float(cfg.gain),
            float(cfg.pcm_scale), _lib.stream_ptr(dev))
        return pcm, phase, tail
    taps, gain = _launch_consts(cfg)
    _lib.launch(
        "qpsk_tx",
        symbols.re.data_ptr(), symbols.im.data_ptr(), fir_tail.re.data_ptr(),
        fir_tail.im.data_ptr(), nco_phase.re.data_ptr(),
        nco_phase.im.data_ptr(), pcm.data_ptr(), phase.re.data_ptr(),
        phase.im.data_ptr(), tail.re.data_ptr(), tail.im.data_ptr(), c, s,
        cfg.cycles, cfg.ntaps, taps.ctypes.data,
        _omega(cfg, tx_offset_hz), gain, float(cfg.pcm_scale),
        _lib.stream_ptr(dev))
    return pcm, phase, tail
