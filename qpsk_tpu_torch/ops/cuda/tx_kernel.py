"""TX modulator kernel wrapper (port of ``qpsk_tpu/ops/pallas/tx_kernel.py``,
``tx_modulate_fused``).

``tx_modulate`` maps (C, S) QPSK symbols to (C, S*cycles) int16 PCM, at 4 or
8 samples per symbol (2400 or 1200 baud), with
the ``TxState`` contract of the staged path (zero-stuffed ``fir_tail``,
unit-phasor ``nco_phase``), so kernel and plain calls chain with each
other.  On a CUDA tensor it launches ``csrc/tx.cu``; on a CPU tensor it runs
``tx_modulate_plain``: zero-stuff, block FIR, NCO mix, int16.  A CUDA call
the kernel does not cover (a geometry other than 127 taps at 4 or 8
samples per symbol, more than ``_MAX_SYMBOLS`` symbols a channel) raises
``NotImplementedError`` naming it before any launch; a CPU call runs any
geometry.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from qpsk_tpu_torch.config import TAU
from qpsk_tpu_torch.ops import frontend as fe
from qpsk_tpu_torch.ops import nco
from qpsk_tpu_torch.ops import rrc as rrc_ops
from qpsk_tpu_torch.ops.cplx import CF32, cmap
from qpsk_tpu_torch.ops.cuda import _lib
from qpsk_tpu_torch.ops.modmap import upsample_zero_stuff

# Kernel launches since the last reset (set to 0 to start a count), and
# the same launches by mode: "cycles4", "cycles8" (clear() it).
launches = 0
by_mode = collections.Counter()

# 128-symbol blocks on the grid's y axis, at most 65 535 of them
_MAX_SYMBOLS = 128 * 65535


def tx_modulate(cfg, symbols: CF32, nco_phase: CF32, fir_tail: CF32,
                tx_offset_hz: float = 0.0):
    """Modulate (C, S) symbols.  Returns (pcm (C, S*cycles) int16,
    new_nco_phase, new_fir_tail)."""
    if symbols.re.is_cuda:
        return _launch(cfg, symbols, nco_phase, fir_tail, tx_offset_hz)
    return tx_modulate_plain(cfg, symbols, nco_phase, fir_tail, tx_offset_hz)


def _omega(cfg, tx_offset_hz: float) -> float:
    return TAU * (cfg.center + tx_offset_hz) / cfg.fs


def tx_modulate_plain(cfg, symbols, nco_phase, fir_tail, tx_offset_hz=0.0):
    """The plain PyTorch version of ``tx_modulate``."""
    sig = upsample_zero_stuff(symbols, cfg.cycles)
    block = rrc_ops.pick_block(sig.shape[-1])
    tmat = torch.from_numpy(rrc_ops.toeplitz_taps(rrc_ops.taps_for(cfg), block))
    sig, tail = rrc_ops.fir_block(sig, fir_tail, tmat.to(sig.re.device),
                                  cfg.gain, block)
    sig, phase = nco.mix(sig, nco_phase, _omega(cfg, tx_offset_hz))
    # truncation toward zero, saturating at the int16 range as the JAX
    # package's astype does (at 2 samples per symbol the pulse overshoots
    # full scale)
    pcm = torch.clamp(sig.re * cfg.pcm_scale, -32768.0, 32767.0)
    return pcm.to(torch.int16), phase, tail


def _launch(cfg, symbols, nco_phase, fir_tail, tx_offset_hz):
    global launches
    _lib.check_geometry(cfg)
    c, s = symbols.shape
    cycles, ntaps_m1 = cfg.cycles, cfg.ntaps - 1
    if s > _MAX_SYMBOLS:
        raise NotImplementedError(
            f"symbols={s} a channel is not ported to the TX kernel (it takes "
            f"at most {_MAX_SYMBOLS}); run it on CPU tensors")
    if c < 1 or s < 1:
        raise ValueError(f"the TX kernel takes C >= 1 channels and S >= 1 "
                         f"symbols, got {(c, s)}")
    dev = symbols.re.device
    for name, t, shape in (("symbols", symbols, (c, s)),
                           ("nco_phase", nco_phase, (c,)),
                           ("fir_tail", fir_tail, (c, ntaps_m1))):
        for part, plane in zip(("re", "im"), t):
            _lib.require(plane, f"{name}.{part}", torch.float32, shape, dev)

    # the carried zero-stuffed tail holds its symbols at lanes
    # k = (ntaps-1) % cycles + cycles*m (call lengths are whole symbols)
    hist = cmap(lambda p: p[:, ntaps_m1 % cycles::cycles].contiguous(),
                fir_tail)
    omega = _omega(cfg, tx_offset_hz)
    taps = np.ascontiguousarray(rrc_ops.taps_for(cfg), np.float32)
    pcm = torch.empty((c, s * cycles), dtype=torch.int16, device=dev)
    rc = _lib.library().qpsk_tx(
        symbols.re.data_ptr(), symbols.im.data_ptr(), hist.re.data_ptr(),
        hist.im.data_ptr(), nco_phase.re.data_ptr(), nco_phase.im.data_ptr(),
        pcm.data_ptr(), c, s, cycles, taps.ctypes.data, omega, float(cfg.gain),
        float(cfg.pcm_scale), _lib.stream_ptr(dev))
    _lib.check(rc, "qpsk_tx")
    launches += 1
    by_mode[f"cycles{cycles}"] += 1

    # new state: the phase after s*cycles samples, and the last ntaps-1
    # samples of [old tail | zero-stuffed symbols]
    new_phase = fe.advance_phase(nco_phase, omega, s * cycles)
    last = cmap(lambda p: p[:, max(0, s - ntaps_m1 // cycles - 1):], symbols)
    stuffed = upsample_zero_stuff(last, cycles)
    new_tail = CF32(*(torch.cat([t, u], dim=1)[:, -ntaps_m1:].contiguous()
                      for t, u in zip(fir_tail, stuffed)))
    return pcm, new_phase, new_tail
