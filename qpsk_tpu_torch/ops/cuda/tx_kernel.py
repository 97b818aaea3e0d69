"""TX modulator kernel wrapper (port of ``qpsk_tpu/ops/pallas/tx_kernel.py``,
``tx_modulate_fused``).

``tx_modulate`` maps (C, S) symbols to (C, S*cycles) int16 PCM with the
``TxState`` contract of the staged path (zero-stuffed ``fir_tail``,
unit-phasor ``nco_phase``), so kernel and plain calls chain with each
other.  On a CUDA tensor it is one launch of ``csrc/tx.cu``, which reads
the carried tail's symbol lanes in place and writes the PCM, the new
phase and the new tail, with no other device operation and no copy to the
card; on a CPU tensor it runs ``tx_modulate_plain``: zero-stuff, block FIR,
NCO mix, int16.  The kernel covers (``coverage``) 2 to 8 samples per
symbol and any odd ``ntaps`` up to 129, any channel and symbol count; a
CUDA call off that raises ``NotImplementedError`` naming the field before
any launch; a CPU call runs any geometry.
"""

from __future__ import annotations

import collections
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

# Kernel launches since the last reset (set to 0 to start a count), and
# the same launches by mode: "cycles4", "cycles8", ..., with "_ntaps63"
# for a tap count other than 127 (clear() it).
launches = 0
by_mode = collections.Counter()

# the samples per symbol the kernel is built for (csrc/tx.cu, one template
# instance each) and its largest tap count (a by-value parameter of 129
# floats)
_CYCLES, _MAX_TAPS = range(2, 9), 129


def coverage(cfg):
    """None if the kernel covers ``cfg``, else (field, value, what the
    kernel takes) of the first field off it."""
    if cfg.cycles not in _CYCLES:
        return "fs/rs", cfg.cycles, "2 to 8 samples per symbol"
    if cfg.ntaps > _MAX_TAPS:
        return "ntaps", cfg.ntaps, f"odd ntaps <= {_MAX_TAPS}"
    return None


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


def _launch(cfg, symbols, nco_phase, fir_tail, tx_offset_hz):
    global launches
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

    taps, gain = _launch_consts(cfg)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    pcm = empty((c, s * cfg.cycles), torch.int16)
    phase = CF32(empty((c,)), empty((c,)))
    tail = CF32(empty((c, ntaps_m1)), empty((c, ntaps_m1)))
    rc = _lib.library().qpsk_tx(
        symbols.re.data_ptr(), symbols.im.data_ptr(), fir_tail.re.data_ptr(),
        fir_tail.im.data_ptr(), nco_phase.re.data_ptr(),
        nco_phase.im.data_ptr(), pcm.data_ptr(), phase.re.data_ptr(),
        phase.im.data_ptr(), tail.re.data_ptr(), tail.im.data_ptr(), c, s,
        cfg.cycles, cfg.ntaps, taps.ctypes.data,
        _omega(cfg, tx_offset_hz), gain, float(cfg.pcm_scale),
        _lib.stream_ptr(dev))
    _lib.check(rc, "qpsk_tx")
    launches += 1
    by_mode[f"cycles{cfg.cycles}"
            + ("" if cfg.ntaps == 127 else f"_ntaps{cfg.ntaps}")] += 1
    return pcm, phase, tail
