"""RX front-end kernel wrapper (port of the time-major launch of
``qpsk_tpu/ops/pallas/frontend_kernel.py``, ``rx_frontend_fused_tm``).

``rx_frontend_tm`` takes the ``RxState`` fields (mixed-domain ``fir_tail``,
unit ``nco_phase``, ``decim_delay``) and returns the one-frame-delayed,
carrier-rotated symbol picks as time-major ``(T, C)`` planes, the timing
index and the new state.  On a CUDA tensor it launches
``csrc/frontend.cu``; on a CPU tensor it runs ``rx_frontend_tm_plain``, the
staged ``frontend_xla`` chain (``modem.frontend_xla`` in the JAX package)
plus the delay concat, in the same layout.  The tail conversions and the phase advance are host-side torch
helpers (``ops/frontend.py``), as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qpsk_tpu_torch.ops import frontend as fe
from qpsk_tpu_torch.ops import rrc as rrc_ops
from qpsk_tpu_torch.ops import timing as timing_ops
from qpsk_tpu_torch.ops.cplx import CF32, cmap
from qpsk_tpu_torch.ops.cuda import _lib

# Kernel launches since the last reset (set to 0 to start a count).
launches = 0


def rx_frontend_tm(cfg, pcm: torch.Tensor, nco_phase: CF32, fir_tail: CF32,
                   decim_delay: CF32):
    """Front-end over ``(C, nframes, frame_size)`` int16 PCM.

    Returns ``(zr, zi, index, new_nco_phase, new_fir_tail,
    new_decim_delay)``: ``zr, zi`` are the delayed picks as (T, C) float32
    planes with ``T = nframes * nsym`` (rows of frame 0 are the carried
    ``decim_delay``), ``index`` is the (C, nframes) int32 decimation phase.
    """
    if pcm.is_cuda:
        return _launch(cfg, pcm, nco_phase, fir_tail, decim_delay)
    return rx_frontend_tm_plain(cfg, pcm, nco_phase, fir_tail, decim_delay)


@functools.lru_cache(maxsize=None)
def _tmat_mod_for(cfg, block: int, device) -> tuple:
    """(re, im) Toeplitz planes of the RX modulated taps on ``device``."""
    key = tuple(np.asarray(rrc_ops.taps_for(cfg)).tolist())
    hm = fe.modulated_taps_np(key, float(-cfg.omega_center))
    return tuple(torch.from_numpy(rrc_ops.toeplitz_taps(h, block)).to(device)
                 for h in hm)


def frontend_xla(cfg, pcm: torch.Tensor, nco_phase: CF32, fir_tail: CF32):
    """The staged front-end over ``(C, nframes, frame_size)`` int16 PCM,
    mix-free: raw PCM -> complex matched filter -> power timing -> decimate
    -> per-pick carrier phasor.  Returns (picks CF32 (C, nframes, nsym),
    index (C, nframes) int32, new_nco_phase, new_fir_tail)."""
    c, nframes, fsz = pcm.shape
    n = nframes * fsz
    omega = float(-cfg.omega_center)
    flat = pcm.reshape(c, n).to(torch.float32) / cfg.pcm_scale
    raw_tail = fe.unmix_tail(fir_tail, nco_phase, omega)
    block = rrc_ops.pick_block(fsz)
    tre, tim = _tmat_mod_for(cfg, block, pcm.device)
    u, _ = rrc_ops.fir_block_modulated(flat, raw_tail, tre, tim, cfg.gain,
                                       block)
    frames = cmap(lambda p: p.reshape(c, nframes, fsz), u)
    picks_u, index = timing_ops.estimate_and_decimate(frames, cfg.cycles)
    picks = fe.rotate_picks(picks_u, index, nco_phase, omega, fsz,
                            cfg.cycles)
    new_phase = fe.advance_phase(nco_phase, omega, n)
    new_tail = fe.remix_tail(flat[:, n - (cfg.ntaps - 1):], nco_phase, omega,
                             n)
    return picks, index, new_phase, new_tail


def rx_frontend_tm_plain(cfg, pcm, nco_phase, fir_tail, decim_delay):
    """The plain PyTorch version of ``rx_frontend_tm``."""
    c, nframes, _ = pcm.shape
    picks, index, new_phase, new_tail = frontend_xla(cfg, pcm, nco_phase,
                                                     fir_tail)

    def delayed(dd, p):
        z = torch.cat([dd[:, None], p[:, :-1]], dim=1)
        return z.reshape(c, -1).T.contiguous()
    return (delayed(decim_delay.re, picks.re), delayed(decim_delay.im, picks.im),
            index, new_phase, new_tail,
            CF32(picks.re[:, -1].contiguous(), picks.im[:, -1].contiguous()))


def _launch(cfg, pcm, nco_phase, fir_tail, decim_delay):
    global launches
    _lib.check_geometry(cfg)
    c, nframes, fsz = pcm.shape
    if not 1 <= nframes <= 65535 or c < 1:
        raise ValueError(f"the front-end kernel takes 1..65535 frames and "
                         f"at least one channel, got {tuple(pcm.shape)}")
    dev = pcm.device
    nsym = fsz // cfg.cycles
    ntaps_m1 = cfg.ntaps - 1
    _lib.require(pcm, "pcm", torch.int16, (c, nframes, cfg.frame_size), dev)
    for name, t, shape in (("nco_phase", nco_phase, (c,)),
                           ("fir_tail", fir_tail, (c, ntaps_m1)),
                           ("decim_delay", decim_delay, (c, nsym))):
        for part, plane in zip(("re", "im"), t):
            _lib.require(plane, f"{name}.{part}", torch.float32, shape, dev)

    omega = float(-cfg.omega_center)
    n = nframes * fsz
    raw_tail = fe.unmix_tail(fir_tail, nco_phase, omega).contiguous()
    taps_key = tuple(np.asarray(rrc_ops.taps_for(cfg)).tolist())
    hm = np.ascontiguousarray(fe.modulated_taps_np(taps_key, omega))
    t = nframes * nsym
    zr = torch.empty((t, c), dtype=torch.float32, device=dev)
    zi = torch.empty((t, c), dtype=torch.float32, device=dev)
    index = torch.empty((c, nframes), dtype=torch.int32, device=dev)
    ndd = CF32(torch.empty((c, nsym), dtype=torch.float32, device=dev),
               torch.empty((c, nsym), dtype=torch.float32, device=dev))
    rc = _lib.library().qpsk_frontend_tm(
        pcm.data_ptr(), raw_tail.data_ptr(), nco_phase.re.data_ptr(),
        nco_phase.im.data_ptr(), decim_delay.re.data_ptr(),
        decim_delay.im.data_ptr(), zr.data_ptr(), zi.data_ptr(),
        index.data_ptr(), ndd.re.data_ptr(), ndd.im.data_ptr(), c, nframes,
        hm[0].ctypes.data, hm[1].ctypes.data, omega, float(cfg.gain),
        1.0 / float(cfg.pcm_scale), _lib.stream_ptr(dev))
    _lib.check(rc, "qpsk_frontend_tm")
    launches += 1

    last_raw = pcm.reshape(c, n)[:, n - ntaps_m1:].to(torch.float32) \
        / cfg.pcm_scale
    new_phase = fe.advance_phase(nco_phase, omega, n)
    new_tail = fe.remix_tail(last_raw, nco_phase, omega, n)
    return zr, zi, index, new_phase, new_tail, ndd
