"""RX front-end kernel wrappers (port of
``qpsk_tpu/ops/pallas/frontend_kernel.py``: the time-major launch
``rx_frontend_fused_tm`` and the channel-major launch ``rx_frontend_fused``).

``rx_frontend_tm`` takes the ``RxState`` fields (mixed-domain ``fir_tail``,
unit ``nco_phase``, ``decim_delay``) and returns the one-frame-delayed,
carrier-rotated symbol picks as time-major ``(T, C)`` planes, the timing
index, the new state and, for the frame-rate AGC, the per-frame power of
the emitted picks.  ``rx_frontend`` returns the undelayed picks channel-major
``(C, nframes, nsym)``: the composed receive path's front-end (frames of
fewer than 128 symbols, the CMA equalizer).  On a CUDA tensor each
launches ``csrc/frontend.cu`` once, which also converts the carried tail
and advances the phase (``ops/frontend.py``'s ``unmix_tail``,
``remix_tail`` and ``advance_phase``), so a call makes no host-to-device
copy and does not synchronise; on a CPU tensor each runs its plain
version: ``frontend_xla``, the staged chain (``modem.frontend_xla`` in the
JAX package), plus for the time-major one the delay concat and
``agc._frame_power``, in the same layouts.

The kernel covers (``coverage``) every geometry the TPU kernel's gate
admits (``frontend_supported``): any samples per symbol up to 256 that
divide the frame, any odd ``ntaps`` up to 129 (the TPU kernel's ``ntaps -
1 <= 128``) and any ``frame_size`` that is a multiple of 128, in both
launches, the AGC power output at any symbol count.  The wrapper picks the
instance by geometry: at 2, 4 or 8 samples per symbol and frames up to
``_FAST_MAX_FRAME`` = 512 samples, with the power output when a frame's
symbols are a power of two, the persistent, warp-specialised pipeline
(``frontend_kernel_pipe``, C entry ``qpsk_frontend_pipe``, one block an
SM, ``wgmma``); the general instance (``frontend_general_kernel``, C
entry ``qpsk_frontend_gen``, a tensor-core FIR by ``mma.sync``
with the samples per symbol read at run time, the frame streamed through
shared memory in chunks) everywhere else.  A CUDA call off the coverage raises
``NotImplementedError`` naming the field before any launch; a CPU call
runs any geometry.  ``cfg.frontend_impl`` picks the lowering: "auto" (the
tensor's device), "xla" (the plain version on any device) or "pallas"
(the kernel; a CPU tensor raises).  What a launch works out from its
geometry alone (the instance, the grid, the by-value arguments, the
shapes it checks) is done once a geometry, in its launch plan
(``_Plan``, ``_lib.plan``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from qpsk_tpu_torch.ops import frontend as fe
from qpsk_tpu_torch.ops import rrc as rrc_ops
from qpsk_tpu_torch.ops import timing as timing_ops
from qpsk_tpu_torch.ops.agc import frame_powers_tm
from qpsk_tpu_torch.ops.cplx import CF32, cmap
from qpsk_tpu_torch.ops.cuda import _lib

# the samples per symbol the pipeline is built for, its longest frame
# (csrc/frontend.cu, PIPE_MAX_FRAME: 16 segments of 32 outputs, a FIR
# group's two accumulators), and the largest tap count (a 128-sample
# halo) and samples per symbol (GMAXCYC) of every instance
_FAST_CYCLES, _FAST_MAX_FRAME, _MAX_TAPS, _MAX_CYCLES = (2, 4, 8), 512, 129, 256


def coverage(cfg):
    """None if the kernel covers ``cfg``, else (field, value, what the
    kernel takes) of the first field off it: either layout, with or
    without the AGC power output."""
    if cfg.cycles > _MAX_CYCLES:
        return "fs/rs", cfg.cycles, f"up to {_MAX_CYCLES} samples per symbol"
    if cfg.ntaps > _MAX_TAPS:
        return "ntaps", cfg.ntaps, f"odd ntaps <= {_MAX_TAPS}"
    if cfg.frame_size % 128:
        return "frame_size", cfg.frame_size, "a multiple of 128 samples"
    return None


def _fast(cfg, power: bool) -> bool:
    """Whether the pipeline (``frontend_kernel_pipe``) takes ``cfg`` (else
    the general instance runs it)."""
    nsym = cfg.symbols_per_frame
    return (cfg.cycles in _FAST_CYCLES and cfg.frame_size <= _FAST_MAX_FRAME
            and not (power and nsym & (nsym - 1)))


def _pipe_grid(c: int, nframes: int, sms: int) -> int:
    """The pipeline's persistent blocks: one an SM (its 384 threads' 168
    registers fill one), at most one a tile of 8 channels x a frame.
    Block b walks tiles [b * T // B, (b + 1) * T // B) of the T tiles,
    frames fastest."""
    return min(-(-c // 8) * nframes, sms)


def rx_frontend_tm(cfg, pcm: torch.Tensor, nco_phase: CF32, fir_tail: CF32,
                   decim_delay: CF32):
    """Time-major front-end over ``(C, nframes, frame_size)`` int16 PCM.

    Returns ``(zr, zi, index, new_nco_phase, new_fir_tail,
    new_decim_delay, powers)``: ``zr, zi`` are the delayed picks as (T, C)
    float32 planes with ``T = nframes * nsym`` (rows of frame 0 are the
    carried ``decim_delay``), ``index`` is the (C, nframes) int32
    decimation phase, ``powers`` the (C, nframes) mean |pick|^2 of each
    emitted frame, ``agc._frame_power`` bit for bit, or None unless
    ``cfg.agc``.  ``cfg.frontend_impl`` picks the lowering.
    """
    if _lib.use_kernel(cfg.frontend_impl, pcm, "frontend_impl"):
        return _launch(cfg, pcm, nco_phase, fir_tail, decim_delay)
    return rx_frontend_tm_plain(cfg, pcm, nco_phase, fir_tail, decim_delay)


def rx_frontend(cfg, pcm: torch.Tensor, nco_phase: CF32, fir_tail: CF32):
    """Channel-major front-end over ``(C, nframes, frame_size)`` int16 PCM,
    without the delay.  Returns (picks CF32 (C, nframes, nsym), index
    (C, nframes) int32, new_nco_phase, new_fir_tail); its plain version is
    ``frontend_xla``; ``cfg.frontend_impl`` picks the lowering."""
    if _lib.use_kernel(cfg.frontend_impl, pcm, "frontend_impl"):
        return _launch(cfg, pcm, nco_phase, fir_tail)
    return frontend_xla(cfg, pcm, nco_phase, fir_tail)


@functools.lru_cache(maxsize=None)
def _tmat_mod_for(cfg, block: int, device) -> tuple:
    """(re, im) Toeplitz planes of the RX modulated taps on ``device``."""
    hm = fe.modulated_taps_np(_taps_key(cfg), float(-cfg.omega_center))
    return tuple(torch.from_numpy(rrc_ops.toeplitz_taps(h, block)).to(device)
                 for h in hm)


def _taps_key(cfg) -> tuple:
    return tuple(np.asarray(rrc_ops.taps_for(cfg)).tolist())


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
    zr, zi = delayed(decim_delay.re, picks.re), delayed(decim_delay.im, picks.im)
    powers = frame_powers_tm(zr, zi, nframes).contiguous() if cfg.agc else None
    return (zr, zi, index, new_phase, new_tail,
            CF32(picks.re[:, -1].contiguous(), picks.im[:, -1].contiguous()),
            powers)


@functools.lru_cache(maxsize=None)
def _launch_consts(cfg) -> tuple:
    """(modulated taps (2, ntaps) float32, omega, gain, 1/pcm_scale) of a
    config: host values the launch passes by value.  The kernel splits the
    taps into float16 hi + lo parts, so they go scaled by the power of two
    that puts this tap set's largest near 2^14: every part then rounds
    within 2^-22 of the largest tap, the subnormal low parts of the
    smallest taps included (their spacing, 2^-24, is 2^-38 of it); the
    gain carries the inverse scale, exactly."""
    omega = float(-cfg.omega_center)
    hm = fe.modulated_taps_np(_taps_key(cfg), omega)
    scale = 2.0 ** (14 - math.ceil(math.log2(float(np.abs(hm).max()))))
    return (np.ascontiguousarray(hm * np.float32(scale)), omega,
            float(cfg.gain) / scale, 1.0 / float(cfg.pcm_scale))


class _Plan:
    """A front-end launch's work that follows from its geometry (the
    config, C, nframes, the device, the layout) alone, done once
    (``_lib.plan``): the geometry's checks, the instance and its grid, the
    by-value arguments (``args``, the C entry's from ``C`` to
    ``inv_scale``), the shapes of the tensors it reads by pointer and of
    those it writes."""

    def __init__(self, cfg, c: int, nframes: int, device, tm: bool):
        _lib.check_geometry(coverage(cfg))
        if nframes < 1 or c < 1:
            raise ValueError(f"the front-end kernel takes at least one "
                             f"frame and one channel, got C={c}, "
                             f"nframes={nframes}")
        nsym, taps = cfg.symbols_per_frame, (c, cfg.ntaps - 1)
        self.device, self.tm = device, tm
        self.power = tm and bool(cfg.agc)
        fast = _fast(cfg, self.power)
        self.entry = "qpsk_frontend_pipe" if fast else "qpsk_frontend_gen"
        self.pcm_shape = (c, nframes, cfg.frame_size)
        self.planes = [(f"{name}.{part}", shape)
                       for name, shape in (("nco_phase", (c,)),
                                           ("fir_tail", taps))
                       + ((("decim_delay", (c, nsym)),) if tm else ())
                       for part in ("re", "im")]
        self.z_shape = (nframes * nsym, c) if tm else (c, nframes, nsym)
        self.index_shape = self.power_shape = (c, nframes)
        self.scratch_shape = ((c, nframes, nsym) if self.power and not fast
                              else None)
        # the new phase, tail and (time-major) delay, re and im
        self.state = [(c,), (c,), taps, taps] + ([(c, nsym)] * 2 if tm
                                                 else [])
        hm, omega, gain, inv_scale = _launch_consts(cfg)
        blocks = _pipe_grid(c, nframes, _lib.sm_count(device)) if fast else 0
        self.args = (c, nframes, cfg.frame_size, cfg.cycles, cfg.ntaps,
                     int(tm), blocks, hm[0].ctypes.data, hm[1].ctypes.data,
                     omega, gain, inv_scale)

    def check(self, pcm, nco_phase, fir_tail, decim_delay=None):
        """Raise ValueError unless the inputs are the tensors the kernel
        reads by pointer.  Returns (the PCM, copied where it does not
        start on a 16-byte boundary (a view into a stream at an odd
        sample: every instance reads it in 16-byte copies), the other
        inputs' pointers in the C entry's order, ``tail_re`` to
        ``dd_im``)."""
        dev = self.device
        _lib.require(pcm, "pcm", torch.int16, self.pcm_shape, dev)
        planes = (*nco_phase, *fir_tail) + (tuple(decim_delay) if self.tm
                                            else ())
        for (name, shape), t in zip(self.planes, planes):
            _lib.require(t, name, torch.float32, shape, dev)
        ptrs = [t.data_ptr() for t in planes]
        ptrs = ptrs[2:4] + ptrs[:2] + (ptrs[4:] or [None, None])
        return (pcm.clone() if pcm.data_ptr() % 16 else pcm), ptrs


def _plan(cfg, c: int, nframes: int, device, tm: bool) -> _Plan:
    return _lib.plan(("frontend", cfg, c, nframes, device, tm),
                     lambda: _Plan(cfg, c, nframes, device, tm))


def _launch(cfg, pcm, nco_phase, fir_tail, decim_delay=None):
    """One launch of ``qpsk_frontend_pipe`` (the pipeline, where ``_fast``
    takes the geometry) or ``qpsk_frontend_gen``: time-major, with the
    delay and, under ``cfg.agc``, the power output, when ``decim_delay`` is
    given (``rx_frontend_tm``'s outputs), else channel-major
    (``rx_frontend``'s)."""
    tm = decim_delay is not None
    c, nframes, _ = pcm.shape
    dev = pcm.device
    plan = _plan(cfg, c, nframes, dev, tm)
    pcm, inputs = plan.check(pcm, nco_phase, fir_tail, decim_delay)
    z = CF32(torch.empty(plan.z_shape, device=dev),
             torch.empty(plan.z_shape, device=dev))
    index = torch.empty(plan.index_shape, dtype=torch.int32, device=dev)
    new = [torch.empty(shape, device=dev) for shape in plan.state]
    powers = (torch.empty(plan.power_shape, device=dev) if plan.power
              else None)
    scratch = (None if plan.scratch_shape is None
               else torch.empty(plan.scratch_shape, device=dev))
    _lib.launch(plan.entry, pcm.data_ptr(), *inputs, z.re.data_ptr(),
                z.im.data_ptr(), index.data_ptr(),
                *(_lib.ptr(t) for t in new[4:] or (None, None)),
                _lib.ptr(powers), _lib.ptr(scratch),
                *(t.data_ptr() for t in new[:4]), *plan.args,
                _lib.stream_ptr(dev))
    phase, tail = CF32(*new[:2]), CF32(*new[2:4])
    if tm:
        return z.re, z.im, index, phase, tail, CF32(*new[4:]), powers
    return z, index, phase, tail
