"""Frame-level modem pipeline: TX and RX streams (port of ``qpsk_tpu.modem``
for coherent QPSK with its loop and channel options, and the generic
modulation family BPSK / 8PSK / 16QAM with FFT carrier acquisition).

TX:  bits -> QPSK or family symbols -> zero-stuff x cycles -> RRC shape ->
     NCO mix up -> Re * pcm_scale -> int16 PCM (``ops/cuda/tx_kernel.py``)
RX, time-major path (no equalizer, 128 symbols per frame):
     int16 PCM -> matched filter with modulated taps -> power timing ->
     decimate -> carrier phasor -> one-frame delay, time-major, with the
     per-frame pick power when ``cfg.agc``      (``ops/cuda/frontend_kernel.py``)
     -> AGC gains on the (F, C) powers          (``ops/agc.py``)
     -> Costas (gear shift, AGC gains in-register) + diagonal slicer, or
     for the family the decision-directed detector + its Gray labels
                                               (``ops/cuda/costas_kernel.py``)
RX, composed path (1200 baud, the CMA equalizer): the channel-major
     front-end -> the one-frame delay -> ``agc_stream`` -> ``equalize_stream``
     (``ops/equalizer.py``) -> Costas on the (C, T) symbols.

Every function takes ``cfg`` and explicit state and works on a channel
batch ``(C, ...)`` or a single stream.  The device of the input tensors
picks the lowering: CUDA tensors go through the hand-written kernels, CPU
tensors through each kernel's plain PyTorch version (the JAX package's
staged lowering, in the kernels' layouts), at any geometry the JAX package
takes.  A CUDA tensor at a geometry or code a kernel does not cover (taps,
samples per symbol, frame size, an LDPC or convolutional code) makes that
kernel's wrapper raise ``NotImplementedError`` naming it before the launch,
as do configurations off the port on either device.  The lowering
switches ``costas_impl`` ("scan"), ``frontend_impl`` and ``tx_impl``
("xla") run a kernel's plain version on whatever device the tensors are
on, and "pallas" the kernel (a CPU tensor raises).

The family's receive recipe: ``rx_acquire_hz`` on the first frames of
PCM -> ``rx_init(acq_freq=acquire.hz_to_costas_freq(hz, cfg.rs))`` ->
``rx_stream`` -> ``sync.find_sync(..., modulation=cfg.modulation)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from qpsk_tpu_torch.config import ModemConfig
from qpsk_tpu_torch.ops import acquire, modfam, nco
from qpsk_tpu_torch.ops import rrc as rrc_ops
from qpsk_tpu_torch.ops.agc import agc_gains, agc_stream
from qpsk_tpu_torch.ops.costas import costas_params, freq_to_hz, gear_for
from qpsk_tpu_torch.ops.cplx import CF32, cmap
from qpsk_tpu_torch.ops.cuda.costas_kernel import costas_run_cm, costas_run_tm
# frontend_xla and taps_for are re-exported where the JAX package has them
from qpsk_tpu_torch.ops.cuda.frontend_kernel import (  # noqa: F401
    frontend_xla, rx_frontend, rx_frontend_tm)
from qpsk_tpu_torch.ops.cuda.tx_kernel import tx_modulate
from qpsk_tpu_torch.ops.equalizer import equalize_stream
from qpsk_tpu_torch.ops.modmap import bits_to_symbols
from qpsk_tpu_torch.ops.rrc import taps_for  # noqa: F401
from qpsk_tpu_torch.state import RxState, TxState

# (field, values the port implements) — every other value raises
_SLICE = (("modulation", ("qpsk", "bpsk", "8psk", "16qam")),
          ("differential", False),
          ("timing_mode", "power"), ("nco_mode", "fast"),
          ("fir_precision", "fast"), ("slicer", "diagonal"))


def check_slice(cfg: ModemConfig) -> None:
    """Raise ``NotImplementedError`` naming the first field that sets
    ``cfg`` off the ported modes: coherent QPSK, BPSK, 8PSK or 16QAM,
    power timing, fast NCO and FIR, diagonal slicer.  The AGC, the CMA
    equalizer and the gear-shift loop are ported.  The geometry is not
    checked here: CPU tensors run any geometry the JAX package takes, and
    each kernel wrapper checks its own before it launches."""
    for field, want in _SLICE:
        if getattr(cfg, field) not in (want if isinstance(want, tuple)
                                       else (want,)):
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r} is not ported "
                f"(the torch port implements {field}={want!r})")


def _mod_for(cfg: ModemConfig):
    """The ``modfam.Modulation`` of a generic-family config; None for
    QPSK, which keeps its own mapping, slicer and detector."""
    return None if cfg.modulation == "qpsk" else modfam.get(cfg.modulation)


class RxOut(NamedTuple):
    symbols: CF32               # (..., nframes, nsym) derotated symbols
    bits: torch.Tensor          # (..., nframes, bps*nsym) int32 sliced bits
    freq_hz: torch.Tensor       # (..., nframes) loop frequency per frame, Hz
    timing_index: torch.Tensor  # (..., nframes) int32 decimation phase


def _tree(x, leaf):
    """``leaf`` on every tensor of a state or output tuple; None stays."""
    if x is None:
        return None
    if isinstance(x, tuple):
        vals = [_tree(v, leaf) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return leaf(x)


def _with_channel_axis(state, squeeze: bool, fn):
    """Run ``fn(state)`` on a channel batch; a single stream's state gets
    a channel axis of one first and loses it after."""
    if not squeeze:
        return fn(state)
    new_state, out = fn(_tree(state, lambda v: v[None]))
    return _tree(new_state, lambda v: v[0]), _tree(out, lambda v: v[0])


def tx_stream(cfg: ModemConfig, state: TxState, bits: torch.Tensor,
              tx_offset_hz: float = 0.0, doppler_hz_per_s: float = 0.0):
    """Modulate ``(C, nframes, bits_per_frame)`` (or ``(nframes,
    bits_per_frame)``) bits to int16 PCM of the same leading shape and
    ``bits_per_frame // bps * cycles`` samples per frame, ``bps`` the
    modulation's bits per symbol.  ``tx_offset_hz`` is added to the
    carrier."""
    check_slice(cfg)
    if doppler_hz_per_s:
        raise NotImplementedError(
            f"doppler_hz_per_s={doppler_hz_per_s!r}: the chirped TX carrier "
            "is not ported")
    bps, mod = cfg.bits_per_symbol, _mod_for(cfg)
    if bits.dim() not in (2, 3) or bits.shape[-1] % bps:
        raise NotImplementedError(
            f"bits of shape {tuple(bits.shape)}: the torch port takes "
            "(C, nframes, bits_per_frame) or (nframes, bits_per_frame) "
            f"with bits_per_frame a multiple of {bps}")

    def run(st):
        frames = bits if bits.dim() == 3 else bits[None]
        c, nframes, nbits = frames.shape
        sym = (bits_to_symbols(frames) if mod is None
               else modfam.bits_to_symbols_mod(frames, mod))
        sym = cmap(lambda p: p.reshape(c, -1), sym)
        pcm, phase, tail = tx_modulate(cfg, sym, st.nco_phase, st.fir_tail,
                                       tx_offset_hz)
        return (TxState(fir_tail=tail, nco_phase=phase),
                pcm.reshape(c, nframes, nbits // bps * cfg.cycles))
    return _with_channel_axis(state, bits.dim() == 2, run)


def rx_stream(cfg: ModemConfig, state: RxState, pcm: torch.Tensor):
    """Demodulate ``(C, nframes, frame_size)`` (or ``(nframes,
    frame_size)``) int16 PCM.  Returns (new_state, RxOut).

    The symbols and bits of frame f belong to the samples of frame f-1
    (the reference's one-frame decimation delay); ``freq_hz`` is the loop
    frequency after each frame.  Without the equalizer and at 128 symbols
    per frame the receive runs the time-major path, otherwise the composed
    one; both give the same decisions."""
    check_slice(cfg)
    if (pcm.dim() not in (2, 3) or pcm.shape[-1] != cfg.frame_size
            or pcm.shape[-2] < 1):
        raise NotImplementedError(
            f"PCM of shape {tuple(pcm.shape)}: the torch port takes "
            f"(C, nframes, {cfg.frame_size}) or (nframes, {cfg.frame_size})")

    def run(st):
        frames = (pcm if pcm.dim() == 3 else pcm[None]).contiguous()
        chain, frontend, costas = _rx_path(cfg)
        return chain(cfg, st, frames, frontend, costas)
    return _with_channel_axis(state, pcm.dim() == 2, run)


def _rx_path(cfg: ModemConfig):
    """(chain, front-end, Costas) of ``rx_stream``: the time-major chain
    when there is no equalizer and a frame has 128 symbols, else the
    composed chain, each with its wrappers (which follow the config's
    lowering switches)."""
    if cfg.eq_taps == 0 and cfg.symbols_per_frame >= 128:
        return _rx_stream_tm, rx_frontend_tm, costas_run_tm
    return _rx_stream_composed, rx_frontend, costas_run_cm


def _loop(cfg: ModemConfig):
    """(params, gear, dd) of the config's Costas loop: ``dd`` is the
    generic family's (modulation, constellation scale), the scale being
    the AGC target, the symbol level the chain runs at."""
    dd = None if _mod_for(cfg) is None else (cfg.modulation, cfg.agc_target)
    return (costas_params(cfg.loop_bw, cfg.damping, cfg.min_freq,
                          cfg.max_freq),
            gear_for(cfg.loop_bw_track, cfg.damping), dd)


def _rx_stream_tm(cfg: ModemConfig, state: RxState, pcm: torch.Tensor,
                  frontend, costas):
    """The time-major RX chain: ``frontend`` emits the delayed (T, C) picks
    (and with ``cfg.agc`` their per-frame powers) that ``costas`` consumes,
    scaled by the AGC gains in-register.  ``rx_stream`` passes the kernel
    wrappers, which follow ``cfg``'s lowering switches."""
    nframes = pcm.shape[1]
    zr, zi, index, nco_phase, fir_tail, decim_delay, powers = frontend(
        cfg, pcm, state.nco_phase, state.fir_tail, state.decim_delay)
    agc_state, gains = state.agc, None
    if cfg.agc:
        agc_state, g = agc_gains(state.agc, powers, cfg.agc_target,
                                 cfg.agc_mu)
        gains = g.T.contiguous()                       # (F, C)
    params, gear, dd = _loop(cfg)
    cstate, derot_tm, freq_frames, bits = costas(
        state.costas, zr, zi, params, cfg.symbols_per_frame, gear=gear,
        gains=gains, dd=dd, impl=cfg.costas_impl)
    derot = CF32(derot_tm.re.T, derot_tm.im.T)
    return _emit(cfg, state._replace(
        fir_tail=fir_tail, nco_phase=nco_phase, costas=cstate,
        decim_delay=decim_delay, agc=agc_state), derot, bits, freq_frames,
        index, nframes)


def _rx_stream_composed(cfg: ModemConfig, state: RxState, pcm: torch.Tensor,
                        frontend, costas):
    """The composed RX chain (``qpsk_tpu.modem._rx_stream_fused`` past its
    time-major branch): ``frontend`` emits channel-major picks, then the
    one-frame delay, the AGC and the CMA equalizer run on (C, F, nsym)
    symbols, and ``costas`` (``costas_run_cm`` or its plain twin) tracks
    the (C, T) stream.  ``rx_stream`` passes the kernel wrappers."""
    c, nframes, _ = pcm.shape
    picks, index, nco_phase, fir_tail = frontend(cfg, pcm, state.nco_phase,
                                                 state.fir_tail)
    delayed = CF32(*(torch.cat([dd[:, None], p[:, :-1]], dim=1)
                     for dd, p in zip(state.decim_delay, picks)))
    decim_delay = cmap(lambda p: p[:, -1].contiguous(), picks)
    agc_state, eq_state = state.agc, state.eq
    if cfg.agc:
        agc_state, delayed = agc_stream(agc_state, delayed, cfg.agc_target,
                                        cfg.agc_mu)
    if cfg.eq_taps > 0:
        eq_state, delayed = equalize_stream(eq_state, delayed, cfg.eq_mu,
                                            cfg.eq_modulus)
    params, gear, dd = _loop(cfg)
    cstate, derot, freq_frames, bits = costas(
        state.costas, cmap(lambda p: p.reshape(c, -1), delayed), params,
        cfg.symbols_per_frame, gear=gear, dd=dd, impl=cfg.costas_impl)
    return _emit(cfg, state._replace(
        fir_tail=fir_tail, nco_phase=nco_phase, costas=cstate,
        decim_delay=decim_delay, agc=agc_state, eq=eq_state), derot, bits,
        freq_frames, index, nframes)


def _emit(cfg: ModemConfig, new_state: RxState, derot: CF32,
          bits: torch.Tensor, freq_frames: torch.Tensor,
          index: torch.Tensor, nframes: int):
    """Assemble RxOut from (C, T) derotated symbols and (C, bps*T) bits."""
    c, nsf = derot.re.shape[0], cfg.symbols_per_frame
    out = RxOut(symbols=cmap(lambda p: p.reshape(c, nframes, nsf), derot),
                bits=bits.reshape(c, nframes, cfg.bits_per_symbol * nsf),
                freq_hz=freq_to_hz(freq_frames, cfg.rs),
                timing_index=index)
    return new_state, out


def rx_acquire_hz(cfg: ModemConfig, pcm: torch.Tensor,
                  candidates: int = 0) -> torch.Tensor:
    """Coarse carrier-offset estimate (Hz) of int16 PCM ``(..., n)`` or
    ``(..., nframes, frame_size)`` from its first frames: mix-down, the
    matched filter and the M-power FFT estimator (``ops/acquire.py``),
    one estimate per leading index.  Warm-start the loop with
    ``rx_init(cfg, acq_freq=acquire.hz_to_costas_freq(est, cfg.rs))``.

    ``candidates=k`` > 0 returns the top-k candidate offsets (..., k):
    deterministic spurs can out-peak the carrier line at some offsets,
    and the sync hunt tells them apart.  8PSK and 16QAM, whose stripped
    lines are weak, use 4x the FFT length and average up to 8 blocks."""
    power = modfam.ACQUIRE_POWER[cfg.modulation]
    generic = cfg.modulation in ("8psk", "16qam")
    nfft_want = cfg.nfft * (4 if generic else 1)
    avg_want = 8 if generic else 1
    flat = pcm.reshape(pcm.shape[:-2] + (-1,)) if pcm.dim() >= 2 else pcm
    block = rrc_ops.pick_block(cfg.frame_size)
    n = min(flat.shape[-1],
            max(4 * cfg.nfft, avg_want * nfft_want + 2 * block, block))
    n -= n % block
    if n == 0:
        raise ValueError(f"acquisition needs at least {block} samples, got "
                         f"{flat.shape[-1]}")
    xr = flat[..., :n].to(torch.float32) / float(cfg.pcm_scale)
    dev = xr.device
    x, _ = nco.mix(CF32(xr, torch.zeros_like(xr)),
                   nco.nco_init(xr.shape[:-1], dev), -cfg.omega_center)
    tmat = torch.from_numpy(rrc_ops.toeplitz_taps(rrc_ops.taps_for(cfg),
                                                  block)).to(dev)
    x, _ = rrc_ops.fir_block(x, rrc_ops.fir_init_tail(cfg.ntaps, xr.shape[:-1],
                                                      dev),
                             tmat, cfg.gain, block)
    nfft = min(nfft_want, n)
    # skip the filter's fill-in, then as many whole blocks as there are
    start = min(cfg.ntaps, max(0, n - nfft))
    avg = max(1, min(avg_want, (n - start) // nfft))
    seg = cmap(lambda p: p[..., start:start + avg * nfft], x)
    if candidates:
        return acquire.acquire_freq_candidates(seg, cfg.fs, nfft=nfft,
                                               power=power, avg=avg,
                                               ncand=candidates)
    return acquire.acquire_freq_hz(seg, cfg.fs, nfft=nfft, power=power,
                                   avg=avg)
