"""Frame-level modem pipeline: TX and RX streams (port of ``qpsk_tpu.modem``
for coherent QPSK with its loop and channel options).

TX:  bits -> QPSK symbols -> zero-stuff x cycles -> RRC shape -> NCO mix up
     -> Re * pcm_scale -> int16 PCM            (``ops/cuda/tx_kernel.py``)
RX, time-major path (no equalizer, 128 symbols per frame):
     int16 PCM -> matched filter with modulated taps -> power timing ->
     decimate -> carrier phasor -> one-frame delay, time-major, with the
     per-frame pick power when ``cfg.agc``      (``ops/cuda/frontend_kernel.py``)
     -> AGC gains on the (F, C) powers          (``ops/agc.py``)
     -> Costas (gear shift, AGC gains in-register) + diagonal slicer
                                               (``ops/cuda/costas_kernel.py``)
RX, composed path (1200 baud, the CMA equalizer): the channel-major
     front-end -> the one-frame delay -> ``agc_stream`` -> ``equalize_stream``
     (``ops/equalizer.py``) -> Costas on the (C, T) symbols.

Every function takes ``cfg`` and explicit state and works on a channel
batch ``(C, ...)`` or a single stream.  The device of the input tensors
picks the lowering: CUDA tensors go through the hand-written kernels, CPU
tensors through each kernel's plain PyTorch version (the JAX package's
staged lowering, in the kernels' layouts).  Configurations off the port
raise ``NotImplementedError`` naming the field.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from qpsk_tpu_torch.config import ModemConfig
from qpsk_tpu_torch.ops.agc import agc_gains, agc_stream
from qpsk_tpu_torch.ops.costas import costas_params, freq_to_hz, gear_for
from qpsk_tpu_torch.ops.cplx import CF32, cmap
from qpsk_tpu_torch.ops.cuda._lib import check_geometry
from qpsk_tpu_torch.ops.cuda.costas_kernel import costas_run_cm, costas_run_tm
# frontend_xla and taps_for are re-exported where the JAX package has them
from qpsk_tpu_torch.ops.cuda.frontend_kernel import (  # noqa: F401
    frontend_xla, rx_frontend, rx_frontend_tm)
from qpsk_tpu_torch.ops.cuda.tx_kernel import tx_modulate
from qpsk_tpu_torch.ops.equalizer import equalize_stream
from qpsk_tpu_torch.ops.modmap import bits_to_symbols
from qpsk_tpu_torch.ops.rrc import taps_for  # noqa: F401
from qpsk_tpu_torch.state import RxState, TxState

# (field, value the port implements) — every other value raises
_SLICE = (("modulation", "qpsk"), ("differential", False),
          ("timing_mode", "power"), ("nco_mode", "fast"),
          ("fir_precision", "fast"), ("slicer", "diagonal"),
          ("costas_impl", "auto"), ("frontend_impl", "auto"),
          ("tx_impl", "auto"))


def check_slice(cfg: ModemConfig) -> None:
    """Raise ``NotImplementedError`` naming the first field that sets
    ``cfg`` off the ported modes: coherent QPSK, power timing, fast NCO and
    FIR, diagonal slicer, and the geometry the CUDA kernels are built for
    (4 or 8 samples per symbol, 127 taps, 512-sample frames).  The AGC,
    the CMA equalizer and the gear-shift loop are ported."""
    for field, want in _SLICE:
        if getattr(cfg, field) != want:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r} is not ported "
                f"(the torch port implements {field}={want!r})")
    check_geometry(cfg)


class RxOut(NamedTuple):
    symbols: CF32               # (..., nframes, nsym) derotated symbols
    bits: torch.Tensor          # (..., nframes, 2*nsym) int32 sliced bits
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
    ``bits_per_frame // 2 * cycles`` samples per frame.
    ``tx_offset_hz`` is added to the carrier."""
    check_slice(cfg)
    if doppler_hz_per_s:
        raise NotImplementedError(
            f"doppler_hz_per_s={doppler_hz_per_s!r}: the chirped TX carrier "
            "is not ported")
    if bits.dim() not in (2, 3) or bits.shape[-1] % 2:
        raise NotImplementedError(
            f"bits of shape {tuple(bits.shape)}: the torch port takes "
            "(C, nframes, bits_per_frame) or (nframes, bits_per_frame) "
            "with an even bits_per_frame")

    def run(st):
        frames = bits if bits.dim() == 3 else bits[None]
        c, nframes, nbits = frames.shape
        sym = cmap(lambda p: p.reshape(c, -1), bits_to_symbols(frames))
        pcm, phase, tail = tx_modulate(cfg, sym, st.nco_phase, st.fir_tail,
                                       tx_offset_hz)
        return (TxState(fir_tail=tail, nco_phase=phase),
                pcm.reshape(c, nframes, nbits // 2 * cfg.cycles))
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
    composed chain, each with its kernel wrappers."""
    if cfg.eq_taps == 0 and cfg.symbols_per_frame >= 128:
        return _rx_stream_tm, rx_frontend_tm, costas_run_tm
    return _rx_stream_composed, rx_frontend, costas_run_cm


def _loop(cfg: ModemConfig):
    return (costas_params(cfg.loop_bw, cfg.damping, cfg.min_freq,
                          cfg.max_freq), gear_for(cfg.loop_bw_track,
                                                  cfg.damping))


def _rx_stream_tm(cfg: ModemConfig, state: RxState, pcm: torch.Tensor,
                  frontend, costas):
    """The time-major RX chain: ``frontend`` emits the delayed (T, C) picks
    (and with ``cfg.agc`` their per-frame powers) that ``costas`` consumes,
    scaled by the AGC gains in-register.  ``rx_stream`` passes the kernel
    wrappers; the chip smoke test passes their plain versions to time that
    path."""
    nframes = pcm.shape[1]
    zr, zi, index, nco_phase, fir_tail, decim_delay, powers = frontend(
        cfg, pcm, state.nco_phase, state.fir_tail, state.decim_delay)
    agc_state, gains = state.agc, None
    if cfg.agc:
        agc_state, g = agc_gains(state.agc, powers, cfg.agc_target,
                                 cfg.agc_mu)
        gains = g.T.contiguous()                       # (F, C)
    params, gear = _loop(cfg)
    cstate, derot_tm, freq_frames, bits = costas(
        state.costas, zr, zi, params, cfg.symbols_per_frame, gear=gear,
        gains=gains)
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
    params, gear = _loop(cfg)
    cstate, derot, freq_frames, bits = costas(
        state.costas, cmap(lambda p: p.reshape(c, -1), delayed), params,
        cfg.symbols_per_frame, gear=gear)
    return _emit(cfg, state._replace(
        fir_tail=fir_tail, nco_phase=nco_phase, costas=cstate,
        decim_delay=decim_delay, agc=agc_state, eq=eq_state), derot, bits,
        freq_frames, index, nframes)


def _emit(cfg: ModemConfig, new_state: RxState, derot: CF32,
          bits: torch.Tensor, freq_frames: torch.Tensor,
          index: torch.Tensor, nframes: int):
    """Assemble RxOut from (C, T) derotated symbols and (C, 2T) bits."""
    c, nsf = derot.re.shape[0], cfg.symbols_per_frame
    out = RxOut(symbols=cmap(lambda p: p.reshape(c, nframes, nsf), derot),
                bits=bits.reshape(c, nframes, 2 * nsf),
                freq_hz=freq_to_hz(freq_frames, cfg.rs),
                timing_index=index)
    return new_state, out
