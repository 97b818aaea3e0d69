"""Frame-level modem pipeline: TX and RX streams (port of ``qpsk_tpu.modem``
for the uncoded QPSK slice).

TX:  bits -> QPSK symbols -> zero-stuff x cycles -> RRC shape -> NCO mix up
     -> Re * pcm_scale -> int16 PCM            (``ops/cuda/tx_kernel.py``)
RX:  int16 PCM -> matched filter with modulated taps -> power timing ->
     decimate -> carrier phasor -> one-frame delay, time-major
                                               (``ops/cuda/frontend_kernel.py``)
     -> Costas derotate + diagonal slicer     (``ops/cuda/costas_kernel.py``)

Every function takes ``cfg`` and explicit state and works on a channel
batch ``(C, ...)`` or a single stream.  The device of the input tensors
picks the lowering: CUDA tensors go through the hand-written kernels, CPU
tensors through each kernel's plain PyTorch version (the JAX package's
staged lowering, in the kernels' layouts).  Configurations off the slice
raise ``NotImplementedError`` naming the field.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from qpsk_tpu_torch.config import ModemConfig
from qpsk_tpu_torch.ops.costas import costas_params, freq_to_hz
from qpsk_tpu_torch.ops.cplx import CF32, cmap
from qpsk_tpu_torch.ops.cuda._lib import check_geometry
from qpsk_tpu_torch.ops.cuda.costas_kernel import costas_run_tm
# frontend_xla and taps_for are re-exported where the JAX package has them
from qpsk_tpu_torch.ops.cuda.frontend_kernel import (  # noqa: F401
    frontend_xla, rx_frontend_tm)
from qpsk_tpu_torch.ops.cuda.tx_kernel import tx_modulate
from qpsk_tpu_torch.ops.modmap import bits_to_symbols
from qpsk_tpu_torch.ops.rrc import taps_for  # noqa: F401
from qpsk_tpu_torch.state import RxState, TxState

# (field, value the slice implements) — every other value raises
_SLICE = (("modulation", "qpsk"), ("differential", False), ("agc", False),
          ("eq_taps", 0), ("loop_bw_track", 0.0), ("timing_mode", "power"),
          ("nco_mode", "fast"), ("fir_precision", "fast"),
          ("slicer", "diagonal"), ("costas_impl", "auto"),
          ("frontend_impl", "auto"), ("tx_impl", "auto"))


def check_slice(cfg: ModemConfig) -> None:
    """Raise ``NotImplementedError`` naming the first field that sets
    ``cfg`` off the ported slice: uncoded coherent QPSK, power timing,
    fast NCO and FIR, diagonal slicer, single-bandwidth Costas loop, and
    the geometry the CUDA kernels are built for (4 samples per symbol,
    127 taps, 512-sample frames)."""
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


def _with_channel_axis(state, squeeze: bool, fn):
    """Run ``fn(state)`` on a channel batch; a single stream's state gets
    a channel axis of one first and loses it after."""
    def tree(x, leaf):
        if hasattr(x, "_fields"):
            return type(x)(*[tree(v, leaf) for v in x])
        return leaf(x)
    if not squeeze:
        return fn(state)
    new_state, out = fn(tree(state, lambda v: v[None]))
    return tree(new_state, lambda v: v[0]), tree(out, lambda v: v[0])


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
    frequency after each frame."""
    check_slice(cfg)
    if (pcm.dim() not in (2, 3) or pcm.shape[-1] != cfg.frame_size
            or pcm.shape[-2] < 1):
        raise NotImplementedError(
            f"PCM of shape {tuple(pcm.shape)}: the torch port takes "
            f"(C, nframes, {cfg.frame_size}) or (nframes, {cfg.frame_size})")

    def run(st):
        frames = (pcm if pcm.dim() == 3 else pcm[None]).contiguous()
        return _rx_stream_tm(cfg, st, frames, rx_frontend_tm, costas_run_tm)
    return _with_channel_axis(state, pcm.dim() == 2, run)


def _rx_stream_tm(cfg: ModemConfig, state: RxState, pcm: torch.Tensor,
                  frontend, costas):
    """The time-major RX chain: ``frontend`` emits the delayed (T, C) picks
    that ``costas`` consumes.  ``rx_stream`` passes the kernel wrappers;
    the chip smoke test passes their plain versions to time that path."""
    c, nframes, _ = pcm.shape
    nsf = cfg.symbols_per_frame
    zr, zi, index, nco_phase, fir_tail, decim_delay = frontend(
        cfg, pcm, state.nco_phase, state.fir_tail, state.decim_delay)
    params = costas_params(cfg.loop_bw, cfg.damping, cfg.min_freq,
                           cfg.max_freq)
    cstate, derot_tm, freq_frames, bits = costas(state.costas, zr, zi, params,
                                                 trace_every=nsf)
    out = RxOut(symbols=cmap(lambda p: p.T.reshape(c, nframes, nsf), derot_tm),
                bits=bits.reshape(c, nframes, 2 * nsf),
                freq_hz=freq_to_hz(freq_frames, cfg.rs),
                timing_index=index)
    return RxState(fir_tail=fir_tail, nco_phase=nco_phase, costas=cstate,
                   decim_delay=decim_delay), out
