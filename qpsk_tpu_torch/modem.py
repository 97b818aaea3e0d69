"""Frame-level modem pipeline: TX and RX (port of ``qpsk_tpu.modem``, every
mode of ``ModemConfig``: QPSK and DQPSK, the generic family BPSK / 8PSK /
16QAM with FFT carrier acquisition, the four timing modes, the AGC, the
CMA equalizer, the gear-shift loop, parity mode).

TX:  bits -> QPSK, DQPSK (``ops/differential.py``) or family symbols ->
     zero-stuff x cycles -> RRC shape -> NCO mix up -> Re * pcm_scale ->
     int16 PCM (``ops/cuda/tx_kernel.py``); a Doppler chirp, the exact NCO
     or the exact FIR take the plain chain, as in the JAX package.
RX, time-major path (power timing, fast FIR, no equalizer, 128 symbols
     per frame): int16 PCM -> matched filter with modulated taps -> power
     timing -> decimate -> carrier phasor -> one-frame delay, time-major,
     with the per-frame pick power when ``cfg.agc``
                                         (``ops/cuda/frontend_kernel.py``)
     -> AGC gains on the (F, C) powers   (``ops/agc.py``)
     -> Costas (gear shift, AGC gains in-register) + diagonal slicer, or
     for the family the decision-directed detector + its Gray labels
                                         (``ops/cuda/costas_kernel.py``)
     -> DQPSK decode or the reference slicer on the derotated symbols.
RX, composed path: the channel-major front-end (1200 baud, the CMA
     equalizer), or the plain full-rate front-end (mix, block FIR, the
     fractional / tracking / histogram timing, the exact FIR) -> the
     one-frame delay -> ``agc_stream`` -> ``equalize_stream`` -> Costas on
     the (C, T) symbols (``costas_run_cm``) -> slicer or DQPSK decode.
RX, parity mode (``nco_mode="exact"``): ``rx_frame`` a frame at a time.

Every entry point takes ``cfg`` and explicit state and works on any
leading batch (folded into the kernels' channel axis) or a single stream.
The device of the input tensors picks the lowering: CUDA tensors go
through the hand-written kernels, CPU tensors through each kernel's plain
PyTorch version (the JAX package's staged lowering, in the kernels'
layouts), at any geometry the JAX package takes.  A CUDA tensor at a
geometry or code a kernel does not cover (taps, samples per symbol, frame
size, an LDPC or convolutional code) makes that kernel's wrapper raise
``NotImplementedError`` naming it before the launch.  The lowering
switches ``costas_impl`` ("scan"), ``frontend_impl`` and ``tx_impl``
("xla") run a kernel's plain version on whatever device the tensors are
on, and "pallas" the kernel (a CPU tensor raises).

The family's receive recipe: ``rx_acquire_hz`` on the first frames of
PCM -> ``rx_init(acq_freq=acquire.hz_to_costas_freq(hz, cfg.rs))`` ->
``rx_stream`` -> ``sync.find_sync(..., modulation=cfg.modulation)``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from qpsk_tpu_torch import tracing
from qpsk_tpu_torch.config import TAU, ModemConfig
from qpsk_tpu_torch.ops import acquire, modfam, nco
from qpsk_tpu_torch.ops import rrc as rrc_ops
from qpsk_tpu_torch.ops import timing as timing_ops
from qpsk_tpu_torch.ops.agc import agc_gains, agc_stream
from qpsk_tpu_torch.ops.costas import costas_params, freq_to_hz, gear_for
from qpsk_tpu_torch.ops.cplx import CF32, cmap
from qpsk_tpu_torch.ops.cuda.costas_kernel import costas_run_cm, costas_run_tm
# frontend_xla and taps_for are re-exported where the JAX package has them
from qpsk_tpu_torch.ops.cuda.frontend_kernel import (  # noqa: F401
    frontend_xla, rx_frontend, rx_frontend_tm)
from qpsk_tpu_torch.ops.cuda.tx_kernel import tx_modulate
from qpsk_tpu_torch.ops.differential import (diff_decode_symbols,
                                             diff_encode_bits)
from qpsk_tpu_torch.ops.equalizer import equalize_stream
from qpsk_tpu_torch.ops.modmap import (bits_to_symbols, demod_bits_reference,
                                       upsample_zero_stuff)
from qpsk_tpu_torch.ops.rrc import taps_for  # noqa: F401
from qpsk_tpu_torch.state import RxState, TxState


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


def _leaves(x):
    """The tensors of a state or output tuple."""
    if isinstance(x, tuple):
        for v in x:
            yield from _leaves(v)
    elif x is not None:
        yield x


def _batched(state, batch: tuple, fn):
    """Run ``fn`` on one channel axis: every state leaf's leading ``batch``
    axes (none for a single stream) fold into ``prod(batch)`` channels
    before, and the state's and outputs' unfold after.  A batch that is
    one axis already folds nothing: its leaves are only checked."""
    batch, c = tuple(batch), math.prod(batch)

    def fold(v):
        if tuple(v.shape[:len(batch)]) != batch:
            raise ValueError(f"a state leaf of shape {tuple(v.shape)} for "
                             f"the batch {batch}")
        return v.reshape((c,) + tuple(v.shape[len(batch):]))
    if len(batch) == 1:
        for v in _leaves(state):
            if v.shape[:1] != batch:
                fold(v)                           # raises ValueError
        return fn(state)
    new_state, out = fn(_tree(state, fold))
    unfold = lambda v: v.reshape(batch + tuple(v.shape[1:]))  # noqa: E731
    return _tree(new_state, unfold), _tree(out, unfold)


@functools.lru_cache(maxsize=None)
def _tmat(cfg: ModemConfig, block: int, device) -> torch.Tensor:
    """The RRC Toeplitz tile of ``cfg`` on ``device``."""
    return torch.from_numpy(rrc_ops.toeplitz_taps(taps_for(cfg),
                                                  block)).to(device)


def _modulate(cfg: ModemConfig, st: TxState, sym: CF32, tx_offset_hz: float,
              block: int, doppler_hz_per_s: float = 0.0):
    """(C, S) symbols -> (pcm (C, S*cycles) int16, new_nco_phase,
    new_fir_tail): the TX kernel's wrapper (``cfg.tx_impl`` picks its
    lowering), or, as the JAX package's TX kernel gate does for a chirp,
    the exact NCO or the exact FIR, the plain chain: zero-stuff, block FIR
    in tiles of ``block`` samples, NCO mix or chirp, int16."""
    if not (doppler_hz_per_s or cfg.fir_precision != "fast"
            or cfg.nco_mode != "fast"):
        return tx_modulate(cfg, sym, st.nco_phase, st.fir_tail, tx_offset_hz)
    sig = upsample_zero_stuff(sym, cfg.cycles)
    sig, tail = rrc_ops.fir_block(sig, st.fir_tail,
                                  _tmat(cfg, block, sig.re.device), cfg.gain,
                                  block, exact=cfg.fir_precision == "exact")
    omega = TAU * (cfg.center + tx_offset_hz) / cfg.fs
    if doppler_hz_per_s:
        sig, phase = nco.mix_chirp(sig, st.nco_phase, omega, TAU
                                   * doppler_hz_per_s / (cfg.fs * cfg.fs))
    else:
        sig, phase = nco.mix(sig, st.nco_phase, omega, cfg.nco_mode)
    # truncation toward zero, saturating as the JAX package's astype does
    pcm = torch.clamp(sig.re * cfg.pcm_scale, -32768.0, 32767.0)
    return pcm.to(torch.int16), phase, tail


def _symbols(cfg: ModemConfig, bits: torch.Tensor) -> CF32:
    """Coherent symbols of (..., bps*n) bits: QPSK or the family's Gray
    map."""
    mod = _mod_for(cfg)
    return (bits_to_symbols(bits) if mod is None
            else modfam.bits_to_symbols_mod(bits, mod))


def tx_frame(cfg: ModemConfig, state: TxState, symbols: CF32,
             tx_offset_hz: float = 0.0):
    """Modulate one frame of ``(..., n)`` symbols to ``(..., n*cycles)``
    int16 PCM; ``tx_offset_hz`` is added to the carrier.  Chained calls
    equal one ``tx_stream`` call within the PCM bounds."""
    batch, n = tuple(symbols.shape[:-1]), symbols.shape[-1]

    def run(st):
        sym = cmap(lambda p: p.reshape(-1, n).contiguous(), symbols)
        pcm, phase, tail = _modulate(cfg, st, sym, tx_offset_hz,
                                     rrc_ops.tile_block(n * cfg.cycles))
        return st._replace(fir_tail=tail, nco_phase=phase), pcm
    return _batched(state, batch, run)


def tx_bits_frame(cfg: ModemConfig, state: TxState, bits: torch.Tensor,
                  tx_offset_hz: float = 0.0):
    """Bits ``(..., bps*n)`` -> PCM, with the reference dibit packing; in
    differential mode the dibits are phase changes (``ops/differential``),
    the family maps through its Gray tables."""
    if not cfg.differential:
        return tx_frame(cfg, state, _symbols(cfg, bits), tx_offset_hz)
    sym, diff_phase = diff_encode_bits(bits, state.diff_phase)
    state, pcm = tx_frame(cfg, state, sym, tx_offset_hz)
    return state._replace(diff_phase=diff_phase), pcm


def tx_stream(cfg: ModemConfig, state: TxState, bits: torch.Tensor,
              tx_offset_hz: float = 0.0, doppler_hz_per_s: float = 0.0):
    """Modulate ``(..., nframes, bits_per_frame)`` bits to int16 PCM of the
    same leading shape and ``bits_per_frame // bps * cycles`` samples per
    frame, ``bps`` the modulation's bits per symbol.  ``tx_offset_hz`` is
    added to the carrier; ``doppler_hz_per_s`` chirps it (``nco.mix_chirp``,
    the carried phase exact only within one call).  Without a chirp the
    output chains with repeated ``tx_bits_frame`` calls."""
    bps = cfg.bits_per_symbol
    if bits.dim() < 2 or bits.shape[-1] % bps:
        raise NotImplementedError(
            f"bits of shape {tuple(bits.shape)}: the torch port takes "
            f"(..., nframes, bits_per_frame) with bits_per_frame a multiple "
            f"of {bps}")
    batch, (nframes, nbits) = tuple(bits.shape[:-2]), tuple(bits.shape[-2:])
    spf = nbits // bps * cfg.cycles

    def run(st):
        flat = bits.reshape(-1, nframes * nbits)
        diff_phase = st.diff_phase
        if cfg.differential:
            sym, diff_phase = diff_encode_bits(flat, diff_phase)
        else:
            sym = cmap(lambda p: p.contiguous(), _symbols(cfg, flat))
        pcm, phase, tail = _modulate(cfg, st, sym, tx_offset_hz,
                                     rrc_ops.tile_block(spf),
                                     doppler_hz_per_s)
        return (st._replace(fir_tail=tail, nco_phase=phase,
                            diff_phase=diff_phase),
                pcm.reshape(-1, nframes, spf))
    return _batched(state, batch, run)


@functools.lru_cache(maxsize=None)
def _loop(cfg: ModemConfig):
    """(params, gear, dd) of the config's Costas loop: ``dd`` is the
    generic family's (modulation, constellation scale), the scale being
    the AGC target, the symbol level the chain runs at."""
    dd = None if _mod_for(cfg) is None else (cfg.modulation, cfg.agc_target)
    return (costas_params(cfg.loop_bw, cfg.damping, cfg.min_freq,
                          cfg.max_freq),
            gear_for(cfg.loop_bw_track, cfg.damping), dd)


def _slice(cfg: ModemConfig, state: RxState, derot: CF32,
           bits: torch.Tensor):
    """(bits, state) of (C, T) derotated symbols whose Costas call sliced
    ``bits`` (QPSK's diagonal slicer or the family's labels): DQPSK
    decodes the symbols instead, carrying ``diff_prev``, and the reference
    slicer re-slices them."""
    if cfg.differential:
        bits, diff_prev = diff_decode_symbols(derot, state.diff_prev)
        return bits, state._replace(diff_prev=diff_prev)
    if cfg.slicer == "reference":
        return demod_bits_reference(derot), state
    return bits, state


def rx_frame(cfg: ModemConfig, state: RxState, pcm: torch.Tensor):
    """Demodulate one ``(..., n)`` block of int16 PCM, the C loop's frame
    (qpsk.c:88-218): the composed chain on one frame with the plain
    full-rate front-end (mix-down at ``cfg.nco_mode``, matched filter,
    timing), the one-frame delay (the symbols returned belong to the
    previous frame), AGC, equalizer and the Costas kernel
    (``costas_run_cm``, ``cfg.costas_impl`` picks its lowering).  Returns
    (new_state, RxOut) with per-frame ``symbols`` (..., n // cycles) and
    ``freq_hz`` / ``timing_index`` (...,)."""
    batch, n = tuple(pcm.shape[:-1]), pcm.shape[-1]

    def run(st):
        st, out = _rx_stream_full_rate(cfg, st, pcm.reshape(-1, 1, n),
                                       _frontend_full_rate, costas_run_cm)
        return st, _tree(out, lambda v: v[:, 0])
    return _batched(state, batch, run)


def rx_stream(cfg: ModemConfig, state: RxState, pcm: torch.Tensor):
    """Demodulate ``(..., nframes, frame_size)`` int16 PCM, any leading
    batch (folded into one channel axis for the kernels).  Returns
    (new_state, RxOut).

    The symbols and bits of frame f belong to the samples of frame f-1
    (the reference's one-frame decimation delay); ``freq_hz`` is the loop
    frequency after each frame.  ``nco_mode="exact"`` (parity mode) scans
    ``rx_frame`` a frame at a time, renormalizing the NCO per frame as the
    C loop does; every other config runs a chain over the whole stream
    (``_rx_path``)."""
    if (pcm.dim() < 2 or pcm.shape[-1] != cfg.frame_size
            or pcm.shape[-2] < 1):
        raise NotImplementedError(
            f"PCM of shape {tuple(pcm.shape)}: the torch port takes "
            f"(..., nframes, {cfg.frame_size})")
    batch = tuple(pcm.shape[:-2])

    def run(st):
        frames = pcm.reshape((-1,) + tuple(pcm.shape[-2:])).contiguous()
        if cfg.nco_mode == "exact":
            return _rx_stream_scan(cfg, st, frames)
        chain, frontend, costas = _rx_path(cfg)
        return chain(cfg, st, frames, frontend, costas)
    with tracing.span("rx_stream"):
        return _batched(state, batch, run)


def _rx_stream_scan(cfg: ModemConfig, state: RxState, pcm: torch.Tensor):
    """``rx_frame`` over the frames of (C, nframes, n) PCM, the outputs
    joined on the frame axis."""
    outs = []
    for f in range(pcm.shape[1]):
        state, out = _rx_stream_full_rate(cfg, state, pcm[:, f:f + 1],
                                          _frontend_full_rate, costas_run_cm)
        outs.append(out)

    def cat(get):
        return torch.cat([get(o) for o in outs], dim=1)
    return state, RxOut(
        symbols=CF32(cat(lambda o: o.symbols.re), cat(lambda o: o.symbols.im)),
        bits=cat(lambda o: o.bits), freq_hz=cat(lambda o: o.freq_hz),
        timing_index=cat(lambda o: o.timing_index))


def _kernel_frontend(cfg: ModemConfig) -> bool:
    """Whether the front-end kernel computes ``cfg``'s front-end: power
    timing with the fast FIR, as the JAX package's kernel gates require."""
    return cfg.timing_mode == "power" and cfg.fir_precision == "fast"


def _rx_path(cfg: ModemConfig):
    """(chain, front-end, Costas) of ``rx_stream``: the time-major chain
    when the front-end kernel computes the config, there is no equalizer
    and a frame has 128 symbols; else the composed chain, on the
    channel-major front-end kernel or, for the fractional, tracking and
    histogram timing and the exact FIR, on the plain full-rate front-end
    (mix, block FIR, timing).  The wrappers follow the config's lowering
    switches; ``frontend_impl="pallas"`` with a front-end the kernel does
    not compute raises ``ValueError``, as in the JAX package."""
    if not _kernel_frontend(cfg):
        if cfg.frontend_impl == "pallas":
            raise ValueError(
                "frontend_impl='pallas' forced but the front-end kernel only "
                "implements timing_mode='power' with fir_precision='fast' "
                f"(got timing_mode={cfg.timing_mode!r}, fir_precision="
                f"{cfg.fir_precision!r}); use frontend_impl='auto'")
        return _rx_stream_full_rate, _frontend_full_rate, costas_run_cm
    if cfg.eq_taps == 0 and cfg.symbols_per_frame >= 128:
        return _rx_stream_tm, rx_frontend_tm, costas_run_tm
    return _rx_stream_composed, rx_frontend, costas_run_cm


def _rx_stream_tm(cfg: ModemConfig, state: RxState, pcm: torch.Tensor,
                  frontend, costas):
    """The time-major RX chain: ``frontend`` emits the delayed (T, C) picks
    (and with ``cfg.agc`` their per-frame powers) that ``costas`` consumes,
    scaled by the AGC gains in-register.  ``rx_stream`` passes the kernel
    wrappers, which follow ``cfg``'s lowering switches."""
    nframes = pcm.shape[1]
    with tracing.span("rx.frontend"):
        zr, zi, index, nco_phase, fir_tail, decim_delay, powers = frontend(
            cfg, pcm, state.nco_phase, state.fir_tail, state.decim_delay)
    agc_state, gains = state.agc, None
    if cfg.agc:
        agc_state, g = agc_gains(state.agc, powers, cfg.agc_target,
                                 cfg.agc_mu)
        gains = g.T.contiguous()                       # (F, C)
    params, gear, dd = _loop(cfg)
    with tracing.span("rx.costas"):
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
    """The composed RX chain on a channel-major front-end (``rx_frontend``
    or its plain twin): its picks, then ``_back_half``."""
    with tracing.span("rx.frontend"):
        picks, index, nco_phase, fir_tail = frontend(
            cfg, pcm, state.nco_phase, state.fir_tail)
    return _back_half(cfg, state._replace(nco_phase=nco_phase,
                                          fir_tail=fir_tail),
                      picks, index, costas)


def _rx_stream_full_rate(cfg: ModemConfig, state: RxState,
                         pcm: torch.Tensor, frontend, costas):
    """The composed RX chain on the plain full-rate front-end
    (``_frontend_full_rate``, which also carries the timing PLL), then
    ``_back_half``."""
    with tracing.span("rx.frontend"):
        picks, index, state = frontend(cfg, pcm, state)
    return _back_half(cfg, state, picks, index, costas)


def _frontend_full_rate(cfg: ModemConfig, pcm: torch.Tensor, state: RxState):
    """The plain front-end of the timing modes, the exact FIR and
    ``rx_frame`` (``qpsk_tpu.modem._rx_stream_fused``'s full-rate staging
    and ``rx_frame``'s): mix-down (``cfg.nco_mode``), block FIR
    (``cfg.fir_precision``), then the configured timing over (C, nframes,
    n) PCM.  Returns (picks (C, F, n // cycles), index (C, F) int32,
    state with the new NCO phase, FIR tail and timing PLL)."""
    c, nframes, fsz = pcm.shape
    flat = pcm.reshape(c, nframes * fsz).to(torch.float32) / cfg.pcm_scale
    x, nco_phase = nco.mix(CF32(flat, torch.zeros_like(flat)),
                           state.nco_phase, -cfg.omega_center, cfg.nco_mode)
    block = rrc_ops.pick_block(fsz)
    x, fir_tail = rrc_ops.fir_block(x, state.fir_tail,
                                    _tmat(cfg, block, pcm.device), cfg.gain,
                                    block, exact=cfg.fir_precision == "exact")
    frames = cmap(lambda p: p.reshape(c, nframes, fsz), x)
    timing = state.timing
    if cfg.timing_mode == "tracking":
        tau, timing = timing_ops.timing_track(frames, cfg.cycles, timing)
        picks = timing_ops.decimate_fractional(frames, tau, cfg.cycles)
        index = torch.round(tau).to(torch.int32)
    else:
        picks, index = timing_ops.estimate_and_decimate(frames, cfg.cycles,
                                                        cfg.timing_mode)
    return picks, index, state._replace(nco_phase=nco_phase,
                                        fir_tail=fir_tail, timing=timing)


def _back_half(cfg: ModemConfig, state: RxState, picks: CF32,
               index: torch.Tensor, costas):
    """The composed chain past its front-end
    (``qpsk_tpu.modem._rx_stream_fused`` past its time-major branch): the
    one-frame delay, the AGC and the CMA equalizer on (C, F, nsym) picks,
    then ``costas`` (``costas_run_cm`` or its plain twin) on the (C, T)
    stream."""
    c, nframes, nsym = picks.re.shape
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
    with tracing.span("rx.costas"):
        cstate, derot, freq_frames, bits = costas(
            state.costas, cmap(lambda p: p.reshape(c, -1), delayed), params,
            nsym, gear=gear, dd=dd, impl=cfg.costas_impl)
    return _emit(cfg, state._replace(
        costas=cstate, decim_delay=decim_delay, agc=agc_state, eq=eq_state),
        derot, bits, freq_frames, index, nframes)


def _emit(cfg: ModemConfig, new_state: RxState, derot: CF32,
          bits: torch.Tensor, freq_frames: torch.Tensor,
          index: torch.Tensor, nframes: int):
    """Assemble RxOut from (C, T) derotated symbols and the (C, bps*T)
    bits the Costas call sliced (``_slice`` re-slices them for DQPSK and
    the reference slicer)."""
    with tracing.span("rx.emit"):
        c, nsf = derot.re.shape[0], derot.re.shape[1] // nframes
        bits, new_state = _slice(cfg, new_state, derot, bits)
        out = RxOut(
            symbols=cmap(lambda p: p.reshape(c, nframes, nsf), derot),
            bits=bits.reshape(c, nframes, cfg.bits_per_symbol * nsf),
            freq_hz=freq_to_hz(freq_frames, cfg.rs), timing_index=index)
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
    x, _ = rrc_ops.fir_block(x, rrc_ops.fir_init_tail(cfg.ntaps, xr.shape[:-1],
                                                      dev),
                             _tmat(cfg, block, dev), cfg.gain, block)
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
