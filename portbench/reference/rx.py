"""Plain reference of the modem's receive chain, from its published
semantics: the matched filter, the power timing and decimation with the
one-frame delay, the Costas loop and the diagonal slicer.

It imports nothing of the program and takes nothing the program made: the
taps are designed here from the configuration's fields, the carrier and the
loop gains are worked out here, and the arithmetic is float64 (complex128)
unless a lower precision is asked for, as the control does.

Semantics (one call of ``F`` frames of ``fsz`` int16 samples a channel):

* ``x = pcm / pcm_scale``; the mixed-down sample at absolute position ``n``
  is ``x[n] e^{-j w (n + 1)}`` (the carrier ``w = 2 pi center / fs``
  advanced before each sample);
* matched filter ``y[n] = gain * sum_k h[k] xm[n - k]``, ``h`` the RRC taps
  (their sum is ``gain``), zero history before the stream;
* power timing: per frame, the phase ``p`` in ``[0, cycles)`` with the
  largest mean ``|y[f fsz + i cycles + p]|^2`` over the frame's symbols;
  the picks are those samples;
* one-frame delay: the symbols of frame ``f`` are the picks of frame
  ``f - 1`` (zeros before the stream);
* Costas loop a symbol at a time: ``out = z e^{-j phase}``,
  ``err = s(Re out) Im out - s(Im out) Re out`` with ``s(v) = 1 if v > 0
  else -1``, ``freq += beta err``, ``phase = (phase + freq) + alpha err``,
  the phase wrapped by two conditional steps of 2 pi each way, ``freq``
  clamped; ``alpha, beta`` from the loop bandwidth and damping;
* slicer: bits ``[Im out < 0, Re out < 0]`` a symbol; the loop frequency
  after each frame's last symbol, in Hz, is ``freq rs / (2 pi)``.
"""

from __future__ import annotations

import cmath
import math

import numpy as np
import torch

TAU = 2.0 * math.pi


def rrc_taps(fs: float, rs: float, alpha: float, ntaps: int,
             gain: float) -> np.ndarray:
    """The modem's RRC taps, float64, scaled to sum to ``gain`` (the closed
    form of the modem's published filter design, its special cases at
    ``t = 0`` and ``|4 alpha t| = 1`` included)."""
    spb = fs / rs
    half = ntaps // 2
    h = np.zeros(ntaps)
    for i in range(ntaps):
        t = float(i - half)
        x1 = math.pi * t / spb
        x2 = 4.0 * alpha * t / spb
        x3 = x2 * x2 - 1.0
        if abs(x3) >= 1e-6:
            if i != half:
                num = (math.cos((1.0 + alpha) * x1)
                       + math.sin((1.0 - alpha) * x1) / (4.0 * alpha * t / spb))
            else:
                num = (math.cos((1.0 + alpha) * x1)
                       + (1.0 - alpha) * math.pi / (4.0 * alpha))
            den = x3 * math.pi
        else:
            x3s = (1.0 - alpha) * x1
            x2s = (1.0 + alpha) * x1
            num = (math.sin(x2s) * (1.0 + alpha) * math.pi
                   - math.cos(x3s) * ((1.0 - alpha) * math.pi * spb)
                   / (4.0 * alpha * t)
                   + math.sin(x3s) * spb * spb / (4.0 * alpha * t * t))
            den = -32.0 * math.pi * alpha * alpha * t / spb
        h[i] = 4.0 * alpha * num / den
    return h * gain / h.sum()


def loop_gains(loop_bw: float, damping: float) -> tuple:
    """(alpha, beta) of the second-order Costas loop."""
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    return 4.0 * damping * loop_bw / denom, 4.0 * loop_bw * loop_bw / denom


def _filter(x: torch.Tensor, taps: np.ndarray, fir_dtype) -> torch.Tensor:
    """Complex ``(C, n)`` samples through the real FIR ``taps`` (causal,
    zero history), by FFT.  ``fir_dtype`` rounds the samples and taps to
    that type first and sums in float32 (the control's lower precision);
    None keeps float64."""
    n, k = x.shape[-1], len(taps)
    h = torch.as_tensor(taps, dtype=torch.float64, device=x.device)
    if fir_dtype is not None:
        x = torch.complex(x.real.to(fir_dtype).to(torch.float32),
                          x.imag.to(fir_dtype).to(torch.float32))
        h = h.to(fir_dtype).to(torch.float32)
    size = 1 << (n + k - 1).bit_length()
    y = torch.fft.ifft(torch.fft.fft(x, size) * torch.fft.fft(h, size))
    return y[..., :n]


def frontend(cfg: dict, pcm: torch.Tensor, hist: torch.Tensor, n0: int,
             fir_dtype=None):
    """Picks and timing of ``(C, F, fsz)`` int16 PCM whose stream position
    starts at sample ``n0``, ``hist`` the ``(C, ntaps - 1)`` int16 samples
    before it (zeros at the stream's start).  Returns (picks complex
    ``(C, F, nsym)``, index int64 ``(C, F)``)."""
    c, nframes, fsz = pcm.shape
    cyc = int(cfg["fs"] // cfg["rs"])
    nsym = fsz // cyc
    taps = rrc_taps(cfg["fs"], cfg["rs"], cfg["alpha"], cfg["ntaps"],
                    cfg["gain"])
    h = cfg["ntaps"] - 1
    raw = torch.cat([hist.to(torch.float64),
                     pcm.reshape(c, -1).to(torch.float64)], dim=-1)
    raw = raw / cfg["pcm_scale"]
    w = TAU * cfg["center"] / cfg["fs"]
    pos = torch.arange(n0 - h, n0 + nframes * fsz, dtype=torch.float64,
                       device=pcm.device)
    ang = torch.remainder(-w * (pos + 1.0), TAU)
    xm = raw * torch.polar(torch.ones_like(ang), ang)
    y = _filter(xm, taps, fir_dtype)[..., h:] * cfg["gain"]
    frames = y.reshape(c, nframes, nsym, cyc)
    energy = (frames.real ** 2 + frames.imag ** 2).mean(dim=-2)
    index = torch.argmax(energy, dim=-1)
    picks = torch.gather(frames, -1, index[..., None, None].expand(
        c, nframes, nsym, 1))[..., 0]
    return picks.to(torch.complex128), index


def costas(z: torch.Tensor, phase: torch.Tensor, freq: torch.Tensor,
           cfg: dict, nsym: int, guide: torch.Tensor | None = None,
           tie: float = 0.0):
    """The loop over ``(C, T)`` symbols from ``(phase, freq)``.  Returns
    (derotated ``(C, T)``, new phase, new freq, the frequency after each
    ``nsym`` symbols ``(C, T // nsym)``).

    ``guide``, the judged side's derotated symbols, settles the detector's
    ties: where a derotated component lies within ``tie`` of zero, either
    sign is right to rounding, and the loop takes the guide's; a sign
    flipped there kicks the loop by twice the other component, and the two
    sides would part for some symbols on rounding alone."""
    alpha, beta = loop_gains(cfg["loop_bw"], cfg["damping"])
    lo, hi = cfg["min_freq"], cfg["max_freq"]
    dev = z.device
    # a step is a few operations on C numbers: numpy on the host runs them
    # at a microsecond each, where a device launch costs several
    zt = np.ascontiguousarray(z.T.cpu().numpy())           # (T, C)
    gt = None if guide is None else np.ascontiguousarray(
        guide.T.cpu().numpy())
    ph = phase.to(torch.float64).cpu().numpy().copy()
    fr = freq.to(torch.float64).cpu().numpy().copy()
    out = np.empty_like(zt)
    trace = []
    for t in range(zt.shape[0]):
        o = zt[t] * np.exp(-1j * ph)
        out[t] = o
        orr, oi = o.real, o.imag
        rr, ii = orr, oi
        if gt is not None:
            rr = np.where(np.abs(orr) < tie, gt[t].real, orr)
            ii = np.where(np.abs(oi) < tie, gt[t].imag, oi)
        err = np.where(rr > 0, oi, -oi) - np.where(ii > 0, orr, -orr)
        fr = fr + beta * err
        ph = (ph + fr) + alpha * err
        for _ in range(2):
            ph = np.where(ph > TAU, ph - TAU, ph)
        for _ in range(2):
            ph = np.where(ph < -TAU, ph + TAU, ph)
        fr = np.clip(fr, lo, hi)
        if (t + 1) % nsym == 0:
            trace.append(fr)

    def back(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return back(out.T), back(ph), back(fr), back(np.stack(trace, axis=-1))


def carried(cfg: dict, raw_tail: torch.Tensor, n_end: int) -> tuple:
    """The front-end's carried state after stream sample ``n_end``, in the
    form the modem carries it: the filter tail mixed down, sample ``i`` of
    the last ``ntaps - 1`` times ``e^{-j w (n_end + i - (ntaps - 2))}``,
    and the carrier phasor ``e^{-j w n_end}``."""
    w = TAU * cfg["center"] / cfg["fs"]
    h = cfg["ntaps"] - 1
    offs = torch.arange(h, dtype=torch.float64, device=raw_tail.device)
    ang = torch.remainder(-w * (n_end + offs - (h - 1)), TAU)
    tail = (raw_tail.to(torch.float64) / cfg["pcm_scale"]) * torch.polar(
        torch.ones_like(ang), ang)
    return tail, cmath.exp(-1j * math.remainder(w * n_end, TAU))


def check(cfg: dict) -> None:
    """Raise unless ``cfg`` is a configuration this reference covers: QPSK
    with power timing, the diagonal slicer and one loop bandwidth, no AGC,
    equalizer or differential coding."""
    want = {"modulation": "qpsk", "timing_mode": "power",
            "slicer": "diagonal", "differential": False, "eq_taps": 0,
            "agc": False, "loop_bw_track": 0.0, "nco_mode": "fast"}
    off = {k: cfg.get(k) for k, v in want.items() if cfg.get(k, v) != v}
    if off:
        raise NotImplementedError(f"the reference does not cover {off}")


def receive(cfg: dict, pcm: torch.Tensor, prev: torch.Tensor | None,
            phase: torch.Tensor, freq: torch.Tensor, n0: int,
            fir_dtype=None, guide: torch.Tensor | None = None,
            tie: float = 0.0) -> dict:
    """One call of the receive chain on ``(C, F, fsz)`` PCM at stream
    position ``n0``.  ``prev`` is the PCM of the call before it (None at
    the stream's start); the loop starts from ``(phase, freq)``.

    Returns a dict: ``symbols`` complex ``(C, F, nsym)``, ``bits`` int64
    ``(C, F, 2 nsym)``, ``index`` ``(C, F)``, ``freq_hz`` ``(C, F)``, and
    the carried state after the call: ``phase``, ``freq``,
    ``decim_delay`` (the last frame's picks) and ``raw_tail`` (the last
    ``ntaps - 1`` samples)."""
    check(cfg)
    c, nframes, fsz = pcm.shape
    nsym = fsz // int(cfg["fs"] // cfg["rs"])
    h = cfg["ntaps"] - 1
    if prev is None:
        hist = torch.zeros((c, h), dtype=torch.int16, device=pcm.device)
        delay = torch.zeros((c, nsym), dtype=torch.complex128,
                            device=pcm.device)
    else:
        flat = prev.reshape(c, -1)
        hist = flat[:, -h:]
        last, _ = frontend(cfg, flat[:, -fsz:].reshape(c, 1, fsz),
                           flat[:, -fsz - h:-fsz], n0 - fsz, fir_dtype)
        delay = last[:, 0]
    picks, index = frontend(cfg, pcm, hist, n0, fir_dtype)
    z = torch.cat([delay[:, None], picks[:, :-1]], dim=1).reshape(c, -1)
    derot, phase, freq, trace = costas(
        z, phase, freq, cfg, nsym,
        None if guide is None else guide.reshape(c, -1), tie)
    sym = derot.reshape(c, nframes, nsym)
    bits = torch.stack([sym.imag < 0, sym.real < 0], dim=-1).to(torch.int64)
    return {"symbols": sym, "bits": bits.reshape(c, nframes, 2 * nsym),
            "index": index, "freq_hz": trace * (cfg["rs"] / TAU),
            "phase": phase, "freq": freq, "decim_delay": picks[:, -1],
            "raw_tail": pcm.reshape(c, -1)[:, -h:]}
