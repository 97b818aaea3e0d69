"""Polyphase rational resampler, the sample-rate converter at the IO edge
(port of ``qpsk_tpu.ops.resample``).

The modem runs at 9600 S/s; sound cards run at 44.1 or 48 kHz.  This
module converts by any rational factor L/M (48000/9600 = 5/1,
9600/44100 = 32/147, ...) with one Kaiser-windowed-sinc prototype cut at
the narrower of the two Nyquists, so one filter serves as anti-image and
anti-alias filter.

The input is reshaped into M-sample groups, and each group's L output
samples are one row of a ``(..., n/M, (Q+1)*M) @ ((Q+1)*M, L)`` product
against a static polyphase matrix (Q history groups for K taps a phase):
y[jL+p] = sum_k h[(pM)%L + kL] * x[jM + floor(pM/L) - k].  The windows are
static shifted slices of the group array: no gather, no zero-stuffing.
The streaming state is the last Q*M input samples, so chunked calls chain
with the one-shot transform.  The prototype and the matrix are host
tables designed in float64 (like the LDPC matrix); the float32 matrix is
cached by device, so a call copies nothing from the host.  The product is
``torch.matmul``: no hand-written kernel, as the JAX package has none.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction

import numpy as np
import torch

from qpsk_tpu_torch.channel import _to_pcm


def rational_ratio(fs_in: float, fs_out: float, max_den: int = 1024):
    """(l, m) with fs_out/fs_in == l/m exactly (raises if not rational
    within max_den — e.g. 9600 -> 44100 gives (147, 32))."""
    fr = Fraction(fs_out / fs_in).limit_denominator(max_den)
    if abs(float(fr) * fs_in - fs_out) > 1e-6 * fs_out:
        raise ValueError(
            f"{fs_in} -> {fs_out} is not a rational ratio with denominator "
            f"<= {max_den}")
    return fr.numerator, fr.denominator


@functools.lru_cache(maxsize=None)
def resampler_taps(l: int, m: int, taps_per_phase: int = 16,
                   beta: float = 8.0) -> np.ndarray:
    """Prototype lowpass, float64: a Kaiser-windowed sinc cut at the
    narrower of the two Nyquists, normalized so the phase-average DC gain
    is exactly 1 (sum = L).  Its length is ``taps_per_phase * max(L, M)``
    rounded up to a multiple of L."""
    n = -(-taps_per_phase * max(l, m) // l) * l
    c = (n - 1) / 2.0
    fc = 1.0 / max(l, m)     # in units of the upsampled Nyquist
    i = np.arange(n, dtype=np.float64)
    h = fc * np.sinc(fc * (i - c)) * np.kaiser(n, beta)
    return (h * (l / h.sum())).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _poly_matrix(l: int, m: int, taps_per_phase: int, beta: float):
    """(G, Q): the ((Q+1)*M, L) float32 polyphase matrix and the
    history-group count.  Window row r of group j is input sample
    x[(j-Q)*M + r]; G[r, p] holds the tap multiplying it in output
    y[j*L + p]."""
    h = resampler_taps(l, m, taps_per_phase, beta)
    k_taps = len(h) // l
    q = max(1, math.ceil((k_taps - 1) / m))
    g = np.zeros(((q + 1) * m, l), np.float64)
    for p in range(l):
        base = (p * m) % l
        off = (p * m) // l
        for k in range(k_taps):
            r = q * m + off - k
            assert 0 <= r < (q + 1) * m, (r, p, k)
            g[r, p] = h[base + k * l]
    return g.astype(np.float32), q


@functools.lru_cache(maxsize=None)
def _poly_on(l: int, m: int, taps_per_phase: int, beta: float,
             device: torch.device) -> torch.Tensor:
    """``_poly_matrix``'s G on ``device``, copied there once."""
    return torch.from_numpy(_poly_matrix(l, m, taps_per_phase,
                                         beta)[0]).to(device)


def resample_init(l: int, m: int, taps_per_phase: int = 16,
                  batch_shape=(), device="cuda") -> torch.Tensor:
    """Carried input history (..., Q*M) on ``device``: zeros, silence
    before the stream (the group delay is (len(taps)-1)/(2*L) input
    samples of fill-in transient)."""
    _, q = _poly_matrix(l, m, taps_per_phase, 8.0)
    return torch.zeros(tuple(batch_shape) + (q * m,), dtype=torch.float32,
                       device=device)


def resample_stream(x: torch.Tensor, state: torch.Tensor, l: int, m: int,
                    taps_per_phase: int = 16, beta: float = 8.0):
    """Convert (..., n) float32 samples by L/M; n must divide by M.

    Returns (y (..., n*L/M), new_state).  Chunked calls chain with one call
    over the concatenated input to float32 rounding: the product's tiling
    may differ with the chunk's length."""
    _, q = _poly_matrix(l, m, taps_per_phase, beta)
    n = x.shape[-1]
    if n % m != 0:
        raise ValueError(
            f"input length {n} must be a multiple of M={m} (pad the final "
            "chunk with silence)")
    j = n // m
    batch = tuple(x.shape[:-1])
    groups = x.reshape(batch + (j, m))
    hist = state.reshape(batch + (q, m))
    ext = torch.cat([hist, groups], dim=-2)               # (..., J+Q, M)
    # window of group j = [groups[j-Q] .. groups[j]] = ext[j .. j+Q]:
    # Q+1 static shifted slices, concatenated on the tap axis
    w = torch.cat([ext[..., s:s + j, :] for s in range(q + 1)], dim=-1)
    # float32 product: torch leaves TF32 off by default, and the int16
    # rounding of the callers needs the float32 sums (TF32 would move them
    # by many LSB)
    y = torch.matmul(w, _poly_on(l, m, taps_per_phase, beta, x.device))
    # Next call's history is the last Q*M input samples *including* the
    # carried state: a chunk shorter than Q*M must keep the tail of the
    # previous history, so slice ext, not x.
    new_state = ext.reshape(batch + ((j + q) * m,))[..., -q * m:].clone()
    return y.reshape(batch + (j * l,)), new_state


def resample(x: torch.Tensor, l: int, m: int, taps_per_phase: int = 16,
             beta: float = 8.0) -> torch.Tensor:
    """One-shot L/M conversion of (..., n) float32 (n % M == 0)."""
    state = resample_init(l, m, taps_per_phase, x.shape[:-1], x.device)
    y, _ = resample_stream(x, state, l, m, taps_per_phase, beta)
    return y


def resample_pcm(pcm: torch.Tensor, fs_in: float, fs_out: float,
                 taps_per_phase: int = 16) -> torch.Tensor:
    """int16 PCM rate conversion fs_in -> fs_out: pads the tail to a whole
    M-group with silence, rounds half to even and saturates back to
    int16."""
    l, m = rational_ratio(fs_in, fs_out)
    x = pcm.to(torch.float32)
    npad = (-x.shape[-1]) % m
    if npad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (npad,))], dim=-1)
    return _to_pcm(resample(x, l, m, taps_per_phase))
