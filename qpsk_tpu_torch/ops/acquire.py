"""FFT carrier acquisition (port of ``qpsk_tpu.ops.acquire``).

Raising an M-PSK/QAM baseband signal to the modulation's strip power
(``modfam.ACQUIRE_POWER``: BPSK 2, QPSK and 16QAM 4, 8PSK 8) removes the
modulation and leaves a line at ``power * offset``; the peak of its
(Welch-averaged) power spectrum, refined by a parabola through the
neighbouring bins, gives the offset to a fraction of a bin.  The estimate
seeds the Costas loop (``rx_init(acq_freq=hz_to_costas_freq(...))``),
whose decision-directed pull-in for the generic family is about +-50 Hz.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qpsk_tpu_torch.ops import fft as fft_ops
from qpsk_tpu_torch.ops.cplx import CF32, cmul


def quadruple(x: CF32) -> CF32:
    """z^4 by two squarings."""
    z2 = cmul(x, x)
    return cmul(z2, z2)


def _mpower(x: CF32, power: int) -> CF32:
    """z^power by repeated squaring, power in {2, 4, 8}."""
    if power not in (2, 4, 8):
        raise ValueError(f"strip power {power} is not 2, 4 or 8")
    z = cmul(x, x)
    if power >= 4:
        z = cmul(z, z)
    if power == 8:
        z = cmul(z, z)
    return z


def _psd(x: CF32, nfft: int, power: int, avg: int) -> torch.Tensor:
    """The M-power spectrum averaged over ``avg`` consecutive nfft blocks
    of ``x`` (..., n >= avg*nfft): (..., nfft)."""
    seg = CF32(*(p[..., :avg * nfft].reshape(p.shape[:-1] + (avg, nfft))
                 for p in x))
    spec = fft_ops.fft(_mpower(seg, power))
    return torch.mean(spec.re * spec.re + spec.im * spec.im, dim=-2)


def _bin_to_hz(kf: torch.Tensor, nfft: int, fs: float,
               power: int) -> torch.Tensor:
    kf = torch.where(kf > nfft / 2, kf - nfft, kf)
    return kf * float(np.float32(fs / nfft)) / float(np.float32(power))


def _interp(psd: torch.Tensor, k: torch.Tensor, nfft: int) -> torch.Tensor:
    """The parabolic offset of peak bin ``k`` from its cyclic neighbours."""
    def at(i):
        return torch.gather(psd, -1, torch.remainder(i, nfft)[..., None])[..., 0]
    pm, p0, pp = at(k - 1), at(k), at(k + 1)
    denom = pm - 2.0 * p0 + pp
    return torch.where(torch.abs(denom) > 1e-20, 0.5 * (pm - pp) / denom,
                       torch.zeros_like(denom))


def acquire_freq_hz(x: CF32, fs: float, nfft: int = 512, power: int = 4,
                    avg: int = 1) -> torch.Tensor:
    """The carrier offset (Hz) of baseband samples ``x`` (..., n >=
    avg*nfft), from the argmax of the M-power spectrum averaged over
    ``avg`` blocks.  Returns (...,) float32."""
    psd = _psd(x, nfft, power, avg)
    k = torch.argmax(psd, dim=-1)
    kf = k.to(torch.float32) + _interp(psd, k, nfft)
    return _bin_to_hz(kf, nfft, fs, power)


def _peak_hz(psd: torch.Tensor, nfft: int, fs: float, power: int,
             interp_psd: torch.Tensor | None = None):
    """(offset Hz, peak bin) of the argmax of ``psd``, interpolated on
    ``interp_psd`` (default ``psd``): the candidate search masks earlier
    picks in ``psd`` but fits the parabola on the unmasked spectrum, and
    clamps the fit to the half bin it refines (against the unmasked
    spectrum a runner-up beside a stronger line's skirt can flip the
    parabola)."""
    if interp_psd is None:
        interp_psd = psd
    k = torch.argmax(psd, dim=-1)
    delta = torch.clamp(_interp(interp_psd, k, nfft), -0.5, 0.5)
    return _bin_to_hz(k.to(torch.float32) + delta, nfft, fs, power), k


def acquire_freq_candidates(x: CF32, fs: float, nfft: int = 512,
                            power: int = 4, avg: int = 1, ncand: int = 2,
                            guard_bins: int = 16) -> torch.Tensor:
    """The ``ncand`` strongest offset candidates (..., ncand) in Hz,
    strongest first, each a distinct line: a cyclic window of
    ``guard_bins`` around every pick is masked before the next.  The
    M-power spectrum has deterministic spurs at ``M*offset +- k*rs`` that
    can out-peak the carrier line; the CRC-scored sync hunt tells them
    apart."""
    psd = _psd(x, nfft, power, avg)
    bins = torch.arange(nfft, device=psd.device)
    cands, masked = [], psd
    for _ in range(ncand):
        f_hz, k = _peak_hz(masked, nfft, fs, power, interp_psd=psd)
        cands.append(f_hz)
        d = torch.abs(torch.remainder(bins - k[..., None] + nfft // 2, nfft)
                      - nfft // 2)
        masked = torch.where(d <= guard_bins, torch.zeros_like(masked), masked)
    return torch.stack(cands, dim=-1)


def sweep_candidates_hz(max_hz: float = 375.0,
                        step_hz: float = 75.0) -> np.ndarray:
    """The seed sweep ``[0, +s, -s, +2s, -2s, ...]`` up to ``max_hz``:
    the fallback when no spectral line points at the carrier.  The step
    of 75 Hz keeps every offset within the family's ~+-50 Hz pull-in of
    a seed; beyond 375 Hz the matched filter's skirt stops decoding."""
    ks = int(max_hz / step_hz)
    grid = [0.0]
    for k in range(1, ks + 1):
        grid += [k * step_hz, -k * step_hz]
    return np.asarray(grid, np.float32)


def hz_to_costas_freq(f_hz: torch.Tensor, rs: float) -> torch.Tensor:
    """Hz -> the Costas loop's rad/symbol (the inverse of ``freq_to_hz``)."""
    return f_hz * float(np.float32(2.0 * math.pi / rs))
