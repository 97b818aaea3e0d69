"""Channel models (port of ``qpsk_tpu.channel``): AWGN on PCM and on
baseband, a CW tone, static multipath, a sample-clock offset, oscillator
phase noise, impulse noise and the Doppler ramp.

Noise comes from an explicit ``torch.Generator`` on the signal's device,
so a run is reproducible from its seed.  The JAX package's PRNG keys give
other numbers: tests that compare the two packages make their noise with
numpy, or hold the random models to their statistics.  The deterministic
models compute in float32 where the JAX package does (the read position
of ``clock_offset_pcm`` included).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qpsk_tpu_torch.ops.cplx import CF32

TAU = 2.0 * math.pi


def _to_pcm(y: torch.Tensor) -> torch.Tensor:
    """Round and saturate float samples to int16."""
    return torch.clamp(torch.round(y), -32768, 32767).to(torch.int16)


def _sigma(snr_db, signal_power: float, ndim: int, device,
           split: float = 1.0) -> torch.Tensor:
    """The noise's standard deviation at ``snr_db``, its power divided by
    ``split``, broadcast to ``ndim`` axes."""
    snr_db = torch.as_tensor(snr_db, dtype=torch.float32, device=device)
    sigma = torch.sqrt(signal_power / (10.0 ** (snr_db / 10.0)) / split)
    while sigma.dim() < ndim:
        sigma = sigma[..., None]
    return sigma


def awgn_pcm(generator: torch.Generator, pcm: torch.Tensor, snr_db,
             signal_power: float, pcm_scale: float = 16384.0) -> torch.Tensor:
    """Add real AWGN to int16 PCM at ``snr_db`` (a scalar, or one value per
    leading channel).  ``signal_power`` is the mean power of the analog
    signal before the ``pcm_scale`` multiply."""
    sigma = _sigma(snr_db, signal_power, pcm.dim(), pcm.device)
    noise = torch.randn(pcm.shape, generator=generator, dtype=torch.float32,
                        device=pcm.device)
    return _to_pcm(pcm.to(torch.float32) + noise * sigma * pcm_scale)


def awgn_baseband(generator: torch.Generator, x: CF32, snr_db,
                  signal_power: float = 1.0) -> CF32:
    """Complex AWGN on CF32 baseband, the noise power split across I/Q."""
    dev = x.re.device
    sigma = _sigma(snr_db, signal_power, x.re.dim(), dev, split=2.0)
    nr = torch.randn(x.re.shape, generator=generator, device=dev)
    ni = torch.randn(x.im.shape, generator=generator, device=dev)
    return CF32(x.re + sigma * nr, x.im + sigma * ni)


def tone_pcm(pcm: torch.Tensor, freq_hz: float, level_db: float,
             signal_power: float, fs: float = 9600.0,
             pcm_scale: float = 16384.0, phase: float = 0.0) -> torch.Tensor:
    """Add a CW interferer at ``freq_hz`` to int16 PCM, ``level_db`` its
    power relative to the signal's analog power ``signal_power``."""
    n = pcm.shape[-1]
    amp = float(np.sqrt(2.0 * signal_power * 10.0 ** (level_db / 10.0)))
    t = torch.arange(n, dtype=torch.float32, device=pcm.device)
    tone = amp * torch.cos(float(np.float32(2.0 * np.pi * freq_hz / fs)) * t
                           + float(np.float32(phase)))
    return _to_pcm(pcm.to(torch.float32) + tone * float(np.float32(pcm_scale)))


def multipath_pcm(pcm: torch.Tensor, paths,
                  pcm_scale: float = 16384.0) -> torch.Tensor:
    """Static multipath on int16 passband PCM along the last axis:
    ``y[n] = sum_d gain_d * x[n - delay_d]`` for ``paths`` of
    (delay_samples >= 0, gain), the echoes silent before sample 0.  The
    symbol-level ISI is what ``ModemConfig(eq_taps=...)`` removes.
    ``pcm_scale`` is accepted as the JAX package's signature has it; the
    sum is linear in the PCM, so no scale enters it."""
    x = pcm.to(torch.float32)
    y = torch.zeros_like(x)
    for delay, gain in paths:
        d = int(delay)
        if d < 0:
            raise ValueError(f"acausal path delay {d}")
        shifted = x if d == 0 else torch.cat(
            [torch.zeros(x.shape[:-1] + (d,), dtype=x.dtype, device=x.device),
             x[..., :-d]], dim=-1)
        y = y + float(gain) * shifted
    return _to_pcm(y)


def clock_offset_pcm(pcm: torch.Tensor, ppm: float,
                     frac_offset: float = 0.0) -> torch.Tensor:
    """Resample int16 PCM at rate (1 + ppm) from a fractional start offset
    by Catmull-Rom interpolation: the sample-clock mismatch of a real
    sound-card link, which ``timing_mode="tracking"`` follows.  The output
    is ``8 + max(0, ceil(n*ppm))`` samples shorter than the input."""
    x = pcm.to(torch.float32)
    n = x.shape[-1]
    out_n = n - 8 - max(0, int(math.ceil(n * ppm)))
    t = (float(np.float32(frac_offset)) + 1.0
         + torch.arange(out_n, dtype=torch.float32, device=x.device)
         * float(np.float32(1.0 + ppm)))
    i = torch.clamp(t.to(torch.int32), 1, n - 3)
    mu = t - i.to(torch.float32)
    il = i.long()
    xm1, x0, x1, x2 = (x[..., il + k] for k in (-1, 0, 1, 2))
    a = 0.5 * (-xm1 + 3.0 * x0 - 3.0 * x1 + x2)
    b = xm1 - 2.5 * x0 + 2.0 * x1 - 0.5 * x2
    c = 0.5 * (x1 - xm1)
    return _to_pcm(((a * mu + b) * mu + c) * mu + x0)


def phase_noise_pcm(generator: torch.Generator, pcm: torch.Tensor,
                    linewidth_hz: float, fs: float) -> torch.Tensor:
    """Oscillator phase noise on passband PCM: the analytic signal (an FFT
    Hilbert transform over the whole stream) rotated by a Wiener phase
    walk of Lorentzian linewidth ``linewidth_hz`` (per-sample increment
    variance 2*pi*linewidth/fs), real part.  Linewidth 0 returns the
    input."""
    if linewidth_hz <= 0.0:
        return pcm
    x = pcm.to(torch.float32)
    n = x.shape[-1]
    h = np.zeros(n, np.float32)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    analytic = torch.fft.ifft(torch.fft.fft(x.to(torch.complex64), dim=-1)
                              * torch.from_numpy(h).to(x.device), dim=-1)
    sigma = math.sqrt(TAU * linewidth_hz / fs)
    phi = torch.cumsum(sigma * torch.randn(x.shape, generator=generator,
                                           device=x.device), dim=-1)
    return _to_pcm(analytic.real * torch.cos(phi)
                   - analytic.imag * torch.sin(phi))


def impulse_noise_pcm(generator: torch.Generator, pcm: torch.Tensor,
                      rate_hz: float, fs: float, amp: float = 1.0,
                      burst_samples: int = 8) -> torch.Tensor:
    """Impulsive interference on passband PCM: Poisson-arriving bursts of
    ``burst_samples`` samples of full-scale-times-``amp`` Gaussian noise at
    ``rate_hz`` events a second, each burst replacing the samples it lands
    on."""
    x = pcm.to(torch.float32)
    n = x.shape[-1]
    hit = torch.rand(x.shape, generator=generator,
                     device=x.device) < float(np.float32(rate_hz / fs))
    mask = hit
    for d in range(1, min(burst_samples, n)):
        mask = mask | torch.cat([torch.zeros(x.shape[:-1] + (d,),
                                             dtype=torch.bool,
                                             device=x.device),
                                 hit[..., :n - d]], dim=-1)
    noise = torch.randn(x.shape, generator=generator,
                        device=x.device) * float(np.float32(32767.0 * amp))
    return _to_pcm(torch.where(mask, noise, x))


def doppler_ramp_offset(n: int, f0_hz: float, rate_hz_per_s: float,
                        fs: float, device="cuda") -> torch.Tensor:
    """The instantaneous offset ``f(t) = f0 + rate*t`` of a Doppler ramp,
    (n,) float32 Hz."""
    t = torch.arange(n, dtype=torch.float32, device=device) / float(
        np.float32(fs))
    return float(np.float32(f0_hz)) + float(np.float32(rate_hz_per_s)) * t


def apply_doppler_baseband(x: CF32, offset_hz: torch.Tensor,
                           fs: float) -> CF32:
    """Rotate CF32 baseband by the integrated phase of a time-varying
    offset (Hz, along the last axis)."""
    phase = torch.cumsum(offset_hz, dim=-1) * float(np.float32(TAU / fs))
    c, s = torch.cos(phase), torch.sin(phase)
    return CF32(x.re * c - x.im * s, x.re * s + x.im * c)
