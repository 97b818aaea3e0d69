"""The torch port's channel models (``qpsk_tpu_torch.channel``) against the
JAX package's (``qpsk_tpu.channel``) on CPU: the deterministic ones on the
same inputs (a CW tone, the sample-clock offset, the Doppler ramp and its
rotation), the random ones, keyed by a ``torch.Generator``, by their
statistics, each an identity at level 0, and reproducible from the seed.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu import channel as jch
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu_torch import channel as tch
from qpsk_tpu_torch.ops.cplx import CF32

torch.set_num_threads(2)


def _pcm(seed, shape=(2, 4096)):
    return np.random.default_rng(seed).integers(-12000, 12000, shape,
                                                dtype=np.int16)


# --- deterministic models against JAX ---------------------------------------

def test_tone_pcm_matches_jax():
    x = _pcm(0)
    want = np.asarray(jch.tone_pcm(jnp.asarray(x), 1234.5, -3.0, 0.4,
                                   phase=0.3)).astype(np.int32)
    got = tch.tone_pcm(torch.from_numpy(x), 1234.5, -3.0, 0.4, phase=0.3)
    assert got.dtype == torch.int16
    assert np.abs(got.numpy().astype(np.int32) - want).max() <= 1


@pytest.mark.parametrize("ppm,frac", [(60e-6, -0.5), (-250e-6, 0.25),
                                      (1000e-6, 0.0)])
def test_clock_offset_matches_jax(ppm, frac):
    """The same output length and samples within 1 LSB (the read position
    is float32 in both)."""
    x = _pcm(1, (2, 20000))
    want = np.asarray(jch.clock_offset_pcm(jnp.asarray(x), ppm,
                                           frac_offset=frac)).astype(np.int32)
    got = tch.clock_offset_pcm(torch.from_numpy(x), ppm, frac_offset=frac)
    assert got.shape == want.shape
    assert np.abs(got.numpy().astype(np.int32) - want).max() <= 1


def test_clock_offset_identity_and_tone():
    """At 0 ppm the positions land on samples 1..n-9; a tone through +1000
    ppm comes back at f*(1+ppm) with a cubic interpolation's residual."""
    x = _pcm(2, (4096,))
    y = tch.clock_offset_pcm(torch.from_numpy(x), 0.0)
    np.testing.assert_array_equal(y.numpy(), x[1:1 + y.numel()])
    fs, f, n, ppm = 9600.0, 1000.0, 9600, 1000e-6
    tone = (10000.0 * np.sin(2 * np.pi * f * np.arange(n) / fs)).astype(np.int16)
    y = tch.clock_offset_pcm(torch.from_numpy(tone), ppm).numpy().astype(np.float64)
    t = np.arange(y.size) / fs
    b = np.stack([np.sin(2 * np.pi * f * (1 + ppm) * t),
                  np.cos(2 * np.pi * f * (1 + ppm) * t)], 1)
    c, *_ = np.linalg.lstsq(b, y, rcond=None)
    assert abs(np.hypot(*c) - 10000.0) < 100.0
    assert np.sqrt(np.mean((y - b @ c) ** 2)) < 60.0


def test_doppler_ramp_matches_jax():
    want = np.asarray(jch.doppler_ramp_offset(5000, 40.0, -12.5, 2400.0))
    got = tch.doppler_ramp_offset(5000, 40.0, -12.5, 2400.0, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    rng = np.random.default_rng(3)
    re, im = (rng.normal(size=(2, 5000)).astype(np.float32) for _ in range(2))
    jy = jch.apply_doppler_baseband(JCF32(jnp.asarray(re), jnp.asarray(im)),
                                    jnp.asarray(want), 2400.0)
    ty = tch.apply_doppler_baseband(CF32(torch.from_numpy(re),
                                         torch.from_numpy(im)), got, 2400.0)
    # the phase integrates 5000 float32 offsets: summation order apart,
    # the rotation agrees to about 1e-3 rad at the end
    np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), atol=5e-3)
    np.testing.assert_allclose(ty.im.numpy(), np.asarray(jy.im), atol=5e-3)
    np.testing.assert_allclose(np.hypot(ty.re.numpy(), ty.im.numpy()),
                               np.hypot(re, im), rtol=1e-5)


# --- random models by their statistics --------------------------------------

def test_awgn_baseband_statistics():
    gen = torch.Generator().manual_seed(4)
    z = CF32(torch.zeros(4, 50000), torch.zeros(4, 50000))
    y = tch.awgn_baseband(gen, z, torch.tensor([0.0, 10.0, 20.0, 3.0]), 2.0)
    var = (y.re ** 2 + y.im ** 2).mean(-1).numpy()
    want = 2.0 / 10 ** (np.array([0.0, 10.0, 20.0, 3.0]) / 10)
    np.testing.assert_allclose(var, want, rtol=0.03)
    np.testing.assert_allclose(y.re.var(-1).numpy(), want / 2, rtol=0.04)
    again = tch.awgn_baseband(torch.Generator().manual_seed(4), z,
                              torch.tensor([0.0, 10.0, 20.0, 3.0]), 2.0)
    assert torch.equal(again.re, y.re)


def test_awgn_pcm_statistics():
    gen = torch.Generator().manual_seed(5)
    y = tch.awgn_pcm(gen, torch.zeros((2, 60000), dtype=torch.int16),
                     [10.0, 20.0], 0.5)
    var = y.to(torch.float64).var(-1).numpy() / 16384.0 ** 2
    np.testing.assert_allclose(var, 0.5 / 10 ** np.array([1.0, 2.0]), rtol=0.03)


def test_phase_noise_statistics():
    """A tone's phase after the model walks with increments of variance
    2*pi*linewidth/fs; linewidth 0 returns the input itself."""
    fs, lw, n = 9600.0, 5.0, 65536
    tone = (8000.0 * np.cos(2 * np.pi * 1500.0 * np.arange(n) / fs)).astype(np.int16)
    x = torch.from_numpy(tone)
    assert tch.phase_noise_pcm(torch.Generator(), x, 0.0, fs) is x
    y = tch.phase_noise_pcm(torch.Generator().manual_seed(6), x, lw, fs)
    ya = np.fft.ifft(np.fft.fft(y.numpy().astype(np.float64))
                     * np.where(np.arange(n) < n // 2, 2.0, 0.0))
    xa = np.fft.ifft(np.fft.fft(tone.astype(np.float64))
                     * np.where(np.arange(n) < n // 2, 2.0, 0.0))
    # the walk's increments over 16 samples (the FFT edges cut away), whose
    # variance is 16 times the per-sample one
    phi = np.unwrap(np.angle(ya[1000:-1000] * np.conj(xa[1000:-1000])))
    steps = phi[::16][1:] - phi[::16][:-1]
    assert np.var(steps) / 16 == pytest.approx(2 * math.pi * lw / fs, rel=0.15)


def test_impulse_noise_statistics():
    """Bursts of 8 samples at 20 events/s replace about 20/fs*8 of the
    samples with full-scale noise; rate 0 leaves the PCM untouched."""
    fs = 9600.0
    x = torch.from_numpy(_pcm(7, (4, 96000)) // 8)
    assert torch.equal(tch.impulse_noise_pcm(torch.Generator(), x, 0.0, fs), x)
    y = tch.impulse_noise_pcm(torch.Generator().manual_seed(8), x, 20.0, fs)
    hit = (y != x).to(torch.float64).mean().item()
    assert hit == pytest.approx(1 - (1 - 20.0 / fs) ** 8, rel=0.1)
    loud = y[y != x].to(torch.float32).abs()
    assert float(loud.max()) == 32767.0 or float(loud.max()) == 32768.0
