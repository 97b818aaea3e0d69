"""FFT carrier acquisition in the torch port (``ops/fft.py``,
``ops/acquire.py``, ``modem.rx_acquire_hz``) against the JAX package on
the same inputs.

The JAX package's DFT is a float32 matmul at HIGHEST precision, the port's
``torch.fft``: transforms agree within 1e-5 relative to the spectrum's
peak, and estimates in Hz within 0.05 Hz (a small fraction of a bin, so
the same peak bin) on the same samples or PCM.  The M-power spectrum has
deterministic spurs, so the estimate is held against JAX's on the same
PCM, not against the offset sent."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg, tx_init as j_tx_init
from qpsk_tpu.modem import rx_acquire_hz as j_rx_acquire_hz
from qpsk_tpu.modem import tx_stream as j_tx_stream
from qpsk_tpu.ops import acquire as jacq
from qpsk_tpu.ops import fft as jfft
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu_torch.config import from_dict
from qpsk_tpu_torch.modem import rx_acquire_hz
from qpsk_tpu_torch.ops import acquire as tacq
from qpsk_tpu_torch.ops import fft as tfft
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.modfam import ACQUIRE_POWER

torch.set_num_threads(2)

HZ = 0.05


def _cfgs(name):
    jc = JCfg(modulation=name, agc=name == "16qam")
    return from_dict(dataclasses.asdict(jc)), jc


def _pcm(name, c, nframes, offset_hz, seed, snr_db=12.0):
    """JAX TX of random bits at ``offset_hz``, numpy AWGN at ``snr_db``."""
    _, jc = _cfgs(name)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (c, nframes, jc.bits_per_frame), dtype=np.int32)
    _, pcm = j_tx_stream(jc, j_tx_init(jc, batch_shape=(c,)), bits,
                         tx_offset_hz=offset_hz)
    x = np.asarray(pcm).astype(np.float64)
    sigma = np.sqrt((x ** 2).mean() / 10.0 ** (snr_db / 10.0))
    return np.clip(np.round(x + rng.normal(size=x.shape) * sigma), -32768,
                   32767).astype(np.int16)


def test_fft_matches_jax():
    rng = np.random.default_rng(1)
    re, im = (rng.normal(size=(3, 2, 512)).astype(np.float32) for _ in range(2))
    for fn, jfn in ((tfft.fft, jfft.fft), (tfft.ifft, jfft.ifft)):
        got = fn(CF32(torch.from_numpy(re), torch.from_numpy(im)))
        want = jfn(JCF32(jnp.asarray(re), jnp.asarray(im)))
        scale = float(np.abs(np.asarray(want.re)).max())
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and a.shape == (3, 2, 512)
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=1e-5 * scale, rtol=0)
    back = tfft.ifft(tfft.fft(CF32(torch.from_numpy(re), torch.from_numpy(im))))
    np.testing.assert_allclose(back.re.numpy(), re, atol=1e-5)
    z = re + 1j * im
    np.testing.assert_allclose(tfft.fft_np(z), jfft.fft_np(z))
    np.testing.assert_allclose(tfft.ifft_np(z), jfft.ifft_np(z))


def _baseband(power, seed):
    """Samples (C, n) of random unit symbols of the strip order's
    constellation at 4 samples per symbol, turned by a 37 Hz offset."""
    rng = np.random.default_rng(seed)
    c, nsym = 4, 1024
    m = {2: 2, 4: 4, 8: 8}[power]
    ph = 2 * np.pi * rng.integers(0, m, (c, nsym)) / m
    z = np.repeat(np.exp(1j * ph), 4, axis=1)
    z = z * np.exp(2j * np.pi * 37.0 * np.arange(z.shape[1]) / 9600.0)
    z = z + 0.1 * (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape))
    return z.real.astype(np.float32), z.imag.astype(np.float32)


@pytest.mark.parametrize("power", [2, 4, 8])
def test_estimators_match_jax(power):
    re, im = _baseband(power, power)
    x, jx = CF32(torch.from_numpy(re), torch.from_numpy(im)), JCF32(re, im)
    for nfft, avg in ((512, 1), (1024, 4)):
        got = tacq.acquire_freq_hz(x, 9600.0, nfft=nfft, power=power, avg=avg)
        want = jacq.acquire_freq_hz(jx, 9600.0, nfft=nfft, power=power, avg=avg)
        assert got.shape == (4,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=HZ)
        np.testing.assert_allclose(got.numpy(), 37.0, atol=9600 / nfft / power)
        cand = tacq.acquire_freq_candidates(x, 9600.0, nfft=nfft, power=power,
                                            avg=avg, ncand=3)
        jcand = jacq.acquire_freq_candidates(jx, 9600.0, nfft=nfft,
                                             power=power, avg=avg, ncand=3)
        assert cand.shape == (4, 3)
        np.testing.assert_allclose(cand.numpy(), np.asarray(jcand), atol=HZ)
    assert tacq.quadruple(x).re.shape == x.re.shape
    q, jq = tacq.quadruple(x), jacq.quadruple(jx)
    np.testing.assert_allclose(q.re.numpy(), np.asarray(jq.re), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        tacq.hz_to_costas_freq(torch.tensor([50.0, -12.5]), 2400.0).numpy(),
        np.asarray(jacq.hz_to_costas_freq(jnp.asarray([50.0, -12.5]), 2400.0)),
        rtol=0, atol=0)


@pytest.mark.parametrize("name", ["qpsk", "bpsk", "8psk", "16qam"])
def test_rx_acquire_matches_jax(name):
    cfg, jc = _cfgs(name)
    pcm = _pcm(name, 2, 24, 50.0, seed=len(name))
    got = rx_acquire_hz(cfg, torch.from_numpy(pcm))
    want = np.asarray(j_rx_acquire_hz(jc, pcm))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, atol=HZ)
    # within one bin of the offset sent
    nfft = cfg.nfft * (4 if name in ("8psk", "16qam") else 1)
    np.testing.assert_allclose(got.numpy(), 50.0,
                               atol=cfg.fs / nfft / ACQUIRE_POWER[name])
    # a single stream, flattened
    one = rx_acquire_hz(cfg, torch.from_numpy(pcm[0].reshape(-1)))
    np.testing.assert_allclose(float(one), want[0], atol=HZ)


def test_rx_acquire_candidates_match_jax():
    cfg, jc = _cfgs("8psk")
    pcm = _pcm("8psk", 2, 24, 50.0, seed=9)
    got = rx_acquire_hz(cfg, torch.from_numpy(pcm), candidates=2)
    want = np.asarray(j_rx_acquire_hz(jc, pcm, candidates=2))
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=HZ)
    with pytest.raises(ValueError):
        rx_acquire_hz(cfg, torch.zeros(100, dtype=torch.int16))


def test_sweep_grid_equal():
    for kw in ({}, dict(max_hz=300.0, step_hz=50.0)):
        got, want = tacq.sweep_candidates_hz(**kw), jacq.sweep_candidates_hz(**kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
