"""Parity mode of the torch port (``config_parity()``): the six
golden-vector checks of ``tests/test_golden_parity.py`` through the port,
at that file's tolerances, against ``tests/golden/reference_vectors.npz``
(stage dumps of the compiled C reference), and the parity pieces against
the JAX package on the same inputs: the exact NCO recursion,
``fir_reference_order``, ``demod_bits_reference``, the exact FIR.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu.ops import modmap as jmodmap, nco as jnco, rrc as jrrc
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu_torch import config_parity, rx_init, rx_stream, tx_bits_frame, tx_init
from qpsk_tpu_torch.ops import costas as costas_ops
from qpsk_tpu_torch.ops import modmap, nco
from qpsk_tpu_torch.ops import rrc as rrc_ops
from qpsk_tpu_torch.ops.cplx import CF32

torch.set_num_threads(2)

GOLDEN = np.load("tests/golden/reference_vectors.npz")
CFG = config_parity()


def _tmat(block):
    return torch.from_numpy(rrc_ops.toeplitz_taps(rrc_ops.taps_for(CFG), block))


@pytest.fixture(scope="module")
def rx_parity():
    """The golden PCM through the port's ``rx_stream`` in parity mode (the
    frame scan over ``rx_frame``)."""
    pcm = torch.from_numpy(GOLDEN["pcm"].reshape(40, 512))
    return rx_stream(CFG, rx_init(CFG, device="cpu"), pcm)[1]


def _rx_frontend():
    """Frame-by-frame exact mix-down + matched filter."""
    pcm = torch.from_numpy(GOLDEN["pcm"].reshape(-1).astype(np.float32) / 16384.0)
    ph = nco.nco_init(device="cpu")
    tail = rrc_ops.fir_init_tail(CFG.ntaps, device="cpu")
    out = []
    for k in range(40):
        seg = CF32(pcm[k * 512:(k + 1) * 512], torch.zeros(512))
        seg, ph = nco.mix(seg, ph, -CFG.omega_center, "exact")
        seg, tail = rrc_ops.fir_block(seg, tail, _tmat(512), CFG.gain, 512,
                                      exact=True)
        out.append(np.stack([seg.re.numpy(), seg.im.numpy()], -1))
    return np.stack(out)


# --- the six golden-vector checks --------------------------------------------

def test_rrc_impulse_response():
    imp = torch.zeros(2 * CFG.ntaps)
    imp[0] = 1.0
    y, _ = rrc_ops.fir_block(CF32(imp, torch.zeros_like(imp)),
                             rrc_ops.fir_init_tail(CFG.ntaps, device="cpu"),
                             _tmat(2 * CFG.ntaps), CFG.gain, 2 * CFG.ntaps,
                             exact=True)
    np.testing.assert_allclose(y.re.numpy(), GOLDEN["impulse"][:, 0], atol=1e-6)
    np.testing.assert_allclose(y.im.numpy(), GOLDEN["impulse"][:, 1], atol=1e-6)


def test_tx_pcm_parity():
    bits = torch.from_numpy(GOLDEN["bits"].astype(np.int32))
    st, pcms = tx_init(CFG, device="cpu"), []
    for k in range(bits.shape[0]):
        st, p = tx_bits_frame(CFG, st, bits[k], tx_offset_hz=50.0)
        pcms.append(p.numpy())
    d = np.abs(np.stack(pcms).astype(np.int32) - GOLDEN["pcm"].astype(np.int32))
    assert d[0].max() <= 2, d[0].max()
    assert d.max() <= 32, d.max()


def test_rx_frontend_parity():
    np.testing.assert_allclose(_rx_frontend(), GOLDEN["filt"], atol=1e-3)


def test_rx_decimation_parity(rx_parity):
    filt = _rx_frontend()
    ti = rx_parity.timing_index.numpy()
    prev, mine = np.zeros((128, 2), np.float32), []
    for k in range(40):
        mine.append(prev)
        prev = filt[k][np.clip(np.arange(128) * 4 + int(ti[k]), 0, 511)]
    np.testing.assert_allclose(np.stack(mine)[:, :126], GOLDEN["decim"][:, :126],
                               atol=1e-3)


def test_costas_parity_isolated():
    params = costas_ops.costas_params(CFG.loop_bw, CFG.damping, CFG.min_freq,
                                      CFG.max_freq)
    st, mine = costas_ops.costas_init((), device="cpu"), []
    dec = GOLDEN["decim"]
    for k in range(dec.shape[0]):
        st, sym = costas_ops.costas_run(
            st, CF32(torch.from_numpy(dec[k, :, 0]), torch.from_numpy(dec[k, :, 1])),
            params)
        mine.append(np.stack([sym.re.numpy(), sym.im.numpy()], -1))
    np.testing.assert_allclose(np.stack(mine), GOLDEN["costas"], atol=1e-5)


def test_freq_lock_parity(rx_parity):
    mine = float(rx_parity.freq_hz[-10:].mean())
    ref = float(GOLDEN["freq"][-10:, 0].mean())
    assert abs(mine - ref) < 5.0, (mine, ref)
    assert abs(mine - 50.0) < 3.0, mine


# --- the parity pieces against JAX --------------------------------------------

def test_exact_nco_matches_jax():
    """The per-sample recursion from a non-unit carry over a frame of (2,
    512) samples in [-1, 1], TX and RX directions: within 2e-5 of JAX's
    ``lax.scan``, the renormalized carry too.  The two float32 recursions
    round apart (XLA contracts the complex products into FMAs): the JAX
    phasor's magnitude drifts by about 1e-8 a sample, the port's less, so
    the bound is per frame, the span ``rx_frame`` renormalizes.  The chirp
    mixer (a closed form) within 1e-5."""
    rng = np.random.default_rng(0)
    re, im = (rng.uniform(-1, 1, size=(2, 512)).astype(np.float32)
              for _ in range(2))
    ph = (np.array([0.6, -0.8], np.float32), np.array([0.8, 0.6], np.float32))
    for omega in (-CFG.omega_center, 2 * np.pi * 1550.0 / 9600.0):
        jy, jp = jnco.mix(JCF32(jnp.asarray(re), jnp.asarray(im)),
                          JCF32(*map(jnp.asarray, ph)), omega, "exact")
        ty, tp = nco.mix(CF32(torch.from_numpy(re), torch.from_numpy(im)),
                         CF32(*map(torch.from_numpy, ph)), omega, "exact")
        np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), atol=2e-5)
        np.testing.assert_allclose(ty.im.numpy(), np.asarray(jy.im), atol=2e-5)
        np.testing.assert_allclose(tp.re.numpy(), np.asarray(jp.re), atol=2e-5)
    jy, jp = jnco.mix_chirp(JCF32(jnp.asarray(re), jnp.asarray(im)),
                            JCF32(*map(jnp.asarray, ph)), 0.9, 1e-5)
    ty, tp = nco.mix_chirp(CF32(torch.from_numpy(re), torch.from_numpy(im)),
                           CF32(*map(torch.from_numpy, ph)), 0.9, 1e-5)
    np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), atol=1e-5)
    np.testing.assert_allclose(tp.im.numpy(), np.asarray(jp.im), atol=1e-6)
    with pytest.raises(ValueError):
        nco.mix(CF32(torch.zeros(4), torch.zeros(4)),
                nco.nco_init(device="cpu"), 0.1, "cordic")


def test_fir_reference_order_matches_jax_and_fir_block():
    """The C-order FIR, a sample at a time, equals JAX's within 1e-6 and
    the exact and fast block FIRs within 1e-5 from the same tail."""
    rng = np.random.default_rng(1)
    taps = rrc_ops.taps_for(CFG)
    x = [rng.normal(size=256).astype(np.float32) for _ in range(2)]
    tail = [rng.normal(size=CFG.ntaps - 1).astype(np.float32) for _ in range(2)]
    jy = jrrc.fir_reference_order(JCF32(*map(jnp.asarray, x)),
                                  JCF32(*map(jnp.asarray, tail)),
                                  jnp.asarray(taps), CFG.gain)
    ty = rrc_ops.fir_reference_order(CF32(*map(torch.from_numpy, x)),
                                     CF32(*map(torch.from_numpy, tail)),
                                     taps, CFG.gain)
    np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), atol=1e-6)
    np.testing.assert_allclose(ty.im.numpy(), np.asarray(jy.im), atol=1e-6)
    for exact in (True, False):
        yb, new_tail = rrc_ops.fir_block(CF32(*map(torch.from_numpy, x)),
                                         CF32(*map(torch.from_numpy, tail)),
                                         _tmat(128), CFG.gain, 128, exact=exact)
        np.testing.assert_allclose(yb.re.numpy(), ty.re.numpy(), atol=1e-5)
        np.testing.assert_array_equal(new_tail.im.numpy(),
                                      x[1][256 - (CFG.ntaps - 1):])


def test_demod_bits_reference_matches_jax():
    rng = np.random.default_rng(2)
    re, im = (rng.normal(size=(3, 200)).astype(np.float32) for _ in range(2))
    want = jmodmap.demod_bits_reference(JCF32(jnp.asarray(re), jnp.asarray(im)))
    got = modmap.demod_bits_reference(CF32(torch.from_numpy(re),
                                           torch.from_numpy(im)))
    assert got.dtype == torch.int32 and got.shape == (3, 400)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
