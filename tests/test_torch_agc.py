"""The torch port's frame-rate AGC (``ops/agc.py``) and the tm front-end's
power output (``ops/cuda/frontend_kernel.rx_frontend_tm``, its plain
version on CPU) against the JAX package.

Across frameworks the values are held to rtol 1e-5, as the JAX package
holds its own two lowerings (tests/test_round4_fixes.py): XLA:CPU
FMA-contracts the squares differently per compilation context, so the
powers are close, not equal.  Inside the port the time-major and
channel-major reductions must agree bit for bit: the kernel path and the
composed path feed the Costas loop the same gains only then."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg
from qpsk_tpu.ops import agc as jagc
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu.ops.pallas.frontend_kernel import rx_frontend_fused_tm
from qpsk_tpu_torch import ModemConfig, rx_init
from qpsk_tpu_torch.ops import agc
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.cuda.frontend_kernel import rx_frontend_tm

torch.set_num_threads(2)

C, NF, NSYM = 16, 8, 128
TARGET, MU = 1.45, 0.5


def _frames(seed, scale=0.05):
    """(C, F, nsym) symbols at an unknown level: a per-channel scale
    spanning 40 dB, with a level step halfway through the frames."""
    rng = np.random.default_rng(seed)
    level = scale * 10.0 ** rng.uniform(-1, 1, (C, 1, 1))
    step = np.where(np.arange(NF)[None, :, None] < NF // 2, 1.0, 3.0)
    re = (rng.normal(size=(C, NF, NSYM)) * level * step).astype(np.float32)
    im = (rng.normal(size=(C, NF, NSYM)) * level * step).astype(np.float32)
    return re, im


def _warm_est(seed):
    est = np.random.default_rng(seed).uniform(0.01, 0.5, C).astype(np.float32)
    est[:3] = 0.0                     # unset: seeded by the first frame
    return est


@pytest.mark.parametrize("layout", ["channel-major", "time-major"])
def test_frame_power_matches_jax(layout):
    re, im = _frames(1)
    if layout == "time-major":          # (F, nsym, C), reduced over dim 1
        re, im = re.transpose(1, 2, 0).copy(), im.transpose(1, 2, 0).copy()
    dim = 1 if layout == "time-major" else -1
    got = agc._frame_power(torch.from_numpy(re), torch.from_numpy(im), dim)
    want = np.asarray(jagc._frame_power(jnp.asarray(re), jnp.asarray(im),
                                        axis=dim))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # the halves-pairing tree itself, written out in numpy float32
    p = (re * re + im * im).astype(np.float32)
    p = np.moveaxis(p, dim, -1)
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    np.testing.assert_array_equal(got.numpy(), p[..., 0] * np.float32(1 / NSYM))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_agc_gains_and_stream_match_jax(warm):
    re, im = _frames(2)
    est0 = _warm_est(3) if warm else np.zeros(C, np.float32)
    p = agc._frame_power(torch.from_numpy(re), torch.from_numpy(im))
    est, g = agc.agc_gains(torch.from_numpy(est0), p, TARGET, MU)
    jest, jg = jagc.agc_gains(jnp.asarray(est0), jnp.asarray(p.numpy()),
                              TARGET, MU)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5)
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), rtol=1e-5)

    sest, scaled = agc.agc_stream(torch.from_numpy(est0),
                                  CF32(torch.from_numpy(re),
                                       torch.from_numpy(im)), TARGET, MU)
    jsest, jscaled = jagc.agc_stream(jnp.asarray(est0),
                                     JCF32(jnp.asarray(re), jnp.asarray(im)),
                                     TARGET, MU)
    np.testing.assert_allclose(sest.numpy(), np.asarray(jsest), rtol=1e-5)
    np.testing.assert_allclose(scaled.re.numpy(), np.asarray(jscaled.re),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scaled.im.numpy(), np.asarray(jscaled.im),
                               rtol=1e-5, atol=1e-6)
    # four frames after a 3x level step the normalized frames are back
    # near the target RMS (the one-pole estimate halves its error a frame)
    rms = np.sqrt((scaled.re.numpy() ** 2 + scaled.im.numpy() ** 2).mean(-1))
    np.testing.assert_allclose(rms[:, NF - 1], TARGET, rtol=0.1)


def test_agc_gains_tm_equals_agc_stream():
    """In the port, the time-major gains are bit-identical to the gains
    ``agc_stream`` applies to the same symbols in channel-major layout; and
    they match JAX's ``agc_gains_tm`` to rtol 1e-5."""
    re, im = _frames(4)
    est0 = _warm_est(5)
    zr = torch.from_numpy(re.transpose(1, 2, 0).reshape(NF * NSYM, C).copy())
    zi = torch.from_numpy(im.transpose(1, 2, 0).reshape(NF * NSYM, C).copy())
    est_tm, g_tm = agc.agc_gains_tm(torch.from_numpy(est0), zr, zi, NF,
                                    TARGET, MU)
    assert g_tm.shape == (NF, C)
    frames = CF32(torch.from_numpy(re), torch.from_numpy(im))
    est_cm, scaled = agc.agc_stream(torch.from_numpy(est0), frames, TARGET, MU)
    assert torch.equal(est_tm, est_cm)
    gx = g_tm.T[..., None]
    assert torch.equal(scaled.re, frames.re * gx)
    assert torch.equal(scaled.im, frames.im * gx)
    jest, jg = jagc.agc_gains_tm(jnp.asarray(est0), jnp.asarray(zr.numpy()),
                                 jnp.asarray(zi.numpy()), NF, TARGET, MU)
    np.testing.assert_allclose(g_tm.numpy(), np.asarray(jg), rtol=1e-5)
    np.testing.assert_allclose(est_tm.numpy(), np.asarray(jest), rtol=1e-5)


@pytest.mark.parametrize("nframes", [1, 4])
def test_tm_frontend_power_output_matches_jax(nframes):
    """The tm front-end's (C, F) powers of its emitted (delayed) picks,
    against ``rx_frontend_fused_tm(..., want_power=True)`` in interpret
    mode: rtol 1e-4, the picks' 3e-4 bound carried through |z|^2 at a
    symbol magnitude near 1.45 and averaged over the frame.  In the port
    they equal ``_frame_power`` of the emitted planes bit for bit."""
    cfg, jc = ModemConfig(agc=True), JCfg(agc=True)
    c = 128
    rng = np.random.default_rng(6)
    pcm = rng.integers(-12000, 12000, (c, nframes + 1, 512), dtype=np.int16)
    # the carried state after one frame, from the port's plain front-end
    st = rx_init(cfg, (c,), device="cpu")
    _, _, _, phase, tail, delay, _ = rx_frontend_tm(
        cfg, torch.from_numpy(pcm[:, :1]), st.nco_phase, st.fir_tail,
        st.decim_delay)
    body = np.ascontiguousarray(pcm[:, 1:])
    zr, zi, idx, _, _, _, powers = rx_frontend_tm(
        cfg, torch.from_numpy(body), phase, tail, delay)
    assert powers.shape == (c, nframes) and powers.is_contiguous()
    assert torch.equal(powers, agc.frame_powers_tm(zr, zi, nframes))
    assert torch.equal(powers[:, 0], agc._frame_power(delay.re, delay.im))
    jphase, jtail, jdelay = (
        JCF32(jnp.asarray(t.re.numpy()), jnp.asarray(t.im.numpy()))
        for t in (phase, tail, delay))
    out = rx_frontend_fused_tm(jc, body, jphase, jtail, jdelay,
                               want_power=True, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(out[2]))
    np.testing.assert_allclose(powers.numpy(), np.asarray(out[6]).T, rtol=1e-4)
    # without cfg.agc the front-end emits no powers
    assert rx_frontend_tm(ModemConfig(), torch.from_numpy(body), phase, tail,
                          delay)[6] is None


@pytest.mark.parametrize("nsym", [384, 96, 3])
def test_frame_power_odd_residue_matches_jax(nsym):
    """A frame of symbols that is not a power of two (384 at a 1536-sample
    frame): halves pairing while the count is even, then the odd residue
    summed in order, times float32(1/nsym); within float32 rounding of
    the JAX tree (whose residue is a ``jnp.sum``), and the numpy twin of
    that order bit for bit (the front-end kernel's tree)."""
    rng = np.random.default_rng(nsym)
    re = rng.normal(size=(5, 3, nsym)).astype(np.float32)
    im = rng.normal(size=(5, 3, nsym)).astype(np.float32)
    got = agc._frame_power(torch.from_numpy(re), torch.from_numpy(im))
    want = np.asarray(jagc._frame_power(jnp.asarray(re), jnp.asarray(im)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    p = (re * re + im * im).astype(np.float32)
    n = nsym
    while n > 1 and n % 2 == 0:
        p = p[..., :n // 2] + p[..., n // 2:n]
        n //= 2
    s = p[..., 0]
    for k in range(1, n):
        s = s + p[..., k]
    np.testing.assert_array_equal(got.numpy(), s * np.float32(1.0 / nsym))
