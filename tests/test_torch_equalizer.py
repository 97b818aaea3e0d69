"""The torch port's blind CMA equalizer (``ops/equalizer.py``) against the
JAX package: ``eq_init``, ``cma_frame`` and ``equalize_stream`` over 8
frames of symbols through a two-ray channel.  Taps and outputs agree to
1e-4 (the frameworks sum the gradient in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu.ops import equalizer as jeq
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu_torch.ops import equalizer as teq
from qpsk_tpu_torch.ops.cplx import CF32

torch.set_num_threads(2)

C, NF, NSYM = 8, 8, 128
MU, MODULUS = 0.2, 2.1


def _isi_frames(seed):
    """(C, F, nsym) QPSK symbols at modulus 1.45 through the symbol-spaced
    two-ray channel 1 + 0.5 z^-1 with a random phase per channel, plus
    noise."""
    rng = np.random.default_rng(seed)
    n = NF * NSYM
    s = 1.45 * np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, (C, n))))
    y = s.copy()
    y[:, 1:] += 0.5 * s[:, :-1]
    y *= np.exp(1j * rng.uniform(0, 2 * np.pi, (C, 1)))
    y += 0.05 * (rng.normal(size=y.shape) + 1j * rng.normal(size=y.shape))
    re = y.real.astype(np.float32).reshape(C, NF, NSYM)
    im = y.imag.astype(np.float32).reshape(C, NF, NSYM)
    return re, im


def _to_np(state):
    (w, hist) = state
    return [np.asarray(a) for a in (w.re, w.im, hist.re, hist.im)]


@pytest.mark.parametrize("taps", [5, 9])
def test_eq_init_matches_jax(taps):
    st = teq.eq_init(taps, (C,), device="cpu")
    for a, b in zip(_to_np(st), _to_np(jeq.eq_init(taps, (C,))), strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        teq.eq_init(0, device="cpu")


@pytest.mark.parametrize("taps", [5, 9])
def test_cma_frame_matches_jax(taps):
    re, im = _isi_frames(1)
    rng = np.random.default_rng(2)
    # a warm state: perturbed taps and a history from the stream
    w0 = teq.eq_init(taps, (C,), device="cpu")[0]
    wr = (w0.re.numpy() + 0.05 * rng.normal(size=(C, taps))).astype(np.float32)
    wi = (0.05 * rng.normal(size=(C, taps))).astype(np.float32)
    hr, hi = re[:, 0, -(taps - 1):].copy(), im[:, 0, -(taps - 1):].copy()
    t_state = (CF32(torch.from_numpy(wr), torch.from_numpy(wi)),
               CF32(torch.from_numpy(hr), torch.from_numpy(hi)))
    j_state = (JCF32(jnp.asarray(wr), jnp.asarray(wi)),
               JCF32(jnp.asarray(hr), jnp.asarray(hi)))
    frame = (re[:, 1], im[:, 1])
    (tw, th), ty = teq.cma_frame(t_state, CF32(*map(torch.from_numpy, frame)),
                                 MU, MODULUS)
    (jw, jh), jy = jeq.cma_frame(j_state, JCF32(*map(jnp.asarray, frame)),
                                 MU, MODULUS)
    for a, b in ((ty, jy), (tw, jw), (th, jh)):
        np.testing.assert_allclose(a.re.numpy(), np.asarray(b.re), atol=1e-4)
        np.testing.assert_allclose(a.im.numpy(), np.asarray(b.im), atol=1e-4)


@pytest.mark.parametrize("taps", [5, 9])
def test_equalize_stream_matches_jax(taps):
    re, im = _isi_frames(3)
    (tw, th), ty = teq.equalize_stream(
        teq.eq_init(taps, (C,), device="cpu"),
        CF32(torch.from_numpy(re), torch.from_numpy(im)), MU, MODULUS)
    (jw, jh), jy = jeq.equalize_stream(
        jeq.eq_init(taps, (C,)), JCF32(jnp.asarray(re), jnp.asarray(im)),
        MU, MODULUS)
    assert ty.re.shape == (C, NF, NSYM)
    for a, b in ((ty, jy), (tw, jw), (th, jh)):
        np.testing.assert_allclose(a.re.numpy(), np.asarray(b.re), atol=1e-4)
        np.testing.assert_allclose(a.im.numpy(), np.asarray(b.im), atol=1e-4)
    # the equalizer opens the eye: the last frame's modulus spread shrinks
    mod_in = np.abs(re[:, -1] + 1j * im[:, -1]) ** 2
    mod_out = ty.re[:, -1].numpy() ** 2 + ty.im[:, -1].numpy() ** 2
    assert np.std(mod_out - MODULUS) < 0.5 * np.std(mod_in - MODULUS)


def test_equalize_stream_chains_across_calls():
    """Two chained calls of 4 frames == one call of 8 (bit for bit: the
    same ops in the same order)."""
    re, im = _isi_frames(4)
    fr = CF32(torch.from_numpy(re), torch.from_numpy(im))
    st0 = teq.eq_init(9, (C,), device="cpu")
    one_st, one = teq.equalize_stream(st0, fr, MU, MODULUS)
    a_st, a = teq.equalize_stream(
        st0, CF32(fr.re[:, :4], fr.im[:, :4]), MU, MODULUS)
    b_st, b = teq.equalize_stream(
        a_st, CF32(fr.re[:, 4:], fr.im[:, 4:]), MU, MODULUS)
    assert torch.equal(torch.cat([a.re, b.re], 1), one.re)
    assert torch.equal(b_st[0].im, one_st[0].im)
    assert torch.equal(b_st[1].re, one_st[1].re)
