"""The torch port's generic modulation family (``ops/modfam.py``) against
the JAX package's ``qpsk_tpu.ops.modfam`` on the same numpy inputs.

Tables (points, rotation labels, detector constants) must be equal bit
for bit; label, bit and symbol maps equal; scores within 1e-6 and LLRs
within 1e-5 (XLA:CPU may contract the scores' multiply-adds, PyTorch
rounds each operation); the comparison slicer's labels equal and the
detector's error within 1e-7; EVM within 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu.ops import modfam as jm
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu_torch.ops import modfam as tm
from qpsk_tpu_torch.ops.cplx import CF32

NAMES = ["bpsk", "8psk", "16qam"]
SCALE = 1.45


def _cloud(name, n, seed, sigma=0.25):
    """Noisy points of ``name`` at the chain's level, with exact ties
    (zeros, |re| = |im| and the 16QAM threshold) mixed in."""
    mod = jm.get(name)
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, mod.M, n)
    re = mod.points_re[lab] * SCALE + sigma * rng.normal(size=n)
    im = mod.points_im[lab] * SCALE + sigma * rng.normal(size=n)
    re, im = re.astype(np.float32), im.astype(np.float32)
    thr = jm.dd_constants(mod, SCALE)[-1]
    re[:8], im[:8] = 0.0, [0.0, 1.0, -1.0, 0.5, -0.5, 0.0, 2.0, -2.0]
    im[8:16] = re[8:16] * np.array([1, -1] * 4, np.float32)
    re[16:20] = [thr, -thr, thr, -thr]
    return lab.astype(np.int32), re, im


@pytest.mark.parametrize("name", NAMES)
def test_tables_equal_jax(name):
    a, b = jm.get(name), tm.get(name)
    assert (a.name, a.bps, a.n_rot, a.M) == (b.name, b.bps, b.n_rot, b.M)
    for f in ("points_re", "points_im", "rot_labels"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for scale in (1.0, SCALE, 0.7):
        x, y = jm.dd_constants(a, scale), tm.dd_constants(b, scale)
        assert x.dtype == y.dtype == np.float32
        assert x.tobytes() == y.tobytes()
    for r in range(a.n_rot):
        assert np.array_equal(jm._bit_masks(a, r), tm._bit_masks(b, r))
    assert jm.ACQUIRE_POWER == tm.ACQUIRE_POWER
    assert sorted(tm.MODULATIONS) == sorted(jm.MODULATIONS)
    with pytest.raises(ValueError):
        tm.get("qpsk")


@pytest.mark.parametrize("name", NAMES)
def test_maps_equal_jax(name):
    mod, jmod = tm.get(name), jm.get(name)
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (3, 24 * mod.bps), dtype=np.int32)
    lab = tm.bits_to_labels(torch.from_numpy(bits), mod)
    np.testing.assert_array_equal(lab.numpy(),
                                  np.asarray(jm.bits_to_labels(bits, jmod)))
    np.testing.assert_array_equal(tm.labels_to_bits(lab, mod).numpy(), bits)
    sym = tm.bits_to_symbols_mod(torch.from_numpy(bits), mod)
    jsym = jm.bits_to_symbols_mod(bits, jmod)
    np.testing.assert_array_equal(sym.re.numpy(), np.asarray(jsym.re))
    np.testing.assert_array_equal(sym.im.numpy(), np.asarray(jsym.im))
    for r in range(mod.n_rot):
        np.testing.assert_array_equal(
            tm.rotate_bits_mod(torch.from_numpy(bits), r, mod).numpy(),
            np.asarray(jm.rotate_bits_mod(jnp.asarray(bits), r, jmod)))
    if mod.bps > 1:
        with pytest.raises(ValueError):
            tm.bits_to_labels(torch.zeros((1, mod.bps + 1), dtype=torch.int32),
                              mod)


@pytest.mark.parametrize("name", NAMES)
def test_scores_and_soft_match_jax(name):
    mod, jmod = tm.get(name), jm.get(name)
    _, re, im = _cloud(name, 2048, 2)
    sym, jsym = CF32(torch.from_numpy(re), torch.from_numpy(im)), JCF32(re, im)
    sc = tm.symbol_scores(sym, mod, SCALE)
    jsc = np.array(jm.symbol_scores(jsym, jmod, SCALE))
    assert sc.shape == (2048, mod.M)
    np.testing.assert_allclose(sc.numpy(), jsc, atol=1e-6, rtol=0)
    for r in range(mod.n_rot):
        np.testing.assert_allclose(
            tm.soft_from_scores(torch.from_numpy(jsc), mod, r).numpy(),
            np.asarray(jm.soft_from_scores(jnp.asarray(jsc), jmod, r)),
            atol=1e-5, rtol=0)
        np.testing.assert_allclose(
            tm.demod_soft_mod(sym, mod, SCALE, r).numpy(),
            np.asarray(jm.demod_soft_mod(jsym, jmod, SCALE, r)),
            atol=1e-5, rtol=0)
    far = slice(20, None)          # away from the planted exact ties
    np.testing.assert_array_equal(
        tm.demod_bits_mod(sym, mod, SCALE, 1).numpy()[mod.bps * 20:],
        np.asarray(jm.demod_bits_mod(jsym, jmod, SCALE, 1))[mod.bps * 20:])
    np.testing.assert_array_equal(
        tm.slice_labels(sym, mod, SCALE).numpy()[far],
        np.asarray(jm.slice_labels(jsym, jmod, SCALE))[far])


@pytest.mark.parametrize("name", NAMES)
def test_comparison_slicer_and_error_match_jax(name):
    mod, jmod = tm.get(name), jm.get(name)
    _, re, im = _cloud(name, 4096, 3)
    sym, jsym = CF32(torch.from_numpy(re), torch.from_numpy(im)), JCF32(re, im)
    consts = jm.dd_constants(jmod, SCALE)
    err, lab = tm.dd_err_ops(name, mod.M, sym.re, sym.im,
                             [float(v) for v in consts].__getitem__,
                             want_label=True)
    jerr, jlab = jm.dd_err_ops(name, jmod.M, jnp.asarray(re), jnp.asarray(im),
                               get=lambda i: consts[i],
                               stage=lambda u, v: (u, v), want_label=True)
    assert lab.dtype == torch.int32 and err.dtype == torch.float32
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(tm.slice_labels_cmp(sym, mod, SCALE).numpy(),
                                  np.asarray(jlab))
    for r in range(mod.n_rot):
        np.testing.assert_array_equal(
            tm.demod_bits_cmp(sym, mod, SCALE, r).numpy(),
            np.asarray(jm.demod_bits_cmp(jsym, jmod, SCALE, r)))
    det = tm.dd_detector(mod, SCALE)(sym)
    np.testing.assert_array_equal(det.numpy(), err.numpy())
    # the comparison slicer decides as the minimum-distance one off ties,
    # and a clean cloud decides the labels sent
    away = np.arange(4096) >= 20
    np.testing.assert_array_equal(lab.numpy()[away],
                                  tm.slice_labels(sym, mod, SCALE).numpy()[away])
    _, cre, cim = _cloud(name, 512, 4, sigma=0.02)
    clean = tm.slice_labels_cmp(CF32(torch.from_numpy(cre),
                                     torch.from_numpy(cim)), mod, SCALE)
    np.testing.assert_array_equal(clean.numpy()[20:], _cloud(name, 512, 4)[0][20:])


@pytest.mark.parametrize("name", NAMES)
def test_evm_matches_jax(name):
    mod, jmod = tm.get(name), jm.get(name)
    _, re, im = _cloud(name, 3 * 512, 5, sigma=0.1)
    re, im = re.reshape(3, 512), im.reshape(3, 512)
    for normalize in (True, False):
        got = tm.evm_mod(CF32(torch.from_numpy(re), torch.from_numpy(im)),
                         mod, normalize)
        want = jm.evm_mod(JCF32(re, im), jmod, normalize)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
