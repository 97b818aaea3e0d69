"""The Costas loop's decision-directed mode (``ops/cuda/costas_kernel.py``
with ``dd``, its plain version on CPU) against the JAX package: the
``lax.scan`` loop with ``modfam.dd_detector`` on the gain-scaled symbols,
and the Pallas tm kernel with ``dd`` + ``emit_label`` in interpret mode,
for BPSK, 8PSK and 16QAM, with and without per-frame gains.

Bits must be equal; derotated symbols and the final state within 1e-5 and
the frequency trace within 1e-6 (the bounds of ``tests/test_pallas_dd.py``
between the JAX package's two lowerings on the CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu.ops import costas as jcostas
from qpsk_tpu.ops import modfam as jm
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu.ops.pallas.costas_kernel import costas_run_pallas_tm
from qpsk_tpu_torch.ops import costas as tcostas
from qpsk_tpu_torch.ops import modfam as tm
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.cuda.costas_kernel import (costas_run_cm,
                                                   costas_run_tm,
                                                   costas_run_tm_plain,
                                                   unpack_labels_tm)

torch.set_num_threads(2)

C, T, NSF = 128, 512, 128
NF = T // NSF
SCALE = 1.45
BW = 0.0628


def _symbols(name, seed):
    """(T, C) float32 planes: noisy points at the chain's level, rotated
    by a slowly turning carrier the loop has to track."""
    mod = jm.get(name)
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, mod.M, (T, C))
    z = (mod.points_re[lab] + 1j * mod.points_im[lab]) * SCALE
    z = z + 0.07 * (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape))
    turn = np.exp(1j * (0.3 + 0.004 * np.arange(T)))[:, None]
    z = z * turn
    return z.real.astype(np.float32), z.imag.astype(np.float32)


@pytest.mark.parametrize("gains", [False, True], ids=["plain", "gains"])
@pytest.mark.parametrize("name", ["bpsk", "8psk", "16qam"])
def test_dd_loop_matches_jax(name, gains):
    zr, zi = _symbols(name, {"bpsk": 1, "8psk": 2, "16qam": 3}[name])
    rng = np.random.default_rng(4)
    g = rng.uniform(0.8, 1.25, (NF, C)).astype(np.float32) if gains else None
    freq0 = rng.uniform(-0.02, 0.02, C).astype(np.float32)
    dd = (name, SCALE)

    st, derot, ftrace, bits = costas_run_tm(
        tcostas.costas_init((C,), freq=torch.from_numpy(freq0), device="cpu"),
        torch.from_numpy(zr), torch.from_numpy(zi), tcostas.costas_params(BW),
        NSF, gains=None if g is None else torch.from_numpy(g), dd=dd)
    bps = tm.get(name).bps
    assert bits.shape == (C, bps * T) and ftrace.shape == (C, NF)
    assert st.lev is None

    jp, jmod = jcostas.costas_params(BW), jm.get(name)
    jst = jcostas.CostasState(phase=jnp.zeros(C, jnp.float32),
                              freq=jnp.asarray(freq0))
    sr, si = (zr, zi) if g is None else (zr * np.repeat(g, NSF, 0),
                                         zi * np.repeat(g, NSF, 0))
    js, jd, jtr = jcostas.costas_run_traced(
        jst, JCF32(sr.T, si.T), jp, detector=jm.dd_detector(jmod, SCALE))
    ks, kd, kft, kbits = costas_run_pallas_tm(
        jst, jnp.asarray(zr), jnp.asarray(zi), jp, trace_every=NSF,
        emit_label=True, dd=dd, gains=None if g is None else jnp.asarray(g),
        interpret=True)

    np.testing.assert_array_equal(bits.numpy(), np.asarray(kbits))
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jm.demod_bits_cmp(jd, jmod, SCALE)))
    for ref_d, ref_f, ref_s in (
            ((np.asarray(jd.re).T, np.asarray(jd.im).T),
             np.asarray(jtr)[:, NSF - 1::NSF], js),
            ((np.asarray(kd.re), np.asarray(kd.im)), np.asarray(kft), ks)):
        np.testing.assert_allclose(derot.re.numpy(), ref_d[0], atol=1e-5)
        np.testing.assert_allclose(derot.im.numpy(), ref_d[1], atol=1e-5)
        np.testing.assert_allclose(ftrace.numpy(), ref_f, atol=1e-6)
        np.testing.assert_allclose(st.freq.numpy(), np.asarray(ref_s.freq),
                                   atol=1e-5)
        np.testing.assert_allclose(st.phase.numpy(), np.asarray(ref_s.phase),
                                   atol=1e-5)
    # the loop tracks the turning carrier, 0.004 rad/symbol on average
    assert abs(float(ftrace[:, -1].mean()) - 0.004) < 5e-4


def test_unpack_labels_layout():
    """Symbol t at bits 4*(t%8) of word t//8; labels of 8 and more in the
    top slot set the sign bit, and still unpack."""
    rng = np.random.default_rng(5)
    lab = rng.integers(0, 16, (3, 64)).astype(np.int64)      # (C, T)
    lab[:, 7] = 15
    lab[:, 15] = 8
    words = np.zeros((8, 3), np.int64)
    for t in range(64):
        words[t // 8] |= lab[:, t] << (4 * (t % 8))
    packed = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    assert int(packed.min()) < 0
    got = unpack_labels_tm(packed)
    assert got.dtype == torch.int32 and got.shape == (3, 64)
    np.testing.assert_array_equal(got.numpy(), lab)


def test_dd_chains_and_channel_major_entry():
    """Two chained dd + gains calls equal one call over both halves, and
    ``costas_run_cm`` equals the tm entry; gear with dd is refused."""
    zr, zi = _symbols("16qam", 6)
    g = np.random.default_rng(7).uniform(0.8, 1.25, (NF, C)).astype(np.float32)
    tp, dd = tcostas.costas_params(BW), ("16qam", SCALE)
    st0 = tcostas.costas_init((C,), device="cpu")
    args = [torch.from_numpy(a) for a in (zr, zi, g)]
    one = costas_run_tm(st0, args[0], args[1], tp, NSF, gains=args[2], dd=dd)
    half, hf = T // 2, NF // 2
    a = costas_run_tm(st0, args[0][:half], args[1][:half], tp, NSF,
                      gains=args[2][:hf], dd=dd)
    b = costas_run_tm(a[0], args[0][half:], args[1][half:], tp, NSF,
                      gains=args[2][hf:], dd=dd)
    assert torch.equal(torch.cat([a[3], b[3]], 1), one[3])
    assert torch.equal(torch.cat([a[1].im, b[1].im]), one[1].im)
    assert torch.equal(b[0].phase, one[0].phase)
    cm = costas_run_cm(st0, CF32(args[0].T.contiguous(), args[1].T.contiguous()),
                       tp, NSF, dd=dd)
    tm_ = costas_run_tm_plain(st0, args[0], args[1], tp, NSF, dd=dd)
    assert torch.equal(cm[3], tm_[3]) and torch.equal(cm[2], tm_[2])
    assert torch.equal(cm[1].re, tm_[1].re.T)
    with pytest.raises(ValueError):
        costas_run_tm(tcostas.costas_init((C,), gear=True, device="cpu"),
                      args[0], args[1], tp, NSF,
                      gear=tcostas.gear_for(BW / 2), dd=dd)
