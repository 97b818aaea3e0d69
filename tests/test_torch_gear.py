"""The torch port's Costas loop in its gear and gains modes
(``ops/costas.py`` gear shift; ``ops/cuda/costas_kernel.py``, its plain
version on CPU) against the JAX package: ``costas_run_gear_traced`` /
``costas_run_traced`` on the gain-scaled symbols, and the Pallas tm kernel
with ``gear``, ``gains`` and ``emit_bits`` in interpret mode.

Bits and the latched gear ``locked`` must be equal; derotated symbols, the
loop frequency and the lock level ``lev`` agree to 1e-4 (the frameworks'
cos/sin may differ in the last ulp, so only decisions are held equal
across lowerings)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu.ops import costas as jcostas
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu.ops.modmap import demod_bits as j_demod_bits
from qpsk_tpu.ops.pallas.costas_kernel import costas_run_pallas_tm
from qpsk_tpu_torch.ops import costas as tcostas
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.cuda.costas_kernel import costas_run_cm, costas_run_tm

from test_torch_costas import C, NSF, T, _symbols

torch.set_num_threads(2)

BW, BW_TRK = 2.0 * math.pi / 100.0, 2.0 * math.pi / 200.0
NF = T // NSF


def _gains(rng):
    """(F, C) per-frame gains around 1, as the AGC hands them over."""
    return rng.uniform(0.5, 2.0, (NF, C)).astype(np.float32)


def _state(warm, gear):
    rng = np.random.default_rng(8)
    if not warm:
        st = tcostas.costas_init((C,), gear=gear, device="cpu")
        return tuple(None if v is None else v.numpy() for v in st)
    return (rng.uniform(-3, 3, C).astype(np.float32),
            rng.uniform(-0.05, 0.05, C).astype(np.float32),
            rng.uniform(0.2, 0.5, C).astype(np.float32) if gear else None,
            (rng.uniform(size=C) < 0.5).astype(np.float32) if gear else None)


@pytest.mark.parametrize("mode", ["gear", "gains", "gear+gains"])
@pytest.mark.parametrize("stimulus", ["noise", "signal"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_gear_and_gains_match_jax(mode, stimulus, warm):
    zr, zi = _symbols(stimulus)
    use_gear, use_gains = "gear" in mode, "gains" in mode
    g = _gains(np.random.default_rng(9)) if use_gains else None
    init = _state(warm, use_gear)

    tp = tcostas.costas_params(BW)
    tgear = tcostas.gear_for(BW_TRK) if use_gear else None
    tst = tcostas.CostasState(*(None if v is None else torch.from_numpy(v)
                                for v in init))
    st, derot, ftrace, bits = costas_run_tm(
        tst, torch.from_numpy(zr), torch.from_numpy(zi), tp, NSF, gear=tgear,
        gains=None if g is None else torch.from_numpy(g))
    assert bits.shape == (C, 2 * T) and ftrace.shape == (C, NF)
    assert (st.lev is not None) == use_gear

    jp = jcostas.costas_params(BW)
    jgear = jcostas.gear_for(BW_TRK) if use_gear else None
    if use_gear:
        assert tuple(tgear) == tuple(float(v) for v in jgear)
    jst = jcostas.CostasState(*(None if v is None else jnp.asarray(v)
                                for v in init))
    # the reference scan runs on the gain-scaled symbols, as the JAX
    # package's composed path scales them (agc_stream) before the loop
    sr, si = (zr, zi) if g is None else (zr * np.repeat(g, NSF, 0),
                                         zi * np.repeat(g, NSF, 0))
    if use_gear:
        js, jd, jtr = jcostas.costas_run_gear_traced(
            jst, JCF32(sr.T, si.T), jp, jgear)
    else:
        js, jd, jtr = jcostas.costas_run_traced(jst, JCF32(sr.T, si.T), jp)
    ks, kd, kft, kbits = costas_run_pallas_tm(
        jst, jnp.asarray(zr), jnp.asarray(zi), jp, gear=jgear,
        trace_every=NSF, emit_bits=True,
        gains=None if g is None else jnp.asarray(g), interpret=True)

    np.testing.assert_array_equal(bits.numpy(), np.asarray(kbits))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(j_demod_bits(jd)))
    for ref_d, ref_f, ref_s in (
            ((np.asarray(jd.re).T, np.asarray(jd.im).T),
             np.asarray(jtr)[:, NSF - 1::NSF], js),
            ((np.asarray(kd.re), np.asarray(kd.im)), np.asarray(kft), ks)):
        np.testing.assert_allclose(derot.re.numpy(), ref_d[0], atol=1e-4)
        np.testing.assert_allclose(derot.im.numpy(), ref_d[1], atol=1e-4)
        np.testing.assert_allclose(ftrace.numpy(), ref_f, atol=1e-4)
        np.testing.assert_allclose(st.freq.numpy(), np.asarray(ref_s.freq), atol=1e-4)
        np.testing.assert_allclose(st.phase.numpy(), np.asarray(ref_s.phase), atol=1e-4)
        if use_gear:
            np.testing.assert_array_equal(st.locked.numpy(),
                                          np.asarray(ref_s.locked))
            np.testing.assert_allclose(st.lev.numpy(), np.asarray(ref_s.lev),
                                       atol=1e-4)


def test_gear_locks_on_signal_and_not_on_noise():
    """The lock detector separates the two stimuli (lev about 0.44 unlocked,
    well under 0.32 locked) and the locked loop runs the tracking gains."""
    out = {}
    for stimulus in ("noise", "signal"):
        zr, zi = _symbols(stimulus)
        st, _, _, _ = costas_run_tm(
            tcostas.costas_init((C,), gear=True, device="cpu"),
            torch.from_numpy(zr), torch.from_numpy(zi),
            tcostas.costas_params(BW), NSF, gear=tcostas.gear_for(BW_TRK))
        out[stimulus] = st
    assert float(out["noise"].locked.mean()) == 0.0
    assert float(out["noise"].lev.mean()) > 0.40
    assert float(out["signal"].locked.mean()) == 1.0
    assert float(out["signal"].lev.max()) < 0.32
    gear = tcostas.gear_for(BW_TRK)
    assert gear.gamma == 1.0 / 64.0 and tcostas.gear_for(0.0) is None
    assert gear.alpha_trk < tcostas.costas_params(BW).alpha


def test_channel_major_entry_and_chaining():
    """``costas_run_cm`` on (C, T) symbols equals the tm entry, and two
    chained gear + gains calls equal one call over both halves."""
    zr, zi = _symbols("signal")
    g = _gains(np.random.default_rng(10))
    tp, gear = tcostas.costas_params(BW), tcostas.gear_for(BW_TRK)
    st0 = tcostas.costas_init((C,), gear=True, device="cpu")
    one = costas_run_tm(st0, torch.from_numpy(zr), torch.from_numpy(zi), tp,
                        NSF, gear=gear, gains=torch.from_numpy(g))
    half, hf = T // 2, NF // 2
    a = costas_run_tm(st0, torch.from_numpy(zr[:half]),
                      torch.from_numpy(zi[:half]), tp, NSF, gear=gear,
                      gains=torch.from_numpy(g[:hf]))
    b = costas_run_tm(a[0], torch.from_numpy(zr[half:]),
                      torch.from_numpy(zi[half:]), tp, NSF, gear=gear,
                      gains=torch.from_numpy(g[hf:]))
    assert torch.equal(torch.cat([a[3], b[3]], 1), one[3])
    assert torch.equal(torch.cat([a[1].re, b[1].re]), one[1].re)
    for f in ("phase", "freq", "lev", "locked"):
        assert torch.equal(getattr(b[0], f), getattr(one[0], f))

    cm = costas_run_cm(st0, CF32(torch.from_numpy(zr.T.copy()),
                                 torch.from_numpy(zi.T.copy())), tp, NSF,
                       gear=gear)
    tm = costas_run_tm(st0, torch.from_numpy(zr), torch.from_numpy(zi), tp,
                       NSF, gear=gear)
    assert torch.equal(cm[3], tm[3]) and torch.equal(cm[1].re, tm[1].re.T)
    assert torch.equal(cm[2], tm[2]) and torch.equal(cm[0].lev, tm[0].lev)
