"""The per-frame entry points and the general batch shapes of the torch
port against the JAX package on CPU:

(a) ``tx_frame`` / ``tx_bits_frame`` chained equal ``tx_stream`` within
    1 LSB and JAX's ``tx_bits_frame`` within 2 LSB;
(b) ``rx_frame`` and the frame scan (``nco_mode="exact"``) equal JAX's on
    the same PCM: timing index and bits equal, symbols within 1e-4;
(c) ``costas_run``, ``costas_run_gear``, ``costas_init_from_freq``, the
    ``CostasLoop`` facade and ``agc_frame`` equal JAX's;
(d) ``(2, 3, F, n)`` inputs to ``tx_stream`` / ``rx_stream`` equal their
    flattened ``(6, F, n)`` run, state included.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg
from qpsk_tpu.modem import rx_frame as j_rx_frame, rx_stream as j_rx_stream
from qpsk_tpu.modem import tx_bits_frame as j_tx_bits_frame
from qpsk_tpu.ops import agc as jagc, costas as jcostas
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu.state import rx_init as j_rx_init, tx_init as j_tx_init
from qpsk_tpu_torch import (ModemConfig, rx_frame, rx_init, rx_stream,
                            tx_bits_frame, tx_frame, tx_init, tx_stream)
from qpsk_tpu_torch.modem import _symbols
from qpsk_tpu_torch.ops import agc as tagc, costas as tcostas
from qpsk_tpu_torch.ops.cplx import CF32

torch.set_num_threads(2)

TAU = 2.0 * math.pi


def _noisy(x, rng, snr=10.0):
    x = np.asarray(x).astype(np.float64)
    return np.clip(np.round(x + rng.normal(size=x.shape)
                            * np.sqrt((x ** 2).mean() / 10 ** (snr / 10))),
                   -32768, 32767).astype(np.int16)


# --- (a) TX -----------------------------------------------------------------

@pytest.mark.parametrize("fields", [{}, {"modulation": "8psk"},
                                    {"fir_precision": "exact"}],
                         ids=["qpsk", "8psk", "exact"])
def test_tx_frames_chain_like_tx_stream(fields):
    cfg, jc = ModemConfig(**fields), JCfg(**fields)
    bits = np.random.default_rng(0).integers(0, 2, (2, 4, cfg.bits_per_frame),
                                             dtype=np.int32)
    st_s, pcm_s = tx_stream(cfg, tx_init(cfg, (2,), device="cpu"),
                            torch.from_numpy(bits), tx_offset_hz=50.0)
    st, jst, parts, jparts = (tx_init(cfg, (2,), device="cpu"),
                              j_tx_init(jc, (2,)), [], [])
    for f in range(4):
        st, p = tx_bits_frame(cfg, st, torch.from_numpy(bits[:, f]), 50.0)
        jst, jp = j_tx_bits_frame(jc, jst, jnp.asarray(bits[:, f]), 50.0)
        parts.append(p.numpy().astype(np.int32))
        jparts.append(np.asarray(jp).astype(np.int32))
    chained = np.stack(parts, 1)
    assert np.abs(chained - pcm_s.numpy()).max() <= 1
    assert np.abs(chained - np.stack(jparts, 1)).max() <= 2
    np.testing.assert_allclose(st.nco_phase.re.numpy(),
                               st_s.nco_phase.re.numpy(), atol=1e-5)
    # tx_frame on the symbols tx_bits_frame maps
    st2, p2 = tx_frame(cfg, tx_init(cfg, (2,), device="cpu"),
                       _symbols(cfg, torch.from_numpy(bits[:, 0])), 50.0)
    assert torch.equal(p2, torch.from_numpy(parts[0].astype(np.int16)))


# --- (b) RX -----------------------------------------------------------------

@pytest.mark.parametrize("fields", [{}, {"agc": True, "eq_taps": 5},
                                    {"timing_mode": "tracking"},
                                    {"loop_bw_track": 0.03}],
                         ids=["default", "agc,eq", "tracking", "gear"])
def test_rx_frame_matches_jax(fields):
    """Four frames through ``rx_frame`` one at a time in both packages."""
    cfg, jc = ModemConfig(**fields), JCfg(**fields)
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (2, 4, 256), dtype=np.int32)
    _, pcm = tx_stream(cfg, tx_init(cfg, (2,), device="cpu"),
                       torch.from_numpy(bits), tx_offset_hz=50.0)
    pcm = _noisy(pcm, rng)
    st, jst = rx_init(cfg, (2,), device="cpu"), j_rx_init(jc, (2,))
    for f in range(4):
        st, out = rx_frame(cfg, st, torch.from_numpy(pcm[:, f]))
        jst, jout = j_rx_frame(jc, jst, jnp.asarray(pcm[:, f]))
        assert out.bits.shape == (2, 256) and out.freq_hz.shape == (2,)
        np.testing.assert_array_equal(out.timing_index.numpy(),
                                      np.asarray(jout.timing_index))
        np.testing.assert_array_equal(out.bits.numpy(), np.asarray(jout.bits))
        np.testing.assert_allclose(out.symbols.re.numpy(),
                                   np.asarray(jout.symbols.re), atol=1e-4)
        np.testing.assert_allclose(out.freq_hz.numpy(),
                                   np.asarray(jout.freq_hz), atol=0.05)


def test_frame_scan_matches_jax():
    """``nco_mode="exact"`` scans ``rx_frame``: a single stream and a batch
    of two, against JAX's scan, and two chained calls against one."""
    cfg, jc = ModemConfig(nco_mode="exact"), JCfg(nco_mode="exact")
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (2, 4, 256), dtype=np.int32)
    _, pcm = tx_stream(cfg, tx_init(cfg, (2,), device="cpu"),
                       torch.from_numpy(bits), tx_offset_hz=50.0)
    pcm = _noisy(pcm, rng)
    _, jout = j_rx_stream(jc, j_rx_init(jc, (2,)), pcm)
    st, out = rx_stream(cfg, rx_init(cfg, (2,), device="cpu"),
                        torch.from_numpy(pcm))
    assert out.symbols.re.shape == (2, 4, 128) and out.freq_hz.shape == (2, 4)
    np.testing.assert_array_equal(out.timing_index.numpy(),
                                  np.asarray(jout.timing_index))
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(jout.bits))
    np.testing.assert_allclose(out.freq_hz.numpy(), np.asarray(jout.freq_hz),
                               atol=0.05)
    _, one = rx_stream(cfg, rx_init(cfg, device="cpu"), torch.from_numpy(pcm[1]))
    assert torch.equal(one.bits, out.bits[1])
    s1, o1 = rx_stream(cfg, rx_init(cfg, (2,), device="cpu"),
                       torch.from_numpy(pcm[:, :1]))
    s2, o2 = rx_stream(cfg, s1, torch.from_numpy(pcm[:, 1:]))
    assert torch.equal(torch.cat([o1.bits, o2.bits], 1), out.bits)
    assert torch.equal(s2.nco_phase.re, st.nco_phase.re)


# --- (c) the ops ------------------------------------------------------------

def _sym(seed, shape=(3, 300)):
    rng = np.random.default_rng(seed)
    re, im = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    return JCF32(jnp.asarray(re), jnp.asarray(im)), CF32(torch.from_numpy(re),
                                                         torch.from_numpy(im))


def test_costas_run_matches_jax():
    jz, tz = _sym(3)
    freq0 = np.array([0.01, -0.02, 0.0], np.float32)
    for gear in (False, True):
        jst = jcostas.costas_init_from_freq(jnp.asarray(freq0), gear)
        tst = tcostas.costas_init_from_freq(torch.from_numpy(freq0), gear)
        assert (tst.lev is None) == (not gear)
        jp = jcostas.costas_params(TAU / 100)
        tp = tcostas.costas_params(TAU / 100)
        if gear:
            jst2, jout = jcostas.costas_run_gear(jst, jz, jp, jcostas.costas_gear(0.03))
            tst2, tout = tcostas.costas_run_gear(tst, tz, tp, tcostas.costas_gear(0.03))
            np.testing.assert_allclose(tst2.lev.numpy(), np.asarray(jst2.lev), atol=1e-5)
        else:
            jst2, jout = jcostas.costas_run(jst, jz, jp)
            tst2, tout = tcostas.costas_run(tst, tz, tp)
        np.testing.assert_allclose(tout.re.numpy(), np.asarray(jout.re), atol=1e-4)
        np.testing.assert_allclose(tout.im.numpy(), np.asarray(jout.im), atol=1e-4)
        np.testing.assert_allclose(tst2.freq.numpy(), np.asarray(jst2.freq), atol=1e-5)


def test_costas_loop_facade_matches_jax():
    """Every setter and getter of the reference's API, and a tracked
    block, against the JAX facade."""
    loops = [jcostas.CostasLoop(TAU / 100.0, batch_shape=(3,)),
             tcostas.CostasLoop(TAU / 100.0, batch_shape=(3,), device="cpu")]
    for lp in loops:
        lp.set_loop_bandwidth(TAU / 150.0)
        lp.set_damping_factor(0.8)
        lp.set_max_freq(0.5)
        lp.set_min_freq(-0.5)
        lp.set_frequency(0.7)          # clamped to max_freq
        lp.set_phase(7.0)              # wrapped into +-TAU
    j, t = loops
    for name in ("get_loop_bandwidth", "get_damping_factor", "get_max_freq",
                 "get_min_freq", "get_alpha", "get_beta"):
        assert getattr(t, name)() == pytest.approx(float(getattr(j, name)()), abs=1e-9)
    np.testing.assert_allclose(t.get_frequency().numpy(),
                               np.asarray(j.get_frequency()), atol=1e-7)
    np.testing.assert_allclose(t.get_phase().numpy(), np.asarray(j.get_phase()),
                               atol=1e-6)
    jz, tz = _sym(4)
    np.testing.assert_allclose(t(tz).re.numpy(), np.asarray(j(jz).re), atol=1e-4)
    for lp in loops:
        lp.set_alpha(0.05)
        lp.set_beta(0.001)
    assert t.get_alpha() == pytest.approx(float(j.get_alpha()))
    np.testing.assert_allclose(t(tz).im.numpy(), np.asarray(j(jz).im), atol=1e-4)
    t.set_loop_bandwidth(TAU / 100.0)   # drops the overrides, as in C
    assert t.get_alpha() == tcostas.costas_params(TAU / 100.0, 0.8).alpha


def test_agc_frame_matches_jax():
    jz, tz = _sym(5, (3, 128))
    est0 = np.array([0.0, 1.2, 3.0], np.float32)
    jest, jout = jagc.agc_frame(jnp.asarray(est0), jz, 1.45, 0.5)
    test, tout = tagc.agc_frame(torch.from_numpy(est0), tz, 1.45, 0.5)
    np.testing.assert_allclose(test.numpy(), np.asarray(jest), rtol=1e-6)
    np.testing.assert_allclose(tout.re.numpy(), np.asarray(jout.re), rtol=1e-5)


# --- (d) leading batch ------------------------------------------------------

@pytest.mark.parametrize("fields", [{}, {"rs": 1200.0, "differential": True}],
                         ids=["default", "dqpsk-1200"])
def test_leading_batch_equals_flat(fields):
    cfg = ModemConfig(**fields)
    rng = np.random.default_rng(6)
    bits = torch.from_numpy(rng.integers(0, 2, (2, 3, 2, cfg.bits_per_frame),
                                         dtype=np.int32))
    st4, pcm4 = tx_stream(cfg, tx_init(cfg, (2, 3), device="cpu"), bits, 50.0)
    st2, pcm2 = tx_stream(cfg, tx_init(cfg, (6,), device="cpu"),
                          bits.reshape(6, 2, -1), 50.0)
    assert pcm4.shape == (2, 3, 2, cfg.frame_size)
    assert torch.equal(pcm4.reshape(6, 2, -1), pcm2)
    assert st4.nco_phase.re.shape == (2, 3)
    pcm = torch.from_numpy(_noisy(pcm4, rng))
    rs4, out4 = rx_stream(cfg, rx_init(cfg, (2, 3), device="cpu"), pcm)
    rs2, out2 = rx_stream(cfg, rx_init(cfg, (6,), device="cpu"),
                          pcm.reshape(6, 2, -1))
    assert out4.bits.shape == (2, 3, 2, cfg.bits_per_frame)
    assert out4.freq_hz.shape == out4.timing_index.shape == (2, 3, 2)
    assert torch.equal(out4.bits.reshape(6, 2, -1), out2.bits)
    assert torch.equal(out4.symbols.re.reshape(6, 2, -1), out2.symbols.re)
    assert rs4.fir_tail.re.shape == (2, 3, cfg.ntaps - 1)
    assert torch.equal(rs4.costas.phase.reshape(6), rs2.costas.phase)
    with pytest.raises(ValueError, match="state leaf"):
        rx_stream(cfg, rx_init(cfg, (3, 2), device="cpu"), pcm)
