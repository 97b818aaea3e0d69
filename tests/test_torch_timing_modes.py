"""The fractional, tracking and histogram timing of the torch port
(``ops/timing.py`` and the modem's plain full-rate front-end) against the
JAX package on CPU:

(a) each timing function on the same samples: equal decisions (the
    histogram index, the rounded ``tau``), ``tau`` within 1e-4 samples,
    the interpolated picks within 3e-4, the tracking PLL's ``(tau, dtau)``
    within 1e-4 after a run of frames; ``"tracking"`` without a carry
    warns and degrades to the fractional estimate, as in JAX;
(b) each mode's ``rx_stream`` on the same PCM as JAX (equal timing index
    and bits), chunked calls equal to one call, the tracking state
    included;
(c) tracking through a 60 ppm ``clock_offset_pcm`` (the port's, equal to
    JAX's): the same decisions as JAX, and the link decodes (> 80 % of
    packets with the slip-tracked extractor);
(d) ``frontend_impl="pallas"`` with a front-end the kernel does not compute
    raises ``ValueError`` before anything runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg
from qpsk_tpu.channel import clock_offset_pcm as j_clock_offset
from qpsk_tpu.modem import rx_stream as j_rx_stream, tx_stream as j_tx_stream
from qpsk_tpu.ops import timing as jt
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu.state import rx_init as j_rx_init, tx_init as j_tx_init
from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream, tx_init, tx_stream
from qpsk_tpu_torch.channel import clock_offset_pcm
from qpsk_tpu_torch.ops import timing as tt
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
from qpsk_tpu_torch.sync import extract_packets_tracked, find_sync

torch.set_num_threads(2)

MODES = ["fractional", "tracking", "histogram"]


def _frames(seed, shape=(2, 5, 512)):
    """Filtered-looking samples: a smoothed random walk per plane."""
    rng = np.random.default_rng(seed)
    re, im = (np.cumsum(rng.normal(size=shape), -1).astype(np.float32) * 0.05
              for _ in range(2))
    return (JCF32(jnp.asarray(re), jnp.asarray(im)),
            CF32(torch.from_numpy(re), torch.from_numpy(im)))


# --- (a) the functions ------------------------------------------------------

def test_timing_functions_match_jax():
    jf, tf = _frames(0)
    np.testing.assert_array_equal(tt.timing_histogram(tf, 4).numpy(),
                                  np.asarray(jt.timing_histogram(jf, 4)))
    np.testing.assert_array_equal(tt.timing_power(tf, 4).numpy(),
                                  np.asarray(jt.timing_power(jf, 4)))
    jtau, ttau = jt.timing_fractional(jf, 4), tt.timing_fractional(tf, 4)
    np.testing.assert_allclose(ttau.numpy(), np.asarray(jtau), atol=1e-4)
    np.testing.assert_array_equal(torch.round(ttau).numpy(),
                                  np.round(np.asarray(jtau)))
    jp, tp = jt.decimate_fractional(jf, jtau, 4), tt.decimate_fractional(tf, ttau, 4)
    np.testing.assert_allclose(tp.re.numpy(), np.asarray(jp.re), atol=3e-4)
    np.testing.assert_allclose(tp.im.numpy(), np.asarray(jp.im), atol=3e-4)
    # an index past the symbol group (the histogram picks up to 7) reads
    # into the next group, the last group clamping to itself
    idx = np.array([[0, 3, 4, 5, 7]] * 2, np.int32)
    js = jt.decimate_select(jf, jnp.asarray(idx), 4)
    ts = tt.decimate_select(tf, torch.from_numpy(idx), 4)
    np.testing.assert_array_equal(ts.re.numpy(), np.asarray(js.re))
    jd, jn = jt.decimate_delayed(JCF32(jf.re[:, 0], jf.im[:, 0]),
                                 JCF32(jf.re[:, 1, :128], jf.im[:, 1, :128]),
                                 jnp.asarray(idx[:, 2]), 4)
    td, tn = tt.decimate_delayed(CF32(tf.re[:, 0], tf.im[:, 0]),
                                 CF32(tf.re[:, 1, :128], tf.im[:, 1, :128]),
                                 torch.from_numpy(idx[:, 2]), 4)
    np.testing.assert_array_equal(td.re.numpy(), np.asarray(jd.re))
    np.testing.assert_array_equal(tn.im.numpy(), np.asarray(jn.im))


def test_tracking_pll_matches_jax():
    """``timing_track`` over 5 frames from a non-zero carry, and its steps
    one at a time, within 1e-4 of JAX; ``_wrap_half_cycle`` equal."""
    jf, tf = _frames(1)
    carry = (np.array([3.7, 0.2], np.float32), np.array([0.01, -0.03], np.float32))
    jused, (jtau, jdtau) = jt.timing_track(jf, 4, tuple(map(jnp.asarray, carry)))
    tused, (ttau, tdtau) = tt.timing_track(tf, 4, tuple(map(torch.from_numpy, carry)))
    np.testing.assert_allclose(tused.numpy(), np.asarray(jused), atol=1e-4)
    np.testing.assert_allclose(ttau.numpy(), np.asarray(jtau), atol=1e-4)
    np.testing.assert_allclose(tdtau.numpy(), np.asarray(jdtau), atol=1e-4)
    st = tuple(map(torch.from_numpy, carry))
    for f in range(5):
        meas = tt.timing_fractional(CF32(tf.re[:, f], tf.im[:, f]), 4)
        used, st = tt.timing_track_step(st, meas, 4)
        np.testing.assert_allclose(used.numpy(), tused[:, f].numpy(), atol=1e-6)
    x = np.linspace(-9, 9, 37).astype(np.float32)
    np.testing.assert_allclose(tt._wrap_half_cycle(torch.from_numpy(x), 4).numpy(),
                               np.asarray(jt._wrap_half_cycle(jnp.asarray(x), 4)),
                               atol=1e-6)
    init = tt.timing_track_init((3,), device="cpu")
    assert all(v.dtype == torch.float32 and v.shape == (3,) for v in init)


@pytest.mark.parametrize("mode", MODES + ["power"])
def test_estimate_and_decimate_matches_jax(mode):
    jf, tf = _frames(2)
    with pytest.warns(RuntimeWarning) if mode == "tracking" else _nothing():
        tp, ti = tt.estimate_and_decimate(tf, 4, mode)
    jp, ji = jt.estimate_and_decimate(jf, 4, mode)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.re.numpy(), np.asarray(jp.re), atol=3e-4)
    with pytest.raises(ValueError):
        tt.estimate_and_decimate(tf, 4, "gardner")


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# --- (b) rx_stream ----------------------------------------------------------

def _pcm(jc, nframes, seed, snr=10.0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (2, nframes, jc.bits_per_frame), dtype=np.int32)
    _, pcm = j_tx_stream(jc, j_tx_init(jc, batch_shape=(2,)), bits,
                         tx_offset_hz=50.0)
    x = np.asarray(pcm).astype(np.float64)
    return np.clip(np.round(x + rng.normal(size=x.shape)
                            * np.sqrt((x ** 2).mean() / 10 ** (snr / 10))),
                   -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("mode", MODES)
def test_rx_stream_matches_jax_and_chains(mode):
    """The same PCM through JAX ``rx_stream`` and the port's: equal timing
    index and bits, symbols within 1e-4; the tracking PLL within 1e-4 of
    JAX's; three chained calls equal to one, state included."""
    cfg, jc = ModemConfig(timing_mode=mode), JCfg(timing_mode=mode)
    pcm = _pcm(jc, 6, seed=3)
    jst, jout = j_rx_stream(jc, j_rx_init(jc, batch_shape=(2,)), pcm)
    st, out = rx_stream(cfg, rx_init(cfg, (2,), device="cpu"),
                        torch.from_numpy(pcm))
    np.testing.assert_array_equal(out.timing_index.numpy(),
                                  np.asarray(jout.timing_index))
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(jout.bits))
    np.testing.assert_allclose(out.symbols.im.numpy(),
                               np.asarray(jout.symbols.im), atol=1e-4)
    if mode == "tracking":
        for a, b in zip(st.timing, jst.timing):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    else:
        assert st.timing is None
    s, parts = rx_init(cfg, (2,), device="cpu"), []
    for a, b in ((0, 2), (2, 3), (3, 6)):
        s, o = rx_stream(cfg, s, torch.from_numpy(pcm[:, a:b]))
        parts.append(o)
    assert torch.equal(torch.cat([o.bits for o in parts], 1), out.bits)
    assert torch.equal(torch.cat([o.timing_index for o in parts], 1),
                       out.timing_index)
    np.testing.assert_allclose(torch.cat([o.symbols.re for o in parts], 1),
                               out.symbols.re, atol=1e-5)
    for a, b in zip(s.timing or (), st.timing or ()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    np.testing.assert_allclose(s.costas.phase.numpy(), st.costas.phase.numpy(),
                               atol=1e-5)


# --- (c) the clock offset ---------------------------------------------------

def test_tracking_follows_a_60ppm_clock_offset():
    """Packets -> ``tx_stream`` -> the port's ``clock_offset_pcm(60e-6,
    frac_offset=-0.5)`` (equal to JAX's) -> tracking ``rx_stream`` (equal
    decisions to JAX's on the same PCM) -> ``find_sync`` -> the
    slip-tracked extractor: more than 80 % of the packets pass."""
    cfg, jc = ModemConfig(timing_mode="tracking"), JCfg(timing_mode="tracking")
    pcfg, nframes, skip = PacketConfig(payload_bytes=30), 32, 14
    gen = torch.Generator().manual_seed(4)
    payload = torch.randint(0, 2, (nframes, 240), generator=gen,
                            dtype=torch.int32)
    _, pcm = tx_stream(cfg, tx_init(cfg, device="cpu"),
                       assemble_packet(pcfg, payload), tx_offset_hz=50.0)
    warped = clock_offset_pcm(pcm.reshape(-1), 60e-6, frac_offset=-0.5)
    jw = np.asarray(j_clock_offset(jnp.asarray(pcm.reshape(-1).numpy()),
                                   60e-6, frac_offset=-0.5))
    assert warped.shape == jw.shape
    assert np.abs(warped.numpy().astype(np.int32) - jw).max() <= 1
    n = warped.numel() // cfg.frame_size * cfg.frame_size
    frames = warped[:n].reshape(-1, cfg.frame_size)
    _, out = rx_stream(cfg, rx_init(cfg, device="cpu"), frames)
    _, jout = j_rx_stream(jc, j_rx_init(jc), frames.numpy())
    np.testing.assert_array_equal(out.timing_index.numpy(),
                                  np.asarray(jout.timing_index))
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(jout.bits))
    bits = out.bits.reshape(-1)[skip * pcfg.frame_bits:]
    sync = find_sync(pcfg, bits, max_lag=600, probe_frames=4)
    navail = (bits.numel() - int(sync.bit_lag)) // pcfg.frame_bits
    rx = extract_packets_tracked(pcfg, bits, sync, max(navail, 1))
    assert int(sync.score) >= 2
    assert float(rx.crc_ok.float().mean()) > 0.8


# --- (d) the forced kernel --------------------------------------------------

@pytest.mark.parametrize("fields", [{"timing_mode": m} for m in MODES]
                         + [{"fir_precision": "exact"}],
                         ids=MODES + ["fir_precision=exact"])
def test_forced_frontend_kernel_refuses(fields):
    cfg = dataclasses.replace(ModemConfig(**fields), frontend_impl="pallas")
    with pytest.raises(ValueError, match="frontend_impl"):
        rx_stream(cfg, rx_init(cfg, (1,), device="cpu"),
                  torch.zeros((1, 1, 512), dtype=torch.int16))
