"""The torch port's loop and channel options as a whole, against the JAX
package on the CPU:

(a) the channel-major front-end (``rx_frontend``, its plain version here)
    against the Pallas ``rx_frontend_fused`` in interpret mode and the
    staged ``frontend_xla``, at 2400 and 1200 baud, one-shot and chained:
    timing index equal, picks within 3e-4, carried phase and tail 1e-5;
(b) TX at 1200 baud (8 samples per symbol) against JAX ``tx_stream`` and
    the Pallas TX kernel: 2 LSB one-shot, 3 chained (the JAX package's
    bounds between two accumulation orders);
(c) each configuration end to end: JAX TX -> channel -> the same int16
    PCM into JAX ``rx_stream`` and the port's ``rx_stream``: timing index
    equal, bits equal except within 1e-3 of a decision boundary, and the
    same packets passing sync and extraction.  The configurations are the
    JAX package's recorded ones: the AGC with the gear-shift loop at an
    input level of -26 dB (``cli.py`` ``--level-db``), the 9-tap CMA
    equalizer over the two-ray channel 0:1.0,4:0.5
    (``docs/per_vs_snr_multipath.jsonl``) and 1200 baud
    (``docs/per_vs_snr_1200baud.jsonl``);
(d) the port's time-major path against its composed path on AGC + gear:
    bit for bit, as both reduce and scale in the same op order;
(e) ``channel.multipath_pcm`` and the entry points' device default.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg, rx_init as j_rx_init, tx_init as j_tx_init
from qpsk_tpu.channel import multipath_pcm as j_multipath_pcm
from qpsk_tpu.modem import (frontend_xla as j_frontend_xla,
                            rx_stream as j_rx_stream, tx_stream as j_tx_stream)
from qpsk_tpu.ops import modmap as jmodmap
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu.ops.pallas.frontend_kernel import rx_frontend_fused
from qpsk_tpu.ops.pallas.tx_kernel import tx_modulate_fused
from qpsk_tpu.packet import PacketConfig as JPacketConfig, assemble_packet as j_assemble
from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream, tx_init, tx_stream
from qpsk_tpu_torch import modem
from qpsk_tpu_torch.channel import multipath_pcm
from qpsk_tpu_torch.config import config_1200, from_dict
from qpsk_tpu_torch.ops.cuda.costas_kernel import costas_run_cm, costas_run_tm
from qpsk_tpu_torch.ops.cuda.frontend_kernel import rx_frontend, rx_frontend_tm
from qpsk_tpu_torch.ops.cuda.tx_kernel import tx_modulate
from qpsk_tpu_torch.ops.modmap import bits_to_symbols
from qpsk_tpu_torch.packet import PacketConfig
from qpsk_tpu_torch.state import from_numpy
from qpsk_tpu_torch.sync import extract_packets, find_sync

torch.set_num_threads(2)

TAU = 2.0 * math.pi
PCFG, JPCFG = PacketConfig(payload_bytes=30), JPacketConfig(payload_bytes=30)
NEAR_TIE = 1e-3
# name: (config fields, SNR dB, multipath paths, input level dB)
CONFIGS = {
    "level": (dict(agc=True, loop_bw_track=TAU / 200.0), 10.0, None, -26.0),
    "multipath": (dict(eq_taps=9), 14.0, ((0, 1.0), (4, 0.5)), 0.0),
    "1200": (dict(rs=1200.0), 8.0, None, 0.0),
}


def _cfgs(kwargs):
    jc = JCfg(**kwargs)
    return from_dict(dataclasses.asdict(jc)), jc


def _noisy(pcm, rng, snr_db):
    """numpy AWGN at ``snr_db`` on int16 PCM, the same for both packages."""
    x = np.asarray(pcm).astype(np.float64)
    sigma = np.sqrt((x ** 2).mean() / 10.0 ** (snr_db / 10.0))
    return np.clip(np.round(x + rng.normal(size=x.shape) * sigma),
                   -32768, 32767).astype(np.int16)


# --- (a) channel-major front-end -------------------------------------------

def _fe_pcm(jc, c, nframes, stimulus, seed):
    rng = np.random.default_rng(seed)
    if stimulus == "random":
        return rng.integers(-12000, 12000, (c, nframes, 512), dtype=np.int16)
    bits = rng.integers(0, 2, (c, nframes, jc.bits_per_frame), dtype=np.int32)
    _, pcm = j_tx_stream(jc, j_tx_init(jc, batch_shape=(c,)), bits,
                         tx_offset_hz=50.0)
    return _noisy(pcm, rng, 10.0)


def _warm(cfg, head):
    """The carried (nco_phase, fir_tail) after the ``head`` frames, from the
    port's plain front-end, as JAX and torch CF32 pairs: both packages
    start the body from the same state."""
    st = rx_init(cfg, (head.shape[0],), device="cpu")
    _, _, phase, tail = rx_frontend(cfg, torch.from_numpy(head),
                                    st.nco_phase, st.fir_tail)
    return (tuple(JCF32(jnp.asarray(t.re.numpy()), jnp.asarray(t.im.numpy()))
                  for t in (phase, tail)), (phase, tail))


def _assert_fe_close(port, ref):
    picks, idx, ph, tl = port
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[1]))
    for a, b, tol in ((picks, ref[0], 3e-4), (ph, ref[2], 1e-5),
                      (tl, ref[3], 1e-5)):
        np.testing.assert_allclose(a.re.numpy(), np.asarray(b.re), atol=tol)
        np.testing.assert_allclose(a.im.numpy(), np.asarray(b.im), atol=tol)


@pytest.mark.parametrize("stimulus", ["random", "loopback"])
@pytest.mark.parametrize("rs", [2400.0, 1200.0])
def test_channel_major_frontend_matches_jax(rs, stimulus):
    cfg, jc = _cfgs(dict(rs=rs))
    c, nframes = 16, 4
    pcm = _fe_pcm(jc, c, nframes + 2, stimulus, seed=int(rs))
    (jphase, jtail), (phase, tail) = _warm(cfg, pcm[:, :2])
    body = np.ascontiguousarray(pcm[:, 2:])
    port = rx_frontend(cfg, torch.from_numpy(body), phase, tail)
    assert port[0].re.shape == (c, nframes, cfg.symbols_per_frame)
    assert port[1].dtype == torch.int32
    fused = rx_frontend_fused(jc, body, jphase, jtail, interpret=True)
    _assert_fe_close(port, fused)
    _assert_fe_close(port, j_frontend_xla(jc, body, jphase, jtail))

    # chained: two calls of 2 frames against JAX's one call of 4
    a = rx_frontend(cfg, torch.from_numpy(np.ascontiguousarray(body[:, :2])),
                    phase, tail)
    b = rx_frontend(cfg, torch.from_numpy(np.ascontiguousarray(body[:, 2:])),
                    a[2], a[3])
    chained = (type(a[0])(*(torch.cat([x, y], 1) for x, y in zip(a[0], b[0]))),
               torch.cat([a[1], b[1]], 1), b[2], b[3])
    _assert_fe_close(chained, fused)


# --- (b) TX at 1200 baud ----------------------------------------------------

def _lsb(a, b):
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max())


def test_tx_1200_baud_matches_jax():
    cfg, jc = _cfgs(dict(rs=1200.0))
    c, nframes = 8, 8
    bits = np.random.default_rng(12).integers(
        0, 2, (c, nframes, jc.bits_per_frame), dtype=np.int32)
    jst = j_tx_init(jc, batch_shape=(c,))
    xst, xp = j_tx_stream(jc, jst, bits, tx_offset_hz=50.0)
    st, pcm = tx_stream(cfg, from_numpy(jax.tree.map(np.asarray, jst),
                                        device="cpu"),
                        torch.from_numpy(bits), tx_offset_hz=50.0)
    assert pcm.shape == (c, nframes, 512) and pcm.dtype == torch.int16
    assert _lsb(pcm, xp) <= 2
    np.testing.assert_allclose(st.fir_tail.re.numpy(), np.asarray(xst.fir_tail.re),
                               atol=1e-6)
    np.testing.assert_allclose(st.nco_phase.im.numpy(),
                               np.asarray(xst.nco_phase.im), atol=1e-4)
    flat = bits.reshape(c, -1)
    kp, _, _ = tx_modulate_fused(jc, jmodmap.bits_to_symbols(flat),
                                 jst.nco_phase, jst.fir_tail,
                                 tx_offset_hz=50.0, interpret=True)
    assert _lsb(pcm.reshape(c, -1), kp) <= 2

    # chained port calls == one JAX pass over the concatenation
    sym = bits_to_symbols(torch.from_numpy(flat))
    state, parts = tx_init(cfg, (c,), device="cpu"), []
    for sl in (slice(0, 128), slice(128, None)):
        p, ph, tl = tx_modulate(cfg, type(sym)(sym.re[:, sl].contiguous(),
                                               sym.im[:, sl].contiguous()),
                                state.nco_phase, state.fir_tail, 50.0)
        state = state._replace(nco_phase=ph, fir_tail=tl)
        parts.append(p)
    assert _lsb(torch.cat(parts, 1), np.asarray(xp).reshape(c, -1)) <= 3


# --- (c) each configuration end to end -------------------------------------

def _link(name, c, seed):
    """(port cfg, JAX cfg, payload (C, npk, 240), noisy PCM (C, F, 512))."""
    kwargs, snr_db, paths, level_db = CONFIGS[name]
    cfg, jc = _cfgs(kwargs)
    rng = np.random.default_rng(seed)
    npk = 40
    payload = rng.integers(0, 2, (c, npk, 240), dtype=np.int32)
    chan = np.asarray(j_assemble(JPCFG, payload)).reshape(c, -1, jc.bits_per_frame)
    _, pcm = j_tx_stream(jc, j_tx_init(jc, batch_shape=(c,)), chan,
                         tx_offset_hz=50.0)
    if paths:
        pcm = j_multipath_pcm(np.asarray(pcm).reshape(c, -1), paths).reshape(
            pcm.shape)
    pcm = _noisy(pcm, rng, snr_db)
    if level_db:
        g = np.float32(10.0 ** (level_db / 20.0))
        pcm = np.clip(np.round(pcm.astype(np.float32) * g), -32768,
                      32767).astype(np.int16)
    return cfg, jc, payload, pcm


def _decode(bits):
    stream = bits.reshape(-1)[8 * PCFG.frame_bits:]
    sync = find_sync(PCFG, stream, max_lag=600, probe_frames=4)
    navail = (stream.numel() - int(sync.bit_lag)) // PCFG.frame_bits
    return sync, extract_packets(PCFG, stream, sync, navail)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_configuration_matches_jax_end_to_end(name):
    c = 2
    cfg, jc, payload, pcm = _link(name, c, seed=20)
    jst, jout = j_rx_stream(jc, j_rx_init(jc, batch_shape=(c,)), pcm)
    st, out = rx_stream(cfg, rx_init(cfg, (c,), device="cpu"),
                        torch.from_numpy(pcm))
    nsf = cfg.symbols_per_frame
    assert out.bits.shape == (c, pcm.shape[1], 2 * nsf)
    np.testing.assert_array_equal(out.timing_index.numpy(),
                                  np.asarray(jout.timing_index))
    jbits = torch.from_numpy(np.array(jout.bits))
    tie = torch.stack([out.symbols.im.abs() < NEAR_TIE,
                       out.symbols.re.abs() < NEAR_TIE], -1).reshape(jbits.shape)
    flips = jbits != out.bits
    assert bool(tie[flips].all()), int(flips.sum())
    np.testing.assert_allclose(out.freq_hz.numpy(), np.asarray(jout.freq_hz),
                               atol=0.05)
    if cfg.agc:
        np.testing.assert_allclose(st.agc.numpy(), np.asarray(jst.agc),
                                   rtol=1e-5)
    if cfg.loop_bw_track:
        np.testing.assert_array_equal(st.costas.locked.numpy(),
                                      np.asarray(jst.costas.locked))
        np.testing.assert_allclose(st.costas.lev.numpy(),
                                   np.asarray(jst.costas.lev), atol=1e-4)
    if cfg.eq_taps:
        np.testing.assert_allclose(st.eq[0].re.numpy(),
                                   np.asarray(jst.eq[0].re), atol=1e-4)

    npk = nok = 0
    for ch in range(c):
        ks, krx = _decode(out.bits[ch])
        js, jrx = _decode(jbits[ch])
        assert (int(ks.rotation), int(ks.bit_lag), int(ks.score)) == \
            (int(js.rotation), int(js.bit_lag), int(js.score))
        assert torch.equal(krx.crc_ok, jrx.crc_ok)
        ok = krx.crc_ok
        got = krx.payload_bits[ok]
        sent = {tuple(p) for p in payload[ch].tolist()}
        assert all(tuple(p) in sent for p in got.tolist())
        npk += ok.numel()
        nok += int(ok.sum())
    # the JAX package records PER 0.0152 (multipath, 12 dB) and 0.0154
    # (1200 baud, 6 dB) two dB below these points: nearly every packet passes
    assert nok >= 0.9 * npk, (nok, npk)


# --- (d) the two receive paths ----------------------------------------------

def test_tm_path_equals_composed_path():
    """AGC + gear through the time-major path (powers from the front-end,
    gains in the Costas loop) and the composed path (``agc_stream`` on the
    channel-major picks) give the same bits, symbols and state, bit for
    bit, in two chained calls."""
    c = 2
    cfg, _, _, pcm = _link("level", c, seed=21)
    pcm = torch.from_numpy(pcm[:, :16])
    st_tm = st_cm = rx_init(cfg, (c,), device="cpu")
    for part in (pcm[:, :8], pcm[:, 8:]):
        st_tm, tm = modem._rx_stream_tm(cfg, st_tm, part.contiguous(),
                                        rx_frontend_tm, costas_run_tm)
        st_cm, cm = modem._rx_stream_composed(cfg, st_cm, part.contiguous(),
                                              rx_frontend, costas_run_cm)
        assert torch.equal(tm.bits, cm.bits)
        assert torch.equal(tm.symbols.re, cm.symbols.re)
        assert torch.equal(tm.freq_hz, cm.freq_hz)
        assert torch.equal(tm.timing_index, cm.timing_index)
    for a, b in zip(jax.tree.leaves(tuple(st_tm), is_leaf=torch.is_tensor),
                    jax.tree.leaves(tuple(st_cm), is_leaf=torch.is_tensor),
                    strict=True):
        assert torch.equal(a, b)
    assert float(st_tm.costas.locked.mean()) == 1.0


# --- (e) channel and device default ----------------------------------------

def test_multipath_pcm_matches_jax():
    pcm = np.random.default_rng(30).integers(-20000, 20000, (3, 2048),
                                             dtype=np.int16)
    paths = ((0, 1.0), (4, 0.5), (9, -0.3))
    got = multipath_pcm(torch.from_numpy(pcm), paths)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_multipath_pcm(pcm, paths)))
    with pytest.raises(ValueError):
        multipath_pcm(torch.from_numpy(pcm), ((-1, 1.0),))


def test_entry_points_default_to_the_card():
    """State is built on the card unless the caller asks for the CPU; with
    no card that raises instead of falling back."""
    cfg = config_1200()
    makers = (lambda: rx_init(cfg, (1,)), lambda: tx_init(cfg, (1,)),
              lambda: from_numpy(jax.tree.map(np.asarray,
                                              j_tx_init(JCfg(), (1,)))))
    for make in makers:
        if torch.cuda.is_available():
            assert all(t.is_cuda for t in jax.tree.leaves(
                tuple(make()), is_leaf=torch.is_tensor))
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                make()
    st = rx_init(ModemConfig(agc=True, eq_taps=3, loop_bw_track=0.01), (2,),
                 device="cpu")
    assert st.agc.device.type == "cpu" and st.costas.lev.device.type == "cpu"
