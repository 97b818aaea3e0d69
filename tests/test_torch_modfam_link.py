"""The generic modulation family end to end in the torch port, against the
JAX package on the same int16 PCM.

Packets are re-framed into modem frames with filler bits (``cli.py``), sent
by JAX ``tx_stream`` at +50 Hz through numpy AWGN, then received by both
packages: ``rx_acquire_hz`` -> ``rx_init(acq_freq=...)`` -> ``rx_stream``
-> sync -> packets.  Both loops start from the port's estimate, which must
be within 0.05 Hz of JAX's.  Bits must be equal except on symbols within
1e-4 of a decision boundary (a sign, ``|re| = |im|`` for 8PSK, the 16QAM
threshold), which are counted; symbols agree within 1e-4 and ``freq_hz``
within 0.05 Hz; sync results and packet verdicts must be equal.  The port
runs its plain versions here (CPU tensors), JAX its CPU lowering."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg, rx_init as j_rx_init
from qpsk_tpu import tx_init as j_tx_init
from qpsk_tpu.modem import rx_acquire_hz as j_rx_acquire_hz
from qpsk_tpu.modem import rx_stream as j_rx_stream
from qpsk_tpu.modem import tx_stream as j_tx_stream
from qpsk_tpu.ops import modfam as jm
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu.packet import PacketConfig as JPacketConfig
from qpsk_tpu.packet import assemble_packet as j_assemble
from qpsk_tpu import sync as jsync
from qpsk_tpu_torch import rx_init, rx_stream, tx_init, tx_stream
from qpsk_tpu_torch import sync
from qpsk_tpu_torch.config import from_dict
from qpsk_tpu_torch.modem import rx_acquire_hz
from qpsk_tpu_torch.ops import modfam
from qpsk_tpu_torch.ops.acquire import hz_to_costas_freq
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.packet import PacketConfig
from qpsk_tpu_torch.state import from_numpy

torch.set_num_threads(2)

NEAR = 1e-4
# name: (config fields, SNR dB): the operating points where the JAX
# package measured PER 0 (docs/per_vs_snr_{bpsk,8psk,16qam}.jsonl)
LINKS = {"bpsk": (dict(modulation="bpsk"), 8.0),
         "8psk": (dict(modulation="8psk"), 18.0),
         "16qam": (dict(modulation="16qam", agc=True), 20.0)}


def _cfgs(kwargs):
    jc = JCfg(**kwargs)
    return from_dict(dataclasses.asdict(jc)), jc


def _noisy(pcm, rng, snr_db):
    x = np.asarray(pcm).astype(np.float64)
    sigma = np.sqrt((x ** 2).mean() / 10.0 ** (snr_db / 10.0))
    return np.clip(np.round(x + rng.normal(size=x.shape) * sigma),
                   -32768, 32767).astype(np.int16)


def _link(kwargs, fec, c, npk, snr_db, seed):
    """(cfg, JAX cfg, port and JAX packet configs, payload (C, npk, 240),
    noisy PCM (C, F, 512)): packets re-framed into whole modem frames with
    random filler, as ``cli.py`` sends them."""
    cfg, jc = _cfgs(kwargs)
    pcfg, jpcfg = PacketConfig(payload_bytes=30, fec=fec), \
        JPacketConfig(payload_bytes=30, fec=fec)
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (c, npk, 240), dtype=np.int32)
    chan = np.asarray(j_assemble(jpcfg, payload)).reshape(c, -1)
    mfb = jc.bits_per_frame
    filler = rng.integers(0, 2, (c, (-chan.shape[1]) % mfb), dtype=np.int32)
    frames = np.concatenate([chan, filler], axis=1).reshape(c, -1, mfb)
    _, pcm = j_tx_stream(jc, j_tx_init(jc, batch_shape=(c,)), frames,
                         tx_offset_hz=50.0)
    return cfg, jc, pcfg, jpcfg, payload, _noisy(pcm, rng, snr_db)


def _receive(cfg, jc, pcm):
    """Both receivers on the same PCM, from the port's acquisition."""
    c = pcm.shape[0]
    hz = rx_acquire_hz(cfg, torch.from_numpy(pcm))
    np.testing.assert_allclose(hz.numpy(), np.asarray(j_rx_acquire_hz(jc, pcm)),
                               atol=0.05)
    acq = hz_to_costas_freq(hz, cfg.rs)
    st, out = rx_stream(cfg, rx_init(cfg, (c,), acq_freq=acq, device="cpu"),
                        torch.from_numpy(pcm))
    jst, jout = j_rx_stream(jc, j_rx_init(jc, batch_shape=(c,),
                                          acq_freq=jnp.asarray(acq.numpy())),
                            pcm)
    return out, jout, st, jst


def _boundary_distance(name, re, im, thr):
    """How far each symbol lies from its nearest decision boundary."""
    d = np.abs(im) if name != "bpsk" else np.full_like(re, np.inf)
    d = np.minimum(d, np.abs(re))
    if name == "8psk":
        d = np.minimum(d, np.abs(np.abs(im) - np.abs(re)))
    if name == "16qam":
        d = np.minimum(d, np.minimum(np.abs(np.abs(re) - thr),
                                     np.abs(np.abs(im) - thr)))
    return d


def _assert_like_jax(cfg, out, jout):
    """Bits equal except on symbols within NEAR of a boundary, at most
    0.1 % of them; symbols within 1e-4, freq_hz within 0.05 Hz, timing
    equal."""
    name, bps = cfg.modulation, cfg.bits_per_symbol
    c, nframes, nsf = out.symbols.re.shape
    assert out.bits.shape == (c, nframes, bps * nsf)
    assert out.bits.dtype == torch.int32
    np.testing.assert_array_equal(out.timing_index.numpy(),
                                  np.asarray(jout.timing_index))
    re, im = out.symbols.re.numpy(), out.symbols.im.numpy()
    np.testing.assert_allclose(re, np.asarray(jout.symbols.re), atol=1e-4)
    np.testing.assert_allclose(im, np.asarray(jout.symbols.im), atol=1e-4)
    np.testing.assert_allclose(out.freq_hz.numpy(), np.asarray(jout.freq_hz),
                               atol=0.05)
    flips = (out.bits.numpy() != np.asarray(jout.bits)).reshape(
        c, nframes, nsf, bps).any(-1)
    thr = modfam.dd_constants(modfam.get(name), cfg.agc_target)[-1]
    near = _boundary_distance(name, re, im, thr) < NEAR
    assert not (flips & ~near).any()
    assert flips.sum() <= 1e-3 * flips.size, int(flips.sum())


def _skip_bits(cfg, pcfg, packets):
    """The CLI's transient skip, symbol-aligned (``cli.py``)."""
    skip = packets * pcfg.frame_bits
    return skip - skip % cfg.bits_per_symbol


def _check_payloads(rx, sent):
    """Every CRC-passing packet is one of the payloads sent, in order."""
    ok = rx.crc_ok.numpy()
    got = rx.payload_bits.numpy()[ok]
    idx = [next(k for k in range(len(sent)) if np.array_equal(p, sent[k]))
           for p in got]
    assert idx == sorted(idx)
    return int(ok.sum()), ok.size


@pytest.mark.parametrize("name", list(LINKS))
def test_tx_matches_jax(name):
    cfg, jc = _cfgs(LINKS[name][0])
    c = 3
    bits = np.random.default_rng(3).integers(
        0, 2, (c, 6, jc.bits_per_frame), dtype=np.int32)
    jst = j_tx_init(jc, batch_shape=(c,))
    _, xp = j_tx_stream(jc, jst, bits, tx_offset_hz=50.0)
    st = from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    _, pcm = tx_stream(cfg, st, torch.from_numpy(bits), tx_offset_hz=50.0)
    assert pcm.shape == (c, 6, 512) and pcm.dtype == torch.int16
    assert _lsb(pcm, xp) <= 2
    # chained halves against JAX's one call
    st2, a = tx_stream(cfg, tx_init(cfg, (c,), device="cpu"),
                       torch.from_numpy(bits[:, :3]), tx_offset_hz=50.0)
    _, b = tx_stream(cfg, st2, torch.from_numpy(bits[:, 3:]), tx_offset_hz=50.0)
    assert _lsb(torch.cat([a, b], 1), xp) <= 3
    if cfg.bits_per_symbol > 1:
        with pytest.raises(NotImplementedError):
            tx_stream(cfg, st, torch.zeros((c, 1, cfg.bits_per_symbol + 1),
                                           dtype=torch.int32))


def _lsb(a, b):
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max())


def _hunt_alike(pcfg, jpcfg, name, bits, jbits, **kw):
    """The port's hunt on its bits and on JAX's, and JAX's on its own: the
    same (rotation, lag, score)."""
    s = sync.find_sync(pcfg, bits, modulation=name, **kw)
    js = jsync.find_sync(jpcfg, jnp.asarray(jbits), modulation=name, **kw)
    s2 = sync.find_sync(pcfg, torch.from_numpy(jbits), modulation=name, **kw)
    for a in (s, s2):
        assert (int(a.rotation), int(a.bit_lag), int(a.score)) == \
            (int(js.rotation), int(js.bit_lag), int(js.score))
    return s, js


def _packets_alike(rx, jrx):
    np.testing.assert_array_equal(rx.crc_ok.numpy(), np.asarray(jrx.crc_ok))
    np.testing.assert_array_equal(rx.rotation.numpy(), np.asarray(jrx.rotation))
    np.testing.assert_array_equal(rx.payload_bits.numpy(),
                                  np.asarray(jrx.payload_bits))


def _uncoded_alike(cfg, pcfg, jpcfg, out, jout, payload):
    """Per channel: the hunt and the tracked extraction alike in both
    packages; returns (packets passing, packets)."""
    name = cfg.modulation
    skip = _skip_bits(cfg, pcfg, 2)
    nok = npk = 0
    for ch in range(out.bits.shape[0]):
        bits = out.bits[ch].reshape(-1)[skip:]
        jbits = np.array(jout.bits[ch]).reshape(-1)[skip:]
        s, js = _hunt_alike(pcfg, jpcfg, name, bits, jbits, max_lag=600,
                            probe_frames=4)
        navail = (bits.numel() - int(s.bit_lag)) // pcfg.frame_bits
        rx = sync.extract_packets_tracked(pcfg, bits, s, navail,
                                          modulation=name)
        _packets_alike(rx, jsync.extract_packets_tracked(
            jpcfg, jnp.asarray(jbits), js, navail, modulation=name))
        one = sync.extract_packets(pcfg, bits, s, navail, modulation=name)
        jone = jsync.extract_packets(jpcfg, jnp.asarray(jbits), js, navail,
                                     modulation=name)
        np.testing.assert_array_equal(one.crc_ok.numpy(), np.asarray(jone.crc_ok))
        k, n = _check_payloads(rx, payload[ch])
        nok, npk = nok + k, npk + n
    return nok, npk


@pytest.mark.parametrize("name", list(LINKS))
def test_link_matches_jax(name):
    kwargs, snr_db = LINKS[name]
    cfg, _ = _cfgs(kwargs)
    c, nframes = 2, 24
    cfg, jc, pcfg, jpcfg, payload, pcm = _link(
        kwargs, False, c, nframes * cfg.bits_per_frame // 256, snr_db, seed=40)
    out, jout, st, jst = _receive(cfg, jc, pcm)
    assert pcm.shape[1] == nframes
    _assert_like_jax(cfg, out, jout)
    if cfg.agc:
        np.testing.assert_allclose(st.agc.numpy(), np.asarray(jst.agc),
                                   rtol=1e-5)
    nok, npk = _uncoded_alike(cfg, pcfg, jpcfg, out, jout, payload)
    # the JAX package measured PER 0 at these points
    assert nok >= 0.9 * npk, (nok, npk)


def test_composed_chain_matches_jax():
    """8PSK at 1200 baud runs the composed chain: the channel-major
    front-end and the channel-major Costas entry in dd mode."""
    kwargs = dict(modulation="8psk", rs=1200.0)
    cfg, _ = _cfgs(kwargs)
    c, nframes = 2, 32
    cfg, jc, pcfg, jpcfg, payload, pcm = _link(
        kwargs, False, c, nframes * cfg.bits_per_frame // 256, 18.0, seed=41)
    out, jout, _, _ = _receive(cfg, jc, pcm)
    assert out.bits.shape == (c, nframes, 3 * 64)
    _assert_like_jax(cfg, out, jout)
    nok, npk = _uncoded_alike(cfg, pcfg, jpcfg, out, jout, payload)
    assert nok >= 0.9 * npk, (nok, npk)


# name: (config fields, code, SNR dB, packets)
CODED = {"bpsk-conv": (dict(modulation="bpsk"), "conv", 1.0, 14),
         "8psk-ldpc": (dict(modulation="8psk"), "ldpc", 13.0, 24)}


@pytest.mark.parametrize("case", list(CODED))
def test_coded_link_matches_jax(case):
    """The soft path of ``cli.py``: score matrix -> every rotation's LLR
    stream -> soft hunt over every lag (8 probes) -> the tracked soft
    extractor, decoded by the port's plain Viterbi or min-sum."""
    kwargs, fec, snr_db, npk = CODED[case]
    cfg, jc, pcfg, jpcfg, payload, pcm = _link(kwargs, fec, 1, npk, snr_db,
                                               seed=42)
    out, jout, _, _ = _receive(cfg, jc, pcm)
    _assert_like_jax(cfg, out, jout)
    mod, jmod = modfam.get(cfg.modulation), jm.get(cfg.modulation)
    bps = mod.bps
    skip = _skip_bits(cfg, pcfg, 1)
    scores = modfam.symbol_scores(CF32(out.symbols.re.reshape(-1),
                                       out.symbols.im.reshape(-1)), mod,
                                  cfg.agc_target)[skip // bps:]
    jscores = jm.symbol_scores(JCF32(jout.symbols.re.reshape(-1),
                                     jout.symbols.im.reshape(-1)), jmod,
                               jc.agc_target)[skip // bps:]
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=1e-4)
    kw = dict(max_lag=sync.default_max_lag(pcfg), probe_frames=8, soft=True,
              lag_step=sync._mod_geometry(cfg.modulation)[2])
    rows = sync.rotated_streams(None, cfg.modulation, soft=scores)
    s = sync.find_sync_streams(pcfg, rows, **kw)
    js = jsync.find_sync_streams(
        jpcfg, jsync.rotated_streams(None, cfg.modulation, soft=jscores), **kw)
    assert (int(s.rotation), int(s.bit_lag), int(s.score)) == \
        (int(js.rotation), int(js.bit_lag), int(js.score))
    navail = (rows.shape[1] - int(s.bit_lag)) // pcfg.frame_bits
    rx = sync.extract_packets_soft_tracked_mod(pcfg, scores, s, navail,
                                               cfg.modulation)
    _packets_alike(rx, jsync.extract_packets_soft_tracked_mod(
        jpcfg, jscores, js, navail, cfg.modulation))
    one = sync.extract_packets_soft_mod(pcfg, scores, s, navail,
                                        cfg.modulation)
    np.testing.assert_array_equal(one.crc_ok.numpy()[:4], rx.crc_ok.numpy()[:4])
    nok, n = _check_payloads(rx, payload[0])
    assert nok >= 0.75 * n, (nok, n)
