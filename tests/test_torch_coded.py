"""The torch port's coded link against the JAX package (CPU): coded
framing, the soft sync hunt, the tracked soft extractor, the link
metrics, and the coded slice as a whole:

    assemble_packet(fec) -> modem frames with filler -> TX -> PCM -> AWGN
    -> rx_stream -> demod_soft -> rotate_soft x 4 ->
    find_sync_streams(soft=True, probe_frames=8) ->
    extract_packets_soft_tracked

Tolerances: framing, sync (rotation, lag, score) and CRC verdicts are
decisions and must be equal; the metrics are float reductions held within
1e-5.  The slice runs at a small size (2 channels, a 600-bit lag window),
since the conv sync hunt decodes every (rotation x lag x probe) hypothesis.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg, rx_init as j_rx_init, tx_init as j_tx_init
from qpsk_tpu import metrics as jmetrics
from qpsk_tpu import sync as jsync
from qpsk_tpu.modem import rx_stream as j_rx_stream, tx_stream as j_tx_stream
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu.ops.modmap import demod_soft as j_demod_soft
from qpsk_tpu.packet import frame as jframe
from qpsk_tpu_torch import ModemConfig, metrics, rx_init, rx_stream, sync
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.modmap import demod_soft
from qpsk_tpu_torch.packet import frame

torch.set_num_threads(2)

KINDS = ["conv", "ldpc"]


def _cfgs(kind, payload_bytes=30):
    return (frame.PacketConfig(payload_bytes=payload_bytes, fec=kind),
            jframe.PacketConfig(payload_bytes=payload_bytes, fec=kind))


def _same_rx(rx, jrx):
    np.testing.assert_array_equal(rx.crc_ok.numpy(), np.asarray(jrx.crc_ok))
    np.testing.assert_array_equal(rx.payload_bits.numpy(),
                                  np.asarray(jrx.payload_bits))


def _same_sync(s, js):
    assert (int(s.rotation), int(s.bit_lag), int(s.score)) == \
        (int(js.rotation), int(js.bit_lag), int(js.score))


@pytest.mark.parametrize("kind", KINDS)
def test_coded_packets_match_jax(kind):
    pcfg, jpcfg = _cfgs(kind)
    assert pcfg.frame_bits == jpcfg.frame_bits == {"conv": 524, "ldpc": 512}[kind]
    assert pcfg.fec_kind == jpcfg.fec_kind == kind
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 2, (6, 240), dtype=np.int32)
    chan = frame.assemble_packet(pcfg, torch.from_numpy(payload))
    jchan = np.asarray(jframe.assemble_packet(jpcfg, payload))
    np.testing.assert_array_equal(chan.numpy(), jchan)
    np.testing.assert_array_equal(frame.unwrap_bits(pcfg, chan).numpy(),
                                  np.asarray(jframe.unwrap_bits(jpcfg, jchan)))

    # hard input: a 12-bit channel burst in every packet, 40 flips in one
    bad = jchan.copy()
    bad[:, 100:112] ^= 1
    bad[4, rng.choice(pcfg.frame_bits, 40, replace=False)] ^= 1
    rx = frame.disassemble_packet(pcfg, torch.from_numpy(bad))
    _same_rx(rx, jframe.disassemble_packet(jpcfg, bad))
    assert bool(rx.crc_ok[:4].all())

    # soft input: noisy LLRs, one packet buried in noise
    llrs = ((1.0 - 2.0 * jchan) + rng.normal(0, 0.7, jchan.shape)).astype(np.float32)
    llrs[5] = rng.normal(0, 1.0, llrs.shape[1]).astype(np.float32)
    rx = frame.disassemble_packet_soft(pcfg, torch.from_numpy(llrs))
    _same_rx(rx, jframe.disassemble_packet_soft(jpcfg, jnp.asarray(llrs)))
    assert not bool(rx.crc_ok[5])


def test_coded_config_and_unknown_fec():
    assert frame.PacketConfig(fec=True).fec_kind == "conv"
    assert frame.PacketConfig(fec=True).frame_bits == 524
    assert frame.PacketConfig(fec="ldpc").ldpc_code().n == 512
    assert frame.PacketConfig().fec_kind is None
    with pytest.raises(ValueError):
        frame.PacketConfig(fec="turbo")


def test_rotate_soft_matches_jax():
    llrs = np.random.default_rng(0).normal(size=(3, 40)).astype(np.float32)
    for r in range(4):
        want = np.asarray(jsync.rotate_soft(jnp.asarray(llrs), r))
        np.testing.assert_array_equal(sync.rotate_soft(torch.from_numpy(llrs), r).numpy(), want)
        np.testing.assert_array_equal(
            sync.rotate_soft(torch.from_numpy(llrs), torch.tensor(r)).numpy(), want)
    # the hard twin: the signs of the rotated LLRs are the rotated bits
    bits = (llrs < 0).astype(np.int32)
    for r in range(4):
        np.testing.assert_array_equal(
            (sync.rotate_soft(torch.from_numpy(llrs), r) < 0).to(torch.int32).numpy(),
            sync.rotate_dibits(torch.from_numpy(bits), r).numpy())


def _coded_stream(kind, npkt, lead, rot, sigma, seed, payload_bytes=8):
    """A 1-D coded LLR stream: ``lead`` random LLRs, then ``npkt`` noisy
    packets, seen under the inverse of rotation hypothesis ``rot``."""
    pcfg, jpcfg = _cfgs(kind, payload_bytes)
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (npkt, 8 * payload_bytes), dtype=np.int32)
    chan = np.asarray(jframe.assemble_packet(jpcfg, payload)).reshape(-1)
    llrs = (1.0 - 2.0 * chan) + rng.normal(0, sigma, chan.shape)
    llrs = np.concatenate([rng.normal(0, 1.0, lead), llrs]).astype(np.float32)
    llrs = np.array(jsync.rotate_soft(jnp.asarray(llrs), (4 - rot) % 4))
    return pcfg, jpcfg, payload, llrs


@pytest.mark.parametrize("kind", KINDS)
def test_soft_sync_matches_jax(kind):
    # LDPC frames pass the syndrome test below 0.35*m violated checks,
    # which needs a cleaner channel than the conv decode
    pcfg, jpcfg, _, llrs = _coded_stream(kind, 12, lead=138, rot=3,
                                         sigma={"conv": 0.8, "ldpc": 0.6}[kind],
                                         seed=1)
    rows = torch.stack([sync.rotate_soft(torch.from_numpy(llrs), r) for r in range(4)])
    jrows = jnp.stack([jsync.rotate_soft(jnp.asarray(llrs), r) for r in range(4)])
    s = sync.find_sync_streams(pcfg, rows, max_lag=400, probe_frames=8, soft=True)
    js = jsync.find_sync_streams(jpcfg, jrows, max_lag=400, probe_frames=8, soft=True)
    _same_sync(s, js)
    assert (int(s.rotation), int(s.bit_lag)) == (3, 138) and int(s.score) >= 6
    # the hard hunt over the LLR signs finds the same packets
    bits = torch.from_numpy((llrs < 0).astype(np.int32))
    h = sync.find_sync(pcfg, bits, max_lag=400, probe_frames=8)
    _same_sync(h, jsync.find_sync(jpcfg, jnp.asarray(bits.numpy()), max_lag=400,
                                  probe_frames=8))
    assert int(h.rotation) == 3 and (int(h.bit_lag) - 138) % pcfg.frame_bits == 0


@pytest.mark.parametrize("kind", KINDS)
def test_soft_tracked_recovers_cycle_slip(kind):
    """A synthetic +90 degree Costas cycle slip halfway through a clean
    coded LLR stream: the fixed-rotation extractor loses every packet after
    it, the tracked one decodes all of them and adopts rotation 1, as the
    JAX package's does."""
    pcfg, jpcfg = _cfgs(kind)
    rng = np.random.default_rng(5)
    npkt = 10
    payload = rng.integers(0, 2, (npkt, 240), dtype=np.int32)
    clean = 1.0 - 2.0 * np.asarray(jframe.assemble_packet(jpcfg, payload), np.float32)
    slipped = np.concatenate([clean[:npkt // 2].ravel(),
                              np.asarray(jsync.rotate_soft(
                                  jnp.asarray(clean[npkt // 2:].ravel()), 3))])
    t = torch.from_numpy(slipped)
    s = sync.SyncResult(rotation=torch.tensor(0), bit_lag=torch.tensor(0),
                        score=torch.tensor(4))
    js = jsync.SyncResult(rotation=jnp.int32(0), bit_lag=jnp.int32(0),
                          score=jnp.int32(4))
    fixed = sync.extract_packets_soft(pcfg, t, s, npkt)
    _same_rx(fixed, jsync.extract_packets_soft(jpcfg, jnp.asarray(slipped), js, npkt))
    assert int(fixed.crc_ok.sum()) == npkt // 2
    tracked = sync.extract_packets_soft_tracked(pcfg, t, s, npkt)
    jtracked = jsync.extract_packets_soft_tracked(jpcfg, jnp.asarray(slipped), js, npkt)
    for a, b in zip(tracked, jtracked):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(tracked.crc_ok.all())
    np.testing.assert_array_equal(tracked.payload_bits.numpy(), payload)
    assert int(tracked.rotation[-1]) == 1


def test_hard_tracked_recovers_symbol_slip():
    """A dropped symbol (2 bits) halfway through a hard conv-coded stream:
    with ``max_slip=1`` the tracked extractor walks the lag by one symbol,
    as the JAX package's does."""
    pcfg, jpcfg = _cfgs("conv", 8)
    rng = np.random.default_rng(6)
    npkt = 8
    payload = rng.integers(0, 2, (npkt, 64), dtype=np.int32)
    chan = np.asarray(jframe.assemble_packet(jpcfg, payload)).ravel()
    half = npkt // 2 * pcfg.frame_bits
    bits = np.concatenate([chan[:half], chan[half + 2:],
                           rng.integers(0, 2, 8, dtype=np.int32)])
    s = sync.SyncResult(rotation=torch.tensor(0), bit_lag=torch.tensor(0),
                        score=torch.tensor(4))
    js = jsync.SyncResult(rotation=jnp.int32(0), bit_lag=jnp.int32(0),
                          score=jnp.int32(4))
    got = sync.extract_packets_tracked(pcfg, torch.from_numpy(bits), s, npkt,
                                       max_slip=1)
    want = jsync.extract_packets_tracked(jpcfg, jnp.asarray(bits), js, npkt,
                                         max_slip=1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(got.crc_ok.all()) and int(got.shift[-1]) == -2


def test_metrics_match_jax():
    rng = np.random.default_rng(7)
    re = rng.normal(0.7, 0.3, (3, 500)).astype(np.float32)
    im = rng.normal(-0.7, 0.3, (3, 500)).astype(np.float32)
    sym, jsym = CF32(torch.from_numpy(re), torch.from_numpy(im)), JCF32(re, im)
    for scale in (1.0, 2.5):
        np.testing.assert_array_equal(
            demod_soft(sym, scale).numpy(), np.asarray(j_demod_soft(jsym, scale)))
    np.testing.assert_allclose(metrics.snr_estimate_db(sym).numpy(),
                               np.asarray(jmetrics.snr_estimate_db(jsym)), atol=1e-5)
    for normalize in (True, False):
        got = metrics.evm(sym, normalize)
        want = jmetrics.evm(jsym, normalize)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    a = rng.integers(0, 2, (4, 300), dtype=np.int32)
    b = a ^ (rng.random(a.shape) < 0.1)
    np.testing.assert_allclose(metrics.ber(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jmetrics.ber(a, b)), atol=1e-5)
    ok = rng.random((4, 37)) < 0.8
    np.testing.assert_allclose(metrics.per(torch.from_numpy(ok)).numpy(),
                               np.asarray(jmetrics.per(jnp.asarray(ok))), atol=1e-5)


C, NFRAMES, SKIP_BITS, MAX_LAG = 2, 44, 8 * 256, 600


@pytest.mark.parametrize("kind", KINDS)
def test_coded_slice_matches_jax(kind):
    """The same PCM (JAX TX at +50 Hz, numpy AWGN at 6 dB) through each
    package's receive chain gives the same sync and the same CRC verdicts
    and payloads, and every passing payload is one that was sent."""
    pcfg, jpcfg = _cfgs(kind)
    cfg, jcfg = ModemConfig(), JCfg()
    rng = np.random.default_rng({"conv": 21, "ldpc": 22}[kind])
    npkt = NFRAMES * 256 // pcfg.frame_bits
    payload = rng.integers(0, 2, (C, npkt, 240), dtype=np.int32)
    chan = np.asarray(jframe.assemble_packet(jpcfg, payload)).reshape(C, -1)
    filler = rng.integers(0, 2, (C, NFRAMES * 256 - chan.shape[1]), dtype=np.int32)
    frames = np.concatenate([chan, filler], axis=1).reshape(C, NFRAMES, 256)
    _, pcm = j_tx_stream(jcfg, j_tx_init(jcfg, batch_shape=(C,)), frames,
                         tx_offset_hz=50.0)
    x = np.asarray(pcm).astype(np.float64)
    power = ((x / 16384.0) ** 2).mean()
    sigma = np.sqrt(power / 10 ** 0.6) * 16384.0
    pcm = np.clip(np.round(x + rng.normal(size=x.shape) * sigma),
                  -32768, 32767).astype(np.int16)

    _, out = rx_stream(cfg, rx_init(cfg, (C,), device="cpu"), torch.from_numpy(pcm))
    _, jout = j_rx_stream(jcfg, j_rx_init(jcfg, batch_shape=(C,)), pcm)
    for ch in range(C):
        llrs = demod_soft(CF32(out.symbols.re[ch].reshape(-1),
                               out.symbols.im[ch].reshape(-1)))[SKIP_BITS:]
        jllrs = j_demod_soft(JCF32(jout.symbols.re[ch].reshape(-1),
                                   jout.symbols.im[ch].reshape(-1)))[SKIP_BITS:]
        s = sync.find_sync_streams(
            pcfg, torch.stack([sync.rotate_soft(llrs, r) for r in range(4)]),
            max_lag=MAX_LAG, probe_frames=8, soft=True)
        js = jsync.find_sync_streams(
            jpcfg, jnp.stack([jsync.rotate_soft(jllrs, r) for r in range(4)]),
            max_lag=MAX_LAG, probe_frames=8, soft=True)
        _same_sync(s, js)
        # at 6 dB the LDPC syndrome metric passes about half the probes
        assert int(s.score) >= {"conv": 6, "ldpc": 3}[kind]
        navail = (llrs.numel() - int(s.bit_lag)) // pcfg.frame_bits
        rx = sync.extract_packets_soft_tracked(pcfg, llrs, s, navail)
        jrx = jsync.extract_packets_soft_tracked(jpcfg, jllrs, js, navail)
        for a, b in zip(rx, jrx):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        ok = rx.crc_ok.numpy()
        assert ok.mean() >= 0.75, ok
        sent = {p.tobytes() for p in payload[ch]}
        assert all(rx.payload_bits[i].numpy().tobytes() in sent
                   for i in np.flatnonzero(ok))
