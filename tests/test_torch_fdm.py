"""The port's FDM filterbank and wideband receiver (``qpsk_tpu_torch.fdm``)
against the JAX package's (``qpsk_tpu.fdm``) on the same numpy-seeded
inputs, on CPU tensors: the band plan and the bank's host tables equal,
mux and demux within 1 LSB at 8 and 16 slots with chunked calls equal to
one call, the batched FDM loopback and ``FdmReceiver`` giving the JAX
package's packets on the wideband PCM the JAX package made noisy, and
``FdmReceiver`` checkpoints resuming in the other package."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg
from qpsk_tpu import fdm as jf
from qpsk_tpu import rx_init as j_rx_init
from qpsk_tpu import tx_init as j_tx_init
from qpsk_tpu.channel import awgn_pcm as j_awgn
from qpsk_tpu.modem import rx_stream as j_rx_stream
from qpsk_tpu.modem import tx_stream as j_tx_stream
from qpsk_tpu.packet import PacketConfig as JPcfg
from qpsk_tpu.packet import assemble_packet as j_assemble
from qpsk_tpu.sync import extract_packets_tracked as j_extract
from qpsk_tpu.sync import find_sync as j_find_sync
from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream
from qpsk_tpu_torch import fdm as tf
from qpsk_tpu_torch.packet import PacketConfig
from qpsk_tpu_torch.sync import (default_max_lag, extract_packets_tracked,
                                 find_sync)

torch.set_num_threads(2)


@pytest.mark.parametrize("nslots", [4, 8, 16, 2048])
def test_band_plan_and_bank_equal_jax(nslots):
    t, j = tf.FdmConfig(nslots=nslots), jf.FdmConfig(nslots=nslots)
    assert (t.nchan, t.wide_fs) == (j.nchan, j.wide_fs)
    assert [t.slot_center_hz(c, 1500.0) for c in range(t.nchan)] == \
        [j.slot_center_hz(c, 1500.0) for c in range(j.nchan)]
    assert tf.fdm_taps_per_branch(t) == jf.fdm_taps_per_branch(j)
    for a, b in zip(tf._bank(nslots, 16, 8.0), jf._bank(nslots, 16, 8.0)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    st = tf.fdm_init(t, device="cpu")
    js = jf.fdm_init(j)
    for a, b in zip(st, js):
        assert tuple(a.shape) == tuple(b.shape) and not a.any()


@pytest.mark.parametrize("nslots", [2, 5, 0])
def test_config_refusal_matches_jax(nslots):
    with pytest.raises(ValueError) as je:
        jf.FdmConfig(nslots=nslots)
    with pytest.raises(ValueError) as te:
        tf.FdmConfig(nslots=nslots)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("nslots", [8, 16])
def test_mux_demux_within_one_lsb_and_chunks_chain(nslots):
    """One call and three chained calls of each direction: the port within
    1 LSB of JAX, its chunked output equal to its one call."""
    fcfg, jcfg = tf.FdmConfig(nslots=nslots), jf.FdmConfig(nslots=nslots)
    rng = np.random.default_rng(nslots)
    n = 3 * 1024
    pcm = rng.integers(-9000, 9000, (fcfg.nchan, n)).astype(np.int16)
    wide = tf.fdm_mux(fcfg, torch.from_numpy(pcm)).numpy()
    jwide = np.asarray(jf.fdm_mux(jcfg, jnp.asarray(pcm)))
    assert wide.dtype == np.int16 and wide.shape == jwide.shape
    assert np.abs(wide.astype(np.int32) - jwide).max() <= 1
    st, outs = tf.fdm_init(fcfg, "cpu"), []
    for i in range(3):
        w, st = tf.fdm_mux_stream(
            fcfg, torch.from_numpy(pcm[:, i * 1024:(i + 1) * 1024]), st)
        outs.append(w.numpy())
    np.testing.assert_array_equal(np.concatenate(outs), wide)

    # demux the JAX package's wideband (with noise, so no sample sits on
    # a rounding edge by construction)
    noisy = np.clip(jwide + rng.normal(0, 300, jwide.shape), -32768,
                    32767).astype(np.int16)
    back = tf.fdm_demux(fcfg, torch.from_numpy(noisy)).numpy()
    jback = np.asarray(jf.fdm_demux(jcfg, jnp.asarray(noisy)))
    assert back.shape == jback.shape == (fcfg.nchan, n)
    assert np.abs(back.astype(np.int32) - jback).max() <= 1
    st, outs = tf.fdm_init(fcfg, "cpu"), []
    step = 1024 * nslots
    for i in range(3):
        p, st = tf.fdm_demux_stream(
            fcfg, torch.from_numpy(noisy[i * step:(i + 1) * step]), st)
        outs.append(p.numpy())
    np.testing.assert_array_equal(np.concatenate(outs, axis=1), back)


def _jax_wideband(nframes, seed, snr_db=18.0):
    """(payload (C, nframes, 240), noisy int16 wideband) from the JAX
    package: 3 channels of packets at +50 Hz, muxed at 8 slots, AWGN."""
    cfg, pcfg = JCfg(), JPcfg(payload_bytes=30)
    fcfg = jf.FdmConfig(nslots=8)
    c_n = fcfg.nchan
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (c_n, nframes, 240), dtype=np.int32)
    _, pcm = j_tx_stream(cfg, j_tx_init(cfg, batch_shape=(c_n,)),
                         j_assemble(pcfg, jnp.asarray(payload)),
                         tx_offset_hz=50.0)
    wide = jf.fdm_mux(fcfg, pcm.reshape(c_n, -1))
    sp = float(jnp.mean((wide.astype(jnp.float32) / cfg.pcm_scale) ** 2))
    wide = j_awgn(jax.random.key(seed), wide, snr_db=snr_db, signal_power=sp)
    return payload, np.array(wide)


def test_batched_fdm_loopback_same_packets_as_jax():
    """The JAX package's noisy wideband, demuxed and received on the
    channel axis by each package, then sync and tracked extraction per
    channel: the same rotation, lag, score and packets, every passing
    payload one that was sent."""
    payload, wide = _jax_wideband(24, seed=9, snr_db=16.0)
    fcfg, jcfg = tf.FdmConfig(nslots=8), jf.FdmConfig(nslots=8)
    cfg, pcfg = ModemConfig(), PacketConfig(payload_bytes=30)
    jc, jp = JCfg(), JPcfg(payload_bytes=30)
    c_n = fcfg.nchan

    back = tf.fdm_demux(fcfg, torch.from_numpy(wide))
    back = torch.cat([back, back.new_zeros((c_n, (-back.shape[-1]) % 512))],
                     dim=-1)
    _, out = rx_stream(cfg, rx_init(cfg, (c_n,), device="cpu"),
                       back.reshape(c_n, -1, 512))
    jback = jf.fdm_demux(jcfg, jnp.asarray(wide))
    jback = jnp.concatenate(
        [jback, jnp.zeros((c_n, (-jback.shape[-1]) % 512), jback.dtype)], -1)
    _, jout = j_rx_stream(jc, j_rx_init(jc, batch_shape=(c_n,)),
                          jback.reshape(c_n, -1, 512))
    skip = 8 * pcfg.frame_bits
    for c in range(c_n):
        b = out.bits[c].reshape(-1)[skip:]
        jb = jout.bits[c].ravel()[skip:]
        sync = find_sync(pcfg, b, max_lag=default_max_lag(pcfg))
        jsync = j_find_sync(jp, jb, max_lag=default_max_lag(pcfg))
        assert (int(sync.rotation), int(sync.bit_lag), int(sync.score)) == \
            (int(jsync.rotation), int(jsync.bit_lag), int(jsync.score))
        assert int(sync.score) >= 3
        nav = (b.numel() - int(sync.bit_lag)) // pcfg.frame_bits
        rx = extract_packets_tracked(pcfg, b, sync, nav)
        jrx = j_extract(jp, jb, jsync, nav)
        ok = rx.crc_ok.numpy()
        np.testing.assert_array_equal(ok, np.asarray(jrx.crc_ok))
        got = rx.payload_bits.numpy()
        np.testing.assert_array_equal(got[ok], np.asarray(jrx.payload_bits)
                                      [ok])
        sent = {p.tobytes() for p in payload[c]}
        assert ok.sum() >= nav - 1
        assert all(p.astype(np.int32).tobytes() in sent for p in got[ok])
        assert abs(float(out.freq_hz[c, -5:].mean()) - 50.0) < 3.0


def _push_all(rx, wide, sizes):
    got = [[] for _ in range(rx.fcfg.nchan)]
    pos = 0
    for sz in sizes:
        if pos >= wide.size:
            break
        for c, pkts in enumerate(rx.push(wide[pos:pos + int(sz)])):
            got[c].extend(pkts)
        pos += int(sz)
    return got, pos


def _same_packets(a, b):
    assert len(a) == len(b), (len(a), len(b))
    for pa, pb in zip(a, b):
        assert (bool(pa.crc_ok), int(pa.stream_index)) == (bool(pb.crc_ok),
                                                           int(pb.stream_index))
        np.testing.assert_array_equal(np.asarray(pa.payload), pb.payload)


def test_fdm_receiver_push_same_packets_as_jax():
    """``FdmReceiver.push`` over seeded chunks, then ``flush``: each
    channel emits the JAX receiver's packets and counters."""
    payload, wide = _jax_wideband(24, seed=5)
    sizes = np.random.default_rng(5).integers(1000, 30000, 200)
    jrx = jf.FdmReceiver(jf.FdmConfig(nslots=8), JCfg(),
                         JPcfg(payload_bytes=30), bucket_blocks=1024)
    trx = tf.FdmReceiver(tf.FdmConfig(nslots=8), ModemConfig(),
                         PacketConfig(payload_bytes=30), bucket_blocks=1024,
                         device="cpu")
    jgot, _ = _push_all(jrx, wide, sizes)
    tgot, _ = _push_all(trx, wide, sizes)
    for c, pkts in enumerate(jrx.flush()):
        jgot[c].extend(pkts)
    for c, pkts in enumerate(trx.flush()):
        tgot[c].extend(pkts)
    for c in range(3):
        _same_packets(jgot[c], tgot[c])
        ok = [p for p in tgot[c] if p.crc_ok]
        assert len(ok) >= 24 - 10
        sent = {p.tobytes() for p in payload[c]}
        assert all(p.payload.astype(np.int32).tobytes() in sent for p in ok)
        assert trx.demods[c].counters.synced
        assert abs(trx.demods[c].counters.detected_offset_hz
                   - jrx.demods[c].counters.detected_offset_hz) <= 0.05


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_fdm_receiver_checkpoint_crosses_packages(tmp_path, writer):
    """A wideband receiver saved mid-stream by one package resumes in the
    other: the resumed second half emits the packets of an uninterrupted
    run of the resuming package."""
    _, wide = _jax_wideband(20, seed=7)
    fj, ft = jf.FdmConfig(nslots=8), tf.FdmConfig(nslots=8)
    mk = {"jax": lambda: jf.FdmReceiver(fj, JCfg(), JPcfg(payload_bytes=30),
                                        bucket_blocks=1024),
          "torch": lambda: tf.FdmReceiver(ft, ModemConfig(),
                                          PacketConfig(payload_bytes=30),
                                          bucket_blocks=1024, device="cpu")}
    reader = "torch" if writer == "jax" else "jax"
    ref = mk[reader]()
    want = [list(p) for p in ref.push(wide)]
    for c, pkts in enumerate(ref.flush()):
        want[c].extend(pkts)

    cut = wide.size // 2 + 333
    first = mk[writer]()
    got = [list(p) for p in first.push(wide[:cut])]
    path = str(tmp_path / "fdm.npz")
    first.save(path)
    second = mk[reader]()
    second.load(path)
    for c, pkts in enumerate(second.push(wide[cut:])):
        got[c].extend(pkts)
    for c, pkts in enumerate(second.flush()):
        got[c].extend(pkts)
    for c in range(3):
        _same_packets(want[c], got[c])
        assert sum(bool(p.crc_ok) for p in got[c]) >= 10


def test_entry_points_need_a_card_or_cpu():
    """``fdm_init``, ``FdmReceiver`` and ``resample_init`` build on the
    card by default: without one they raise, never running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    from qpsk_tpu_torch.ops.resample import resample_init
    fcfg = tf.FdmConfig(nslots=8)
    for call in (lambda: tf.fdm_init(fcfg),
                 lambda: tf.FdmReceiver(fcfg, ModemConfig(),
                                        PacketConfig(payload_bytes=30)),
                 lambda: resample_init(5, 1)):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
