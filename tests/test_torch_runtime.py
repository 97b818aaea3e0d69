"""The port's streaming runtime (``qpsk_tpu_torch.runtime``) against the
JAX package's, uncoded QPSK: the same numpy-seeded PCM in the same chunk
sizes through ``qpsk_tpu.StreamDemodulator`` and the port's on CPU
tensors must give the same packets (payload bits, ``crc_ok``,
``stream_index``), equal integer counters, ``detected_offset_hz`` within
0.05 Hz and ``carrier_snr_db`` within 0.01 dB.  The cases are the JAX
suite's (``tests/test_runtime.py``, the symbol slip of
``tests/test_channel_impairments.py`` on power timing, the acquisition
epoch of ``tests/test_round5_fixes.py``), and ``StreamModulator``'s PCM
is held within 3 LSB of JAX's across chunked pushes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg
from qpsk_tpu.channel import clock_offset_pcm
from qpsk_tpu.packet import PacketConfig as JPcfg
from qpsk_tpu.runtime import StreamDemodulator as JDemod
from qpsk_tpu.runtime import StreamModulator as JMod
from qpsk_tpu_torch import ModemConfig, StreamDemodulator, StreamModulator
from qpsk_tpu_torch.packet import PacketConfig
from torch_runtime_common import (assert_same, chunks_of, make_pcm, ok_count,
                                  run_both)
from qpsk_tpu_torch.sync import default_max_lag

torch.set_num_threads(2)


def test_odd_chunks_match_jax():
    payload, pcm = make_pcm({}, 48, seed=0)
    jd, jp, td, tp = run_both({}, dict(payload_bytes=30), pcm,
                              chunks_of(pcm.size, 1, 100, 3000))
    assert_same(jd, jp, td, tp)
    assert ok_count(tp) >= 35 and td.counters.synced
    wanted = {p.tobytes() for p in payload}
    assert all(p.payload.tobytes() in wanted for p in tp if p.crc_ok)


def test_noisy_one_push_matches_jax():
    _, pcm = make_pcm({}, 48, seed=2, snr=10.0)
    jd, jp, td, tp = run_both({}, dict(payload_bytes=30), pcm)
    assert_same(jd, jp, td, tp)
    assert ok_count(tp) >= 30


def test_resync_after_gap_matches_jax():
    """A silence gap kills CRC: both receivers drop sync, re-arm and
    decode the second burst alike."""
    _, pcm1 = make_pcm({}, 32, seed=3)
    _, pcm2 = make_pcm({}, 32, seed=4)
    stream = np.concatenate([pcm1, np.zeros(4096, np.int16), pcm2])
    jd, jp, td, tp = run_both({}, dict(payload_bytes=30), stream,
                              chunks_of(stream.size, 5, 500, 6000),
                              resync_after=4)
    assert_same(jd, jp, td, tp)
    assert td.counters.resyncs >= 1


def test_squelch_dead_air_then_signal_matches_jax():
    """Squelch: noise-only buckets are dropped and never hunted, then the
    carrier opens the squelch; both receivers alike at every step."""
    rng = np.random.default_rng(7)
    noise = rng.normal(0.0, 600.0, 24 * 512).astype(np.int16)
    _, signal = make_pcm({}, 40, seed=8, snr=12.0)
    stream = np.concatenate([noise, signal])
    jd, jp, td, tp = run_both({}, dict(payload_bytes=30), stream,
                              [(0, noise.size), (noise.size, stream.size)],
                              squelch_db=5.0)
    assert_same(jd, jp, td, tp)
    assert td.counters.carrier_detect and ok_count(tp) >= 25


def test_squelch_holds_through_a_gap_matches_jax():
    """A 3 s dead-air gap inside a burst with ``squelch_db=6``: the epoch
    ends by CRC failures, the squelch closes on the gap, and both resync
    on the second burst."""
    _, pcm1 = make_pcm({}, 24, seed=12, snr=10.0)
    _, pcm2 = make_pcm({}, 24, seed=13, snr=10.0)
    gap = np.random.default_rng(14).normal(0.0, 300.0, 28800).astype(np.int16)
    stream = np.concatenate([pcm1, gap, pcm2])
    jd, jp, td, tp = run_both({}, dict(payload_bytes=30), stream,
                              chunks_of(stream.size, 15, 1, 9600),
                              squelch_db=6.0)
    assert_same(jd, jp, td, tp)
    assert td.counters.resyncs >= 1 and ok_count(tp) >= 20


@pytest.mark.parametrize("slip_track", [1, 0])
def test_symbol_slip_matches_jax(slip_track):
    """Sustained clock drift walks the power-timing phase across a symbol
    boundary (``tests/test_channel_impairments.py``'s stimulus; the port
    has no tracking timing, so the default loop rides it): with and
    without slip tracking both receivers emit the same packets."""
    _, pcm = make_pcm({}, 40, seed=21)
    warped = np.asarray(clock_offset_pcm(jnp.asarray(pcm), 60e-6,
                                         frac_offset=0.5)).astype(np.int16)
    jd, jp, td, tp = run_both({}, dict(payload_bytes=30), warped,
                              [(i, min(i + 3000, warped.size))
                               for i in range(0, warped.size, 3000)],
                              slip_track=slip_track)
    assert_same(jd, jp, td, tp)


@pytest.mark.parametrize("name,npkts", [("qpsk", 40), ("8psk", 40),
                                        ("8psk", 128)])
def test_modulator_chunks_match_jax(name, npkts):
    """Chunked pushes through both packages' ``StreamModulator``: PCM within
    3 LSB (the chained bound), the pending sub-symbol bits equal, and the
    port's chunked PCM within 3 LSB of its own one-push stream.  128 8PSK
    packets leave 2 bits pending: the flush sends one symbol, a call
    shorter than the filter's tail."""
    cfg, pcfg = ModemConfig(modulation=name), PacketConfig(payload_bytes=30)
    rng = np.random.default_rng(30)
    payload = rng.integers(0, 2, (npkts, 240), dtype=np.int32)
    cuts = [0, 1, 5, 6, 19, npkts]
    jm = JMod(JCfg(modulation=name), JPcfg(payload_bytes=30),
              tx_offset_hz=50.0)
    tm = StreamModulator(cfg, pcfg, tx_offset_hz=50.0, device="cpu")
    jpcm, tpcm = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        jpcm.append(jm.push(payload[a:b]))
        tpcm.append(tm.push(payload[a:b]))
        np.testing.assert_array_equal(jm._pend, tm._pend)
    jpcm.append(jm.flush())
    tpcm.append(tm.flush())
    jpcm, tpcm = np.concatenate(jpcm), np.concatenate(tpcm)
    assert jpcm.shape == tpcm.shape and tpcm.dtype == np.int16
    assert np.abs(jpcm.astype(np.int32) - tpcm.astype(np.int32)).max() <= 3
    one = StreamModulator(cfg, pcfg, tx_offset_hz=50.0, device="cpu")
    once = np.concatenate([one.push(payload), one.flush()])
    assert np.abs(once.astype(np.int32) - tpcm.astype(np.int32)).max() <= 3


def test_stale_bits_do_not_count_toward_rotation():
    """``tests/test_round5_fixes.py``'s acquisition epoch: hunt rejections
    of bits demodulated under the previous candidate do not advance
    ``_acq_bits``; fresh bits do.  Both packages count alike."""
    cfg, pcfg = ModemConfig(), PacketConfig(payload_bytes=8)
    jd = JDemod(JCfg(), JPcfg(payload_bytes=8))
    td = StreamDemodulator(cfg, pcfg, device="cpu")
    window = default_max_lag(pcfg)
    probe_bits = td.probe_frames * pcfg.frame_bits + 64
    n = td.sync_skip + 2 * window + probe_bits + 2
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (td._nrot, n)).astype(np.int32)
    more = rng.integers(0, 2, (td._nrot, window)).astype(np.int32)
    for d in (jd, td):
        d._bit_buf = bits.copy()
        d._acq_stale = n
        assert d._try_sync() is False
        assert d._acq_bits == 0
        d._bit_buf = np.concatenate([d._bit_buf, more], axis=1)
        assert d._try_sync() is False
    assert 0 < td._acq_bits <= window
    assert (td._acq_bits, td._acq_stale, td.sync_skip) == (
        jd._acq_bits, jd._acq_stale, jd.sync_skip)
    np.testing.assert_array_equal(td._bit_buf, jd._bit_buf)


def test_no_card_raises():
    """Without ``device="cpu"`` both classes ask for the card; on a
    machine without one they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        StreamDemodulator(ModemConfig(), PacketConfig())
    with pytest.raises((RuntimeError, AssertionError)):
        StreamModulator(ModemConfig(), PacketConfig())
