"""The port's block-parallel single-stream receive
(``qpsk_tpu_torch.parallel.rx_stream_blockparallel``) against the JAX
package's (``qpsk_tpu.parallel.rx_stream_blockparallel``) on CPU:

(a) the JAX suite's two tests (``tests/test_blockparallel.py``) through
    the port: 8 blocks decode the packets, one block degenerates to a
    warm-started serial decode;
(b) the same numpy PCM through both packages at 1, 4 and 8 blocks and at
    a window (overlap + block) that is not a multiple of 16: bits equal,
    the same CRC-passing packets, derotated symbols within 1e-4 and each
    block's loop frequency within 1e-4 rad/symbol (1e-4 * rs / 2pi Hz);
(c) the refusals: a family modulation, a PCM that is not 2-D, a block
    count that does not divide the symbols.
"""

import math

import numpy as np
import pytest
import torch

from qpsk_tpu import ModemConfig as JCfg, tx_init as j_tx_init
from qpsk_tpu.modem import tx_stream as j_tx_stream
from qpsk_tpu.packet import PacketConfig as JPcfg, assemble_packet as j_assemble
from qpsk_tpu.parallel import rx_stream_blockparallel as j_blockparallel
from qpsk_tpu_torch import ModemConfig, tx_init, tx_stream
from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
from qpsk_tpu_torch.parallel import rx_stream_blockparallel
from qpsk_tpu_torch.sync import extract_packets_tracked, find_sync

torch.set_num_threads(2)

CFG, JC = ModemConfig(), JCfg()
PCFG = PacketConfig(payload_bytes=30)


def _make_stream(nframes, seed=0):
    """The JAX test's stimulus on the port: packets -> TX at +50 Hz."""
    rng = np.random.default_rng(seed)
    payload = torch.from_numpy(rng.integers(0, 2, (nframes, 240),
                                            dtype=np.int32))
    _, pcm = tx_stream(CFG, tx_init(CFG, device="cpu"),
                       assemble_packet(PCFG, payload), tx_offset_hz=50.0)
    return payload, pcm


def _jax_pcm(nframes, seed, snr_db):
    """JAX TX at +50 Hz, then numpy AWGN: int16 (nframes, 512)."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (nframes, 240), dtype=np.int32)
    _, pcm = j_tx_stream(JC, j_tx_init(JC), j_assemble(JPcfg(payload_bytes=30),
                                                       payload),
                         tx_offset_hz=50.0)
    x = np.asarray(pcm).astype(np.float64)
    sigma = np.sqrt((x ** 2).mean() / 10.0 ** (snr_db / 10.0))
    return np.clip(np.round(x + rng.normal(size=x.shape) * sigma),
                   -32768, 32767).astype(np.int16)


def _packets(bits):
    sync = find_sync(PCFG, bits, max_lag=600, probe_frames=4)
    navail = (bits.shape[0] - int(sync.bit_lag)) // PCFG.frame_bits
    return sync, navail, extract_packets_tracked(PCFG, bits, sync, navail)


def test_blockparallel_decodes_packets():
    nframes = 64
    payload, pcm = _make_stream(nframes)
    _, bits, fhz = rx_stream_blockparallel(CFG, pcm, nblocks=8,
                                           overlap_sym=64)
    assert bits.shape == (nframes * 256,) and bits.dtype == torch.int32
    np.testing.assert_allclose(fhz.numpy(), 50.0, atol=10.0)
    sync, navail, rx = _packets(bits)
    assert int(sync.score) >= 3
    ok = rx.crc_ok.numpy()
    got, want = rx.payload_bits.numpy(), payload.numpy()
    # block seams cost at most about a packet each (8 blocks)
    assert ok.sum() >= navail - 10, (int(ok.sum()), navail)
    exact = sum(any(np.array_equal(got[i], want[k]) for k in range(nframes))
                for i in range(navail) if ok[i])
    assert exact == int(ok.sum())


def test_blockparallel_single_block_matches_serialish():
    """nblocks=1 is a warm-started serial decode."""
    _, pcm = _make_stream(16, seed=1)
    _, bits, fhz = rx_stream_blockparallel(CFG, pcm, nblocks=1)
    assert fhz.shape == (1,) and abs(float(fhz[0]) - 50.0) < 10.0
    sync = find_sync(PCFG, bits, max_lag=600, probe_frames=3)
    assert int(sync.score) >= 2


@pytest.mark.parametrize("nframes, nblocks, overlap, snr_db", [
    (16, 1, 64, 10.0),
    (32, 4, 64, 10.0),
    (32, 8, 64, 60.0),
    # a window of 37 + 128 = 165 symbols, not a multiple of 16
    (16, 16, 37, 10.0),
])
def test_blockparallel_matches_jax(nframes, nblocks, overlap, snr_db):
    pcm = _jax_pcm(nframes, seed=nblocks + nframes, snr_db=snr_db)
    jsym, jbits, jhz = j_blockparallel(JC, pcm, nblocks, overlap_sym=overlap)
    sym, bits, hz = rx_stream_blockparallel(CFG, torch.from_numpy(pcm),
                                            nblocks, overlap_sym=overlap)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_allclose(sym.re.numpy(), np.asarray(jsym.re), atol=1e-4)
    np.testing.assert_allclose(sym.im.numpy(), np.asarray(jsym.im), atol=1e-4)
    assert hz.shape == (nblocks,)
    np.testing.assert_allclose(hz.numpy(), np.asarray(jhz),
                               atol=1e-4 * CFG.rs / (2.0 * math.pi))
    np.testing.assert_allclose(hz.numpy(), 50.0, atol=10.0)
    # the same packets pass CRC on both packages' bits
    _, navail, rx = _packets(bits)
    _, jnavail, jrx = _packets(torch.from_numpy(np.asarray(jbits)))
    assert navail == jnavail
    np.testing.assert_array_equal(rx.crc_ok.numpy(), jrx.crc_ok.numpy())
    ok = rx.crc_ok.numpy()
    np.testing.assert_array_equal(rx.payload_bits.numpy()[ok],
                                  jrx.payload_bits.numpy()[ok])
    assert ok.sum() >= navail - nblocks - 2


def test_blockparallel_refusals():
    pcm = torch.zeros((4, 512), dtype=torch.int16)
    with pytest.raises(ValueError, match="QPSK-only"):
        rx_stream_blockparallel(ModemConfig(modulation="8psk"), pcm, 4)
    with pytest.raises(ValueError, match="single stream"):
        rx_stream_blockparallel(CFG, pcm.reshape(2, 2, 512), 4)
    with pytest.raises(ValueError, match="must divide"):
        rx_stream_blockparallel(CFG, pcm, 3)
