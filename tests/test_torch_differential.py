"""DQPSK in the torch port (``ops/differential.py`` and the differential
wiring of ``modem`` and ``runtime``) against the JAX package on CPU:

(a) the encode / decode algebra: equal to JAX on the same bits and
    symbols, a round trip under any k*90-degree rotation, carries across
    chunks equal to one call, a cycle slip costing one symbol;
(b) ``tx_stream`` equal to the chained ``tx_bits_frame`` calls and within
    2 LSB of JAX, the phase index carried as int32;
(c) ``rx_stream`` on the same PCM as JAX: equal timing decisions and bits
    (except within 1e-3 of a decision boundary), two chained calls equal
    to one; a torch loopback that syncs at rotation 0;
(d) the runtime: ``StreamModulator`` carries the phase index across
    pushes and checkpoints of either package; DQPSK + ``fec="conv"``
    through ``StreamDemodulator``, which decodes hard input as the JAX
    package's does (``test_torch_runtime_coded.py`` holds it to the JAX
    receiver).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg
from qpsk_tpu.modem import rx_stream as j_rx_stream, tx_stream as j_tx_stream
from qpsk_tpu.ops import differential as jd
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu.state import rx_init as j_rx_init, tx_init as j_tx_init
from qpsk_tpu_torch import (ModemConfig, StreamDemodulator, StreamModulator,
                            rx_init, rx_stream, tx_bits_frame, tx_init,
                            tx_stream)
from qpsk_tpu_torch.channel import awgn_pcm
from qpsk_tpu_torch.ops import differential as td
from qpsk_tpu_torch.ops.cplx import CF32, cmul
from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
from qpsk_tpu_torch.sync import extract_packets, find_sync

torch.set_num_threads(2)

CFG, JC = ModemConfig(differential=True), JCfg(differential=True)


def _rot(sym: CF32, theta) -> CF32:
    theta = torch.as_tensor(theta, dtype=torch.float32)
    return cmul(sym, CF32(torch.cos(theta), torch.sin(theta)))


def _bits(seed, shape):
    return np.random.default_rng(seed).integers(0, 2, shape, dtype=np.int32)


# --- (a) the algebra --------------------------------------------------------

def test_encode_decode_match_jax():
    """``diff_encode_bits`` gives JAX's symbols and carry (int32) from a
    non-zero carry; ``diff_decode_symbols`` JAX's bits and carry on noisy
    symbols."""
    bits = _bits(0, (3, 256))
    carry = np.array([0, 1, 3], np.int32)
    js, jc = jd.diff_encode_bits(jnp.asarray(bits), jnp.asarray(carry))
    ts, tc = td.diff_encode_bits(torch.from_numpy(bits), torch.from_numpy(carry))
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(ts.re.numpy(), np.asarray(js.re))
    np.testing.assert_array_equal(ts.im.numpy(), np.asarray(js.im))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    rng = np.random.default_rng(1)
    re, im = (rng.normal(size=(3, 128)).astype(np.float32) for _ in range(2))
    cr, ci = (rng.normal(size=(3,)).astype(np.float32) for _ in range(2))
    jb, jn = jd.diff_decode_symbols(JCF32(jnp.asarray(re), jnp.asarray(im)),
                                    JCF32(jnp.asarray(cr), jnp.asarray(ci)))
    tb, tn = td.diff_decode_symbols(CF32(torch.from_numpy(re), torch.from_numpy(im)),
                                    CF32(torch.from_numpy(cr), torch.from_numpy(ci)))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tn.re.numpy(), np.asarray(jn.re))
    z = JCF32(jnp.asarray(re), jnp.asarray(im))
    np.testing.assert_array_equal(
        td.quantize_turns(CF32(torch.from_numpy(re), torch.from_numpy(im))).numpy(),
        np.asarray(jd.quantize_turns(z)))


@pytest.mark.parametrize("k", range(4))
def test_roundtrip_any_rotation(k):
    """encode -> rotate by 45 + k*90 degrees -> decode recovers every bit
    but the first symbol's."""
    bits = torch.from_numpy(_bits(2, (512,)))
    sym, _ = td.diff_encode_bits(bits, td.diff_tx_init(device="cpu"))
    got, _ = td.diff_decode_symbols(_rot(sym, math.pi / 4 + k * math.pi / 2),
                                    td.diff_rx_init(device="cpu"))
    assert torch.equal(got[2:], bits[2:])


def test_streaming_carry_matches_oneshot():
    bits = torch.from_numpy(_bits(3, (400,)))
    sym, c_full = td.diff_encode_bits(bits, td.diff_tx_init(device="cpu"))
    s1, c1 = td.diff_encode_bits(bits[:200], td.diff_tx_init(device="cpu"))
    s2, c2 = td.diff_encode_bits(bits[200:], c1)
    assert torch.equal(sym.re, torch.cat([s1.re, s2.re]))
    assert int(c_full) == int(c2)
    rx = _rot(sym, math.pi / 4)
    d_full, n_full = td.diff_decode_symbols(rx, td.diff_rx_init(device="cpu"))
    d1, carry = td.diff_decode_symbols(CF32(rx.re[:100], rx.im[:100]),
                                       td.diff_rx_init(device="cpu"))
    d2, n2 = td.diff_decode_symbols(CF32(rx.re[100:], rx.im[100:]), carry)
    assert torch.equal(d_full, torch.cat([d1, d2]))
    assert torch.equal(n_full.re, n2.re)


def test_cycle_slip_costs_one_symbol():
    """A 90-degree jump halfway corrupts at most the symbol spanning it."""
    bits = torch.from_numpy(_bits(4, (1000,)))
    sym, _ = td.diff_encode_bits(bits, td.diff_tx_init(device="cpu"))
    n = sym.re.shape[-1]
    theta = torch.where(torch.arange(n) < n // 2, math.pi / 4,
                        math.pi / 4 + math.pi / 2)
    got, _ = td.diff_decode_symbols(_rot(sym, theta),
                                    td.diff_rx_init(device="cpu"))
    errs = torch.nonzero(got[2:] != bits[2:]).flatten() + 2
    assert errs.numel() <= 2
    assert all(abs(int(e) - 500) <= 2 for e in errs)


# --- (b) TX -----------------------------------------------------------------

def test_tx_stream_matches_frame_chain_and_jax():
    """``tx_stream`` over 6 frames equals 6 chained ``tx_bits_frame`` calls
    within 1 LSB (the accumulator seams exactly), and JAX's ``tx_stream``
    within 2 LSB, with the same int32 phase index."""
    bits = _bits(5, (2, 6, 256))
    st_s, pcm_s = tx_stream(CFG, tx_init(CFG, (2,), device="cpu"),
                            torch.from_numpy(bits), tx_offset_hz=50.0)
    st_f, parts = tx_init(CFG, (2,), device="cpu"), []
    for f in range(6):
        st_f, p = tx_bits_frame(CFG, st_f, torch.from_numpy(bits[:, f]),
                                tx_offset_hz=50.0)
        parts.append(p)
    a, b = pcm_s.numpy().astype(np.int32), torch.stack(parts, 1).numpy()
    assert np.abs(a - b).max() <= 1
    assert st_s.diff_phase.dtype == torch.int32
    assert torch.equal(st_s.diff_phase, st_f.diff_phase)
    jst, jpcm = j_tx_stream(JC, j_tx_init(JC, batch_shape=(2,)), bits,
                            tx_offset_hz=50.0)
    assert np.abs(a - np.asarray(jpcm).astype(np.int32)).max() <= 2
    np.testing.assert_array_equal(st_s.diff_phase.numpy(),
                                  np.asarray(jst.diff_phase))


# --- (c) RX -----------------------------------------------------------------

@pytest.mark.parametrize("rs", [2400.0, 1200.0], ids=["2400", "1200"])
def test_rx_stream_matches_jax(rs):
    """The same PCM (JAX TX at +50 Hz, numpy AWGN at 10 dB) through JAX
    ``rx_stream`` and the port's: the time-major chain at 2400 baud, the
    composed chain at 1200; equal timing decisions and bits, the carried
    previous symbol close, and two chained calls equal to one."""
    cfg, jc = ModemConfig(differential=True, rs=rs), JCfg(differential=True, rs=rs)
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, (2, 6, cfg.bits_per_frame), dtype=np.int32)
    _, pcm = j_tx_stream(jc, j_tx_init(jc, batch_shape=(2,)), bits,
                         tx_offset_hz=50.0)
    x = np.asarray(pcm).astype(np.float64)
    pcm = np.clip(np.round(x + rng.normal(size=x.shape)
                           * np.sqrt((x ** 2).mean() / 10.0)),
                  -32768, 32767).astype(np.int16)
    jst, jout = j_rx_stream(jc, j_rx_init(jc, batch_shape=(2,)), pcm)
    st, out = rx_stream(cfg, rx_init(cfg, (2,), device="cpu"),
                        torch.from_numpy(pcm))
    np.testing.assert_array_equal(out.timing_index.numpy(),
                                  np.asarray(jout.timing_index))
    flips = out.bits.numpy() != np.asarray(jout.bits)
    sym = np.stack([out.symbols.re.numpy(), out.symbols.im.numpy()], -1)
    near = (np.abs(np.abs(sym[..., 0]) - np.abs(sym[..., 1])) < 1e-3
            ).repeat(2, axis=-1).reshape(flips.shape)
    assert near[flips].all(), int(flips.sum())
    np.testing.assert_allclose(st.diff_prev.re.numpy(),
                               np.asarray(jst.diff_prev.re), atol=1e-4)
    st1, o1 = rx_stream(cfg, rx_init(cfg, (2,), device="cpu"),
                        torch.from_numpy(pcm[:, :3]))
    st2, o2 = rx_stream(cfg, st1, torch.from_numpy(pcm[:, 3:]))
    assert torch.equal(torch.cat([o1.bits, o2.bits], 1), out.bits)
    assert torch.equal(st2.diff_prev.re, st.diff_prev.re)


def test_loopback_syncs_at_rotation_zero():
    """Packets -> DQPSK ``tx_stream`` at +50 Hz -> AWGN 10 dB -> ``rx_stream``
    -> ``find_sync``: rotation 0 (the decode is rotation-free), 4/4, and
    every packet passes CRC with its payload."""
    pcfg, nframes, skip = PacketConfig(payload_bytes=30), 24, 8
    gen = torch.Generator().manual_seed(7)
    payload = torch.randint(0, 2, (nframes, 240), generator=gen,
                            dtype=torch.int32)
    _, pcm = tx_stream(CFG, tx_init(CFG, device="cpu"),
                       assemble_packet(pcfg, payload), tx_offset_hz=50.0)
    power = float(((pcm.to(torch.float32) / CFG.pcm_scale) ** 2).mean())
    pcm = awgn_pcm(gen, pcm, 10.0, power)
    _, out = rx_stream(CFG, rx_init(CFG, device="cpu"), pcm)
    bits = out.bits.reshape(-1)[skip * pcfg.frame_bits:]
    sync = find_sync(pcfg, bits, max_lag=600, probe_frames=4)
    assert (int(sync.rotation), int(sync.score)) == (0, 4)
    navail = (bits.numel() - int(sync.bit_lag)) // pcfg.frame_bits
    rx = extract_packets(pcfg, bits, sync, navail)
    assert bool(rx.crc_ok.all()) and navail >= 12
    first = skip + int(sync.bit_lag) // pcfg.frame_bits
    assert any(torch.equal(rx.payload_bits[0], payload[f])
               for f in range(first - 2, first + 3))


# --- (d) the runtime --------------------------------------------------------

def test_stream_modulator_carries_the_phase_index(tmp_path):
    """DQPSK ``StreamModulator``: pushes of 4 + 8 packets equal one
    ``tx_stream`` over the 12 within 3 LSB (the phase index carried across
    the push), and JAX's modulator within 3 LSB; a checkpoint saved after
    the first push by either package resumes in the other with the int32
    phase index."""
    from qpsk_tpu.packet import PacketConfig as JPcfg
    from qpsk_tpu.runtime import StreamModulator as JMod
    pcfg = PacketConfig(payload_bytes=30)
    payload = _bits(9, (12, 240))
    mod = StreamModulator(CFG, pcfg, tx_offset_hz=50.0, device="cpu")
    pcm = np.concatenate([mod.push(payload[:4]), mod.push(payload[4:])])
    assert mod._state.diff_phase.dtype == torch.int32
    _, one = tx_stream(CFG, tx_init(CFG, device="cpu"),
                       assemble_packet(pcfg, torch.from_numpy(payload)),
                       tx_offset_hz=50.0)
    assert np.abs(pcm.astype(np.int32) - one.numpy().reshape(-1)).max() <= 3
    jmod = JMod(JC, JPcfg(payload_bytes=30), tx_offset_hz=50.0)
    jpcm = np.concatenate([jmod.push(payload[:4]), jmod.push(payload[4:])])
    assert np.abs(pcm.astype(np.int32) - jpcm).max() <= 3
    for first, second in (("torch", "jax"), ("jax", "torch")):
        make = {"torch": lambda: StreamModulator(CFG, pcfg, tx_offset_hz=50.0,
                                                 device="cpu"),
                "jax": lambda: JMod(JC, JPcfg(payload_bytes=30),
                                    tx_offset_hz=50.0)}
        m1 = make[first]()
        head = m1.push(payload[:4])
        path = str(tmp_path / f"{first}.npz")
        m1.save(path)
        m2 = make[second]()
        m2.load(path)
        if second == "torch":
            assert m2._state.diff_phase.dtype == torch.int32
        tail = m2.push(payload[4:])
        got = np.concatenate([head, tail]).astype(np.int32)
        assert np.abs(got - jpcm).max() <= 3



def test_dqpsk_conv_stream_demodulator_hard_input():
    """DQPSK + ``fec="conv"`` at 8 dB through the port's ``StreamModulator``
    and ``StreamDemodulator``: the receiver keeps no LLR buffer and decodes
    hard input, and every CRC-passing payload is one that was sent, most
    of them passing.  ``tests/test_torch_runtime_coded.py`` holds the same
    receiver to the JAX package's on the same chunks."""
    pcfg = PacketConfig(payload_bytes=30, fec="conv")
    rng = np.random.default_rng(8)
    payload = rng.integers(0, 2, (14, 240), dtype=np.int32)
    mod = StreamModulator(CFG, pcfg, tx_offset_hz=50.0, device="cpu")
    x = np.concatenate([mod.push(payload), mod.flush()]).astype(np.float64)
    pcm = np.clip(np.round(x + rng.normal(size=x.shape)
                           * np.sqrt((x ** 2).mean() / 10.0 ** 0.8)),
                  -32768, 32767).astype(np.int16)
    demod = StreamDemodulator(CFG, pcfg, device="cpu")
    pkts = demod.push(pcm) + demod.flush()
    assert not demod._use_soft and demod._llr_buf.shape[1] == 0
    assert demod.counters.synced
    sent = {p.tobytes() for p in payload}
    good = [p for p in pkts if p.crc_ok]
    assert all(p.payload.astype(np.int32).tobytes() in sent for p in good)
    assert len(good) >= 0.8 * len(pkts) > 0
