"""The torch port's substrate against the JAX package: config, RRC design,
packet layer and the state converters (qpsk_tpu_torch vs qpsk_tpu, CPU)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import qpsk_tpu
from qpsk_tpu import config as jconfig
from qpsk_tpu.modem import rx_stream as j_rx_stream
from qpsk_tpu.ops import rrc as j_rrc
from qpsk_tpu.packet import frame as j_frame
from qpsk_tpu.packet.crc16 import crc16 as j_crc16
from qpsk_tpu.packet import interleave as j_il, scramble as j_sc
from qpsk_tpu_torch import config as tconfig
from qpsk_tpu_torch import state as tstate
from qpsk_tpu_torch.ops import rrc as t_rrc
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.packet import frame as t_frame
from qpsk_tpu_torch.packet.crc16 import crc16, crc16_np
from qpsk_tpu_torch.packet import interleave as t_il, scramble as t_sc

torch.set_num_threads(2)

GOLDEN = np.load("tests/golden/reference_vectors.npz")


def test_config_fields_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.ModemConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.ModemConfig)]
    assert jf == tf
    for jmake, tmake in ((jconfig.config_2400, tconfig.config_2400),
                         (jconfig.config_1200, tconfig.config_1200),
                         (jconfig.config_parity, tconfig.config_parity)):
        jc = jmake()
        assert dataclasses.asdict(tconfig.from_dict(dataclasses.asdict(jc))) \
            == dataclasses.asdict(jc) == dataclasses.asdict(tmake())
    for prop in ("cycles", "bits_per_symbol", "bits_per_frame",
                 "symbols_per_frame", "omega_center"):
        for mod in ("qpsk", "bpsk", "8psk", "16qam"):
            assert getattr(tconfig.ModemConfig(modulation=mod), prop) == \
                getattr(jconfig.ModemConfig(modulation=mod), prop)


@pytest.mark.parametrize("kwargs", [
    {"rs": 2300.0}, {"frame_size": 510}, {"ntaps": 126},
    {"timing_mode": "x"}, {"modulation": "x"},
    {"modulation": "bpsk", "differential": True},
    {"modulation": "8psk", "slicer": "reference"},
    {"modulation": "16qam", "loop_bw_track": 0.01}, {"nco_mode": "x"},
    {"slicer": "x"}, {"costas_impl": "x"}, {"frontend_impl": "x"},
    {"tx_impl": "x"}, {"fir_precision": "x"}, {"acquisition": "x"},
    {"loop_bw_track": 1.0}, {"eq_taps": -1}, {"agc_mu": 0.0},
    {"agc_target": 0.0}])
def test_config_validation_matches(kwargs):
    with pytest.raises(ValueError):
        jconfig.ModemConfig(**kwargs)
    with pytest.raises(ValueError):
        tconfig.ModemConfig(**kwargs)


def test_rrc_design_matches_jax_and_golden():
    cfg = tconfig.ModemConfig()
    taps = t_rrc.rrc_design(cfg.fs, cfg.rs, cfg.alpha, cfg.ntaps, cfg.gain)
    np.testing.assert_array_equal(
        taps, j_rrc.rrc_design(cfg.fs, cfg.rs, cfg.alpha, cfg.ntaps, cfg.gain))
    for alpha in (0.25, 0.5, 1.0):
        np.testing.assert_array_equal(
            t_rrc.rrc_design(9600.0, 2400.0, alpha, 127, 1.85),
            j_rrc.rrc_design(9600.0, 2400.0, alpha, 127, 1.85))
    # the golden impulse response of the filter, double GAIN included
    n = 2 * cfg.ntaps
    imp = torch.zeros(n)
    imp[0] = 1.0
    tmat = torch.from_numpy(t_rrc.toeplitz_taps(taps, n))
    y, _ = t_rrc.fir_block(CF32(imp, torch.zeros(n)),
                           t_rrc.fir_init_tail(cfg.ntaps), tmat, cfg.gain, n)
    np.testing.assert_allclose(y.re.numpy(), GOLDEN["impulse"][:, 0], atol=1e-6)
    np.testing.assert_allclose(y.im.numpy(), GOLDEN["impulse"][:, 1], atol=1e-6)


def test_crc16_known_answer():
    data = np.frombuffer(b"123456789", np.uint8)
    assert crc16_np(data) == 0x29B1
    assert int(crc16(torch.from_numpy(data.copy()))) == 0x29B1
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, (5, 30), dtype=np.uint8)
    np.testing.assert_array_equal(
        crc16(torch.from_numpy(batch)).numpy(),
        np.asarray(j_crc16(batch)).astype(np.int64))


@pytest.mark.parametrize("nbits", [256, 512, 1000])
def test_scrambler_and_interleaver_match(nbits):
    np.testing.assert_array_equal(t_sc.keystream(nbits), j_sc.keystream(nbits))
    np.testing.assert_array_equal(t_il.interleave_permutation(nbits),
                                  j_il.interleave_permutation(nbits))
    np.testing.assert_array_equal(t_il.deinterleave_permutation(nbits),
                                  j_il.deinterleave_permutation(nbits))
    bits = torch.from_numpy(np.random.default_rng(nbits).integers(
        0, 2, (3, nbits), dtype=np.int32))
    assert torch.equal(t_il.deinterleave_bits(t_il.interleave_bits(bits)), bits)
    assert torch.equal(t_sc.scramble_bits(t_sc.scramble_bits(bits)), bits)


def test_packets_match_jax():
    pcfg_t = t_frame.PacketConfig(payload_bytes=30)
    pcfg_j = j_frame.PacketConfig(payload_bytes=30)
    payload = np.random.default_rng(1).integers(0, 2, (6, 240), dtype=np.int32)
    tb = t_frame.assemble_packet(pcfg_t, torch.from_numpy(payload))
    jb = np.asarray(j_frame.assemble_packet(pcfg_j, payload))
    np.testing.assert_array_equal(tb.numpy(), jb)
    bad = jb.copy()
    bad[2, 17] ^= 1
    rx_t = t_frame.disassemble_packet(pcfg_t, torch.from_numpy(bad))
    rx_j = j_frame.disassemble_packet(pcfg_j, bad)
    np.testing.assert_array_equal(rx_t.crc_ok.numpy(), np.asarray(rx_j.crc_ok))
    np.testing.assert_array_equal(rx_t.payload_bits.numpy(),
                                  np.asarray(rx_j.payload_bits))
    assert rx_t.crc_ok.sum() == 5
    # the coded configurations build; an unknown fec raises
    for fec in (True, "conv", "ldpc"):
        assert t_frame.PacketConfig(fec=fec).frame_bits == \
            j_frame.PacketConfig(fec=fec).frame_bits
    with pytest.raises(ValueError):
        t_frame.PacketConfig(fec="turbo")


def _round_trip(jst):
    """JAX state -> port (CPU) -> numpy -> port: every leaf survives."""
    tree = jax.tree.map(np.asarray, jst)
    st = tstate.from_numpy(tree, device="cpu")
    back = tstate.to_numpy(st)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(tuple(back)),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    again = tstate.from_numpy(back, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(tuple(again), is_leaf=torch.is_tensor),
        jax.tree.leaves(tuple(st), is_leaf=torch.is_tensor), strict=True))
    return st


def test_state_round_trip_from_jax():
    cfg = jconfig.ModemConfig()
    c = 4
    pcm = np.random.default_rng(2).integers(-9000, 9000, (c, 2, 512),
                                            dtype=np.int16)
    jst, _ = j_rx_stream(cfg, qpsk_tpu.rx_init(cfg, batch_shape=(c,)), pcm)
    assert isinstance(_round_trip(jst), tstate.RxState)
    tx = tstate.from_numpy(jax.tree.map(np.asarray, qpsk_tpu.tx_init(cfg, (c,))),
                           device="cpu")
    assert isinstance(tx, tstate.TxState) and tx.fir_tail.re.shape == (c, 126)
    # the gear-shift, equalizer and AGC states after a call, and as built
    opts = jconfig.ModemConfig(loop_bw_track=0.03, eq_taps=5, agc=True)
    jst, _ = j_rx_stream(opts, qpsk_tpu.rx_init(opts, batch_shape=(c,)), pcm)
    st = _round_trip(jst)
    assert st.costas.lev.shape == (c,) and st.agc.shape == (c,)
    w, hist = st.eq
    assert w.re.shape == (c, 5) and hist.im.shape == (c, 4)
    built = tstate.rx_init(tconfig.from_dict(dataclasses.asdict(opts)), (c,),
                           device="cpu")
    for a, b in zip(jax.tree.leaves(tuple(tstate.to_numpy(built))),
                    jax.tree.leaves(jax.tree.map(
                        np.asarray, qpsk_tpu.rx_init(opts, batch_shape=(c,)))),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    # the DQPSK and tracking states after a call round-trip too, DQPSK's
    # TX phase index as int32
    for fields in ({"differential": True}, {"timing_mode": "tracking"}):
        jcfg = jconfig.ModemConfig(**fields)
        jst, _ = j_rx_stream(jcfg, qpsk_tpu.rx_init(jcfg, batch_shape=(c,)),
                             pcm)
        st = _round_trip(jst)
        assert (st.diff_prev is None) != (st.timing is None)
    diff = jconfig.ModemConfig(differential=True)
    jtx, _ = qpsk_tpu.tx_stream(diff, qpsk_tpu.tx_init(diff, (c,)),
                                np.ones((c, 2, 256), np.int32))
    tx = tstate.from_numpy(jax.tree.map(np.asarray, jtx), device="cpu")
    assert tx.diff_phase.dtype == torch.int32
    np.testing.assert_array_equal(tstate.to_numpy(tx).diff_phase,
                                  np.asarray(jtx.diff_phase))
