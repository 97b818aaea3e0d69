"""Checkpoints across the two packages: ``qpsk_tpu_torch.utils.checkpoint``
and the runtime's ``save`` / ``load`` against ``qpsk_tpu``'s.

A state or receiver saved by either package loads into the other: the
leaves go in the JAX leaf order (``state.flatten``), and the receiver's
arrays are the JAX package's.  A receiver resumed from the other
package's checkpoint continues the stream as the uninterrupted run does
(``tests/test_round4_fixes.py``'s resume, ``tests/test_round5_fixes.py``'s
acquisition epoch); a transmitter resumed so continues its PCM.
"""

import numpy as np
import pytest
import torch

import jax
from qpsk_tpu import ModemConfig as JCfg
from qpsk_tpu.modem import rx_stream as j_rx_stream
from qpsk_tpu.packet import PacketConfig as JPcfg
from qpsk_tpu.runtime import StreamDemodulator as JDemod
from qpsk_tpu.runtime import StreamModulator as JMod
from qpsk_tpu.state import rx_init as j_rx_init, tx_init as j_tx_init
from qpsk_tpu.utils import checkpoint as jck
from qpsk_tpu_torch import ModemConfig, StreamDemodulator, StreamModulator
from qpsk_tpu_torch.packet import PacketConfig
from qpsk_tpu_torch.state import flatten, from_numpy, rx_init, tx_init
from qpsk_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

_STATES = [{}, {"agc": True, "loop_bw_track": 0.03}, {"eq_taps": 5}]


def _jax_state(fields):
    """A JAX RxState after 4 frames of noise, so no leaf is its start."""
    jc = JCfg(**fields)
    pcm = np.random.default_rng(5).normal(0, 4000, (2, 4, 512)).astype(np.int16)
    st, _ = j_rx_stream(jc, j_rx_init(jc, batch_shape=(2,)), pcm)
    return st


@pytest.mark.parametrize("fields", _STATES,
                         ids=["default", "agc,gear", "eq_taps=5"])
def test_state_checkpoint_cross_loads(tmp_path, fields):
    """``save_state`` of either package loads into the other's
    ``load_state``, leaf for leaf, and the leaf order is the JAX one."""
    cfg = ModemConfig(**fields)
    jst = _jax_state(fields)
    want = from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jst)]
    tleaves = [x.numpy() for x in flatten(want)]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_array_equal(a, b)

    path = str(tmp_path / "jax.state")
    jck.save_state(path, jst)
    got = tck.load_state(path, rx_init(cfg, (2,), device="cpu"))
    for a, b in zip(flatten(got), flatten(want)):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        assert torch.equal(a, b)

    path = str(tmp_path / "torch.state")
    tck.save_state(path, want)
    back = jck.load_state(path, j_rx_init(JCfg(**fields), batch_shape=(2,)))
    for a, b in zip(jax.tree.leaves(back), jleaves):
        np.testing.assert_array_equal(np.asarray(a), b)

    txp = str(tmp_path / "tx.state")
    jck.save_state(txp, j_tx_init(JCfg(**fields), batch_shape=(3,)))
    tx = tck.load_state(txp, tx_init(cfg, (3,), device="cpu"))
    assert tx.nco_phase.re.shape == (3,) and float(tx.nco_phase.re[0]) == 1.0


@pytest.mark.parametrize("fields", [{"differential": True},
                                    {"timing_mode": "tracking"}],
                         ids=["dqpsk", "tracking"])
def test_dqpsk_and_tracking_checkpoints_cross_load(tmp_path, fields):
    """A DQPSK or tracking state, RX after 4 frames and TX after 2, saved
    by either package loads into the other leaf for leaf, DQPSK's TX
    phase index as int32 (``TxState.diff_phase``), the RX carries
    (``diff_prev``, the timing PLL's ``(tau, dtau)``) as float32."""
    cfg, jc = ModemConfig(**fields), JCfg(**fields)
    jst = _jax_state(fields)
    bits = np.random.default_rng(6).integers(0, 2, (2, 2, 256),
                                             dtype=np.int32)
    from qpsk_tpu.modem import tx_stream as j_tx_stream
    jtx, _ = j_tx_stream(jc, j_tx_init(jc, batch_shape=(2,)), bits)
    for st, like, jlike in ((jst, rx_init(cfg, (2,), device="cpu"),
                             j_rx_init(jc, batch_shape=(2,))),
                            (jtx, tx_init(cfg, (2,), device="cpu"),
                             j_tx_init(jc, batch_shape=(2,)))):
        jleaves = [np.asarray(x) for x in jax.tree.leaves(st)]
        path = str(tmp_path / "jax.state")
        jck.save_state(path, st)
        got = tck.load_state(path, like)
        tleaves = flatten(got)
        assert len(tleaves) == len(jleaves) == len(flatten(like))
        for a, b in zip(tleaves, jleaves):
            assert a.dtype == (torch.int32 if b.dtype == np.int32
                               else torch.float32)
            np.testing.assert_array_equal(a.numpy(), b)
        path = str(tmp_path / "torch.state")
        tck.save_state(path, got)
        back = jck.load_state(path, jlike)
        for a, b in zip(jax.tree.leaves(back), jleaves, strict=True):
            assert np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)
    if fields.get("differential"):
        dp = tck.load_state(str(tmp_path / "jax.state"),
                            tx_init(cfg, (2,), device="cpu")).diff_phase
        assert dp.dtype == torch.int32
        np.testing.assert_array_equal(dp.numpy(), np.asarray(jtx.diff_phase))
        assert from_numpy(jax.tree.map(np.asarray, jtx),
                          "cpu").diff_phase.dtype == torch.int32


def test_load_state_checks_the_structure(tmp_path):
    path = str(tmp_path / "s.npz")
    tck.save_state(path, rx_init(ModemConfig(), (2,), device="cpu"))
    with pytest.raises(ValueError, match="leaves"):
        tck.load_state(path, rx_init(ModemConfig(agc=True), (2,), device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        tck.load_state(path, rx_init(ModemConfig(), (3,), device="cpu"))


def _stream(fec, seed=9, npkts=24):
    """``tests/test_round4_fixes.py``'s resume stimulus: packets at +50 Hz,
    AWGN 10 dB (numpy), cut mid-bucket at an odd offset."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (npkts, 240), dtype=np.int32)
    mod = JMod(JCfg(), JPcfg(payload_bytes=30, fec=fec), tx_offset_hz=50.0)
    pcm = np.concatenate([mod.push(payload), mod.flush()]).astype(np.float64)
    pcm = np.clip(np.round(pcm + rng.normal(size=pcm.shape)
                           * np.sqrt((pcm ** 2).mean() / 10.0)),
                  -32768, 32767).astype(np.int16)
    return pcm, (pcm.size // 2 // 512) * 512 + 173


def _demod(pkg, fec):
    if pkg == "jax":
        return JDemod(JCfg(), JPcfg(payload_bytes=30, fec=fec))
    return StreamDemodulator(ModemConfig(), PacketConfig(payload_bytes=30,
                                                         fec=fec),
                             device="cpu")


@pytest.mark.parametrize("fec", [False, "conv"])
@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax")])
def test_stream_demodulator_resumes_across_packages(tmp_path, fec, first,
                                                    second):
    """Half a stream in one package, ``save``; ``load`` into the other and
    push the rest: the packets (payload, CRC verdict, stream index) and
    the packet count equal the uninterrupted JAX run's."""
    pcm, cut = _stream(fec)
    ref = _demod("jax", fec)
    ref_pkts = list(ref.push(pcm)) + list(ref.flush())
    d1 = _demod(first, fec)
    got = list(d1.push(pcm[:cut]))
    path = str(tmp_path / "rx.npz")
    d1.save(path)
    d2 = _demod(second, fec)
    d2.load(path)
    got += list(d2.push(pcm[cut:])) + list(d2.flush())
    assert len(got) == len(ref_pkts) > 0
    for a, b in zip(got, ref_pkts):
        assert bool(a.crc_ok) == bool(b.crc_ok)
        assert int(a.stream_index) == int(b.stream_index)
        np.testing.assert_array_equal(np.asarray(a.payload),
                                      np.asarray(b.payload))
    assert d2.counters.packets == ref.counters.packets
    assert abs(d2.counters.detected_offset_hz
               - ref.counters.detected_offset_hz) <= 0.05


@pytest.mark.parametrize("name", ["qpsk", "8psk"])
def test_stream_modulator_resumes_across_packages(tmp_path, name):
    """A transmitter saved mid-stream by either package resumes in the
    other within 3 LSB of the uninterrupted PCM (carried filter and NCO
    state and the 8PSK pending bits cross), and in its own exactly."""
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 2, (20, 240), dtype=np.int64)
    ref = JMod(JCfg(modulation=name), JPcfg(payload_bytes=30),
               tx_offset_hz=50.0)
    pcm_ref = np.concatenate([ref.push(payload[:9]), ref.push(payload[9:]),
                              ref.flush()]).astype(np.int32)

    def make(pkg):
        if pkg == "jax":
            return JMod(JCfg(modulation=name), JPcfg(payload_bytes=30),
                        tx_offset_hz=50.0)
        return StreamModulator(ModemConfig(modulation=name),
                               PacketConfig(payload_bytes=30),
                               tx_offset_hz=50.0, device="cpu")
    for first, second in (("jax", "torch"), ("torch", "jax"),
                          ("torch", "torch")):
        m1 = make(first)
        head = m1.push(payload[:9])
        path = str(tmp_path / f"{first}-{second}.npz")
        m1.save(path)
        m2 = make(second)
        m2.load(path)
        np.testing.assert_array_equal(np.asarray(m2._pend), m1._pend)
        pcm = np.concatenate([head, m2.push(payload[9:]), m2.flush()])
        assert pcm.shape == pcm_ref.shape
        assert np.abs(pcm.astype(np.int32) - pcm_ref).max() <= 3
        if first == second:
            own = make(first)
            want = np.concatenate([own.push(payload[:9]),
                                   own.push(payload[9:]), own.flush()])
            np.testing.assert_array_equal(pcm, want)


def test_acquisition_epoch_round_trips(tmp_path):
    """``tests/test_round5_fixes.py``: a receiver saved while hunting on a
    fallback candidate resumes on it, in either package; a checkpoint
    without the epoch (9 scalars, before the JAX package kept it) loads
    and keeps the receiver's own."""
    pcfg, jp = PacketConfig(payload_bytes=8), JPcfg(payload_bytes=8)
    src = StreamDemodulator(ModemConfig(), pcfg, device="cpu")
    src._acq_idx, src._acq_bits, src._acq_stale = 1, 437, 64
    path = str(tmp_path / "hunting.npz")
    src.save(path)
    for dst in (StreamDemodulator(ModemConfig(), pcfg, device="cpu"),
                JDemod(JCfg(), jp)):
        dst.load(path)
        assert (dst._acq_idx, dst._acq_bits, dst._acq_stale) == (1, 437, 64)
    data = dict(np.load(path))
    data["scalars"] = data["scalars"][:9]
    old = str(tmp_path / "old.npz")
    tck.savez_exact(old, **data)
    dst = StreamDemodulator(ModemConfig(), pcfg, device="cpu")
    dst.load(old)
    assert (dst._acq_idx, dst._acq_bits, dst._acq_stale) == (0, 0, 0)
    assert dst.sync_skip == src.sync_skip and dst._state is None


def test_savez_exact_keeps_the_name(tmp_path):
    path = tmp_path / "rx.state"
    tck.savez_exact(str(path), a=np.arange(3))
    assert path.exists() and not (tmp_path / "rx.state.npz").exists()
