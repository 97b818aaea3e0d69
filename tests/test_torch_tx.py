"""The torch port's TX (``ops/cuda/tx_kernel.py``, its plain version on CPU;
``modem.tx_stream``) against the JAX package's XLA ``tx_stream`` and the
Pallas TX kernel in interpret mode.

PCM within 2 LSB one-shot and 3 LSB chained: the JAX package's own bounds
for two accumulation orders of the same filter (tests/test_pallas_tx.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg, tx_init as j_tx_init
from qpsk_tpu.modem import tx_stream as j_tx_stream
from qpsk_tpu.ops import modmap as jmodmap
from qpsk_tpu.ops.pallas.tx_kernel import tx_modulate_fused
from qpsk_tpu_torch import ModemConfig, tx_init, tx_stream
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.cuda.tx_kernel import tx_modulate
from qpsk_tpu_torch.ops.modmap import bits_to_symbols
from qpsk_tpu_torch.state import from_numpy

torch.set_num_threads(2)

CFG, JC = ModemConfig(), JCfg()
C, NSYM = 8, 512


def _bits(seed, nframes=4):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (C, nframes, 2 * NSYM // nframes), dtype=np.int32)


def _lsb(a, b):
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max())


def test_tx_modulate_matches_jax():
    bits = _bits(0).reshape(C, -1)
    sym = bits_to_symbols(torch.from_numpy(bits))
    assert torch.equal(sym.re, torch.from_numpy(np.asarray(
        jmodmap.bits_to_symbols(bits).re)))
    jst = j_tx_init(JC, batch_shape=(C,))
    st = from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    pcm, ph, tl = tx_modulate(CFG, sym, st.nco_phase, st.fir_tail, 50.0)
    assert pcm.shape == (C, NSYM * 4) and pcm.dtype == torch.int16

    jsym = jmodmap.bits_to_symbols(jnp.asarray(bits))
    kp, kph, ktl = tx_modulate_fused(JC, jsym, jst.nco_phase, jst.fir_tail,
                                     tx_offset_hz=50.0, interpret=True)
    xst, xp = j_tx_stream(JC, jst, _bits(0), tx_offset_hz=50.0)
    assert _lsb(pcm, kp) <= 2
    assert _lsb(pcm, np.asarray(xp).reshape(C, -1)) <= 2
    for a, b in ((ph, kph), (ph, xst.nco_phase)):
        np.testing.assert_allclose(a.re.numpy(), np.asarray(b.re), atol=1e-4)
        np.testing.assert_allclose(a.im.numpy(), np.asarray(b.im), atol=1e-4)
    for b in (ktl, xst.fir_tail):
        np.testing.assert_allclose(tl.re.numpy(), np.asarray(b.re), atol=1e-6)
        np.testing.assert_allclose(tl.im.numpy(), np.asarray(b.im), atol=1e-6)


@pytest.mark.parametrize("split", [128, 256])
def test_tx_chained_matches_one_shot(split):
    """Chained port calls == one JAX pass over the concatenation."""
    bits = _bits(3).reshape(C, -1)
    sym = bits_to_symbols(torch.from_numpy(bits))
    st = tx_init(CFG, (C,), device="cpu")
    parts = []
    for sl in (slice(0, split), slice(split, None)):
        s = CF32(sym.re[:, sl].contiguous(), sym.im[:, sl].contiguous())
        p, ph, tl = tx_modulate(CFG, s, st.nco_phase, st.fir_tail, 50.0)
        st = st._replace(nco_phase=ph, fir_tail=tl)
        parts.append(p)
    _, xp = j_tx_stream(JC, j_tx_init(JC, batch_shape=(C,)), _bits(3),
                        tx_offset_hz=50.0)
    assert _lsb(torch.cat(parts, 1), np.asarray(xp).reshape(C, -1)) <= 3


def test_tx_stream_matches_jax_from_warm_state():
    """tx_stream on bit frames, started from a JAX state after one call,
    single stream and channel batch."""
    jst, _ = j_tx_stream(JC, j_tx_init(JC, batch_shape=(C,)), _bits(5, 2),
                         tx_offset_hz=-30.0)
    st = from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    bits = _bits(6)
    _, xp = j_tx_stream(JC, jst, bits, tx_offset_hz=-30.0)
    new, pcm = tx_stream(CFG, st, torch.from_numpy(bits), tx_offset_hz=-30.0)
    assert pcm.shape == (C, 4, 512)
    assert _lsb(pcm, xp) <= 2
    one = jax.tree.map(lambda v: v[0], jst)
    _, xp1 = j_tx_stream(JC, one, bits[0], tx_offset_hz=-30.0)
    _, pcm1 = tx_stream(CFG, from_numpy(jax.tree.map(np.asarray, one), device="cpu"),
                        torch.from_numpy(bits[0]), tx_offset_hz=-30.0)
    assert pcm1.shape == (4, 512) and _lsb(pcm1, xp1) <= 2
