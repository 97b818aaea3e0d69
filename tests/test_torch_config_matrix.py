"""The configuration matrix of ``tests/test_config_matrix.py`` through the
torch port: every modulation x the nine flag rows (differential, AGC,
equalizer, timing mode, gear shift).  Each combination either raises the
same ``ValueError`` as the JAX package at construction, or runs
``tx_stream`` -> ``rx_stream`` on CPU tensors with finite outputs of the
JAX shapes that match JAX: the PCM within 2 LSB, and on JAX's PCM equal
timing decisions and bits (except on symbols within 1e-3 of a decision
boundary), the loop frequency within 0.05 Hz.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from qpsk_tpu import ModemConfig as JCfg, rx_init as j_rx_init, tx_init as j_tx_init
from qpsk_tpu.config import TAU
from qpsk_tpu.modem import rx_stream as j_rx_stream, tx_stream as j_tx_stream
from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream, tx_init, tx_stream
from qpsk_tpu_torch.ops import modfam

torch.set_num_threads(2)

# the JAX receive jitted whole: one compilation a configuration
_J_RX = jax.jit(j_rx_stream, static_argnums=0)

MODS = ["qpsk", "bpsk", "8psk", "16qam"]
FLAGS = [  # (differential, agc, eq_taps, timing, loop_bw_track)
    (False, False, 0, "power", 0.0),
    (True, False, 0, "power", 0.0),
    (False, True, 0, "power", 0.0),
    (False, False, 5, "power", 0.0),
    (False, False, 0, "tracking", 0.0),
    (False, False, 0, "fractional", 0.0),
    (False, False, 0, "histogram", 0.0),
    (False, False, 0, "power", TAU / 200.0),
    (False, True, 5, "tracking", 0.0),
]


def _combo_id(p):
    mod, (diff, agc, eq, timing, trk) = p
    return f"{mod}-d{int(diff)}-a{int(agc)}-e{eq}-{timing}-g{int(trk > 0)}"


def _near_tie(cfg, sym) -> np.ndarray:
    """Symbols within 1e-3 of any decision boundary of the modem's
    slicers: an axis, a diagonal, 16QAM's amplitude threshold."""
    re, im = np.abs(sym.re.numpy()), np.abs(sym.im.numpy())
    d = np.minimum(np.minimum(re, im), np.abs(re - im))
    if cfg.modulation == "16qam":
        thr = float(modfam.dd_constants(modfam.get("16qam"), cfg.agc_target)[-1])
        d = np.minimum(d, np.minimum(np.abs(re - thr), np.abs(im - thr)))
    return d < 1e-3


@pytest.mark.parametrize(
    "mod,flags", list(itertools.product(MODS, FLAGS)),
    ids=[_combo_id(p) for p in itertools.product(MODS, FLAGS)])
def test_config_combo_matches_jax_or_rejects(mod, flags):
    diff, agc, eq, timing, trk = flags
    fields = dict(modulation=mod, differential=diff, agc=agc, eq_taps=eq,
                  timing_mode=timing, loop_bw_track=trk)
    try:
        jc = JCfg(**fields)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ModemConfig(**fields)
        assert str(got.value) == str(e)
        return
    cfg = ModemConfig(**fields)
    bits = np.random.default_rng(0).integers(0, 2, (2, 3, cfg.bits_per_frame),
                                             dtype=np.int32)
    _, jpcm = j_tx_stream(jc, j_tx_init(jc, (2,)), bits, tx_offset_hz=30.0)
    _, pcm = tx_stream(cfg, tx_init(cfg, (2,), device="cpu"),
                       torch.from_numpy(bits), tx_offset_hz=30.0)
    jpcm = np.array(jpcm)
    assert pcm.shape == jpcm.shape and pcm.dtype == torch.int16
    assert np.abs(pcm.numpy().astype(np.int32) - jpcm).max() <= 2
    _, jout = _J_RX(jc, j_rx_init(jc, (2,)), jpcm)
    _, out = rx_stream(cfg, rx_init(cfg, (2,), device="cpu"),
                       torch.from_numpy(jpcm))
    for got, want in ((out.symbols.re, jout.symbols.re), (out.bits, jout.bits),
                      (out.freq_hz, jout.freq_hz),
                      (out.timing_index, jout.timing_index)):
        assert tuple(got.shape) == tuple(np.shape(want))
    assert torch.isfinite(out.symbols.re).all() and torch.isfinite(out.freq_hz).all()
    assert ((out.bits == 0) | (out.bits == 1)).all()
    np.testing.assert_array_equal(out.timing_index.numpy(),
                                  np.asarray(jout.timing_index))
    flips = (out.bits.numpy() != np.asarray(jout.bits)).reshape(
        out.symbols.re.shape + (-1,))
    assert _near_tie(cfg, out.symbols)[flips.any(-1)].all(), int(flips.sum())
    np.testing.assert_allclose(out.freq_hz.numpy(), np.asarray(jout.freq_hz),
                               atol=0.05)
