"""The port's streaming runtime against the JAX package's on coded links
(``tests/test_runtime.py``'s FEC at low SNR for the convolutional code and
LDPC, ``tests/test_modfam_stream.py``'s 8PSK with soft FEC, DQPSK with hard
FEC): the same
numpy-seeded PCM in the same chunk sizes through both receivers on CPU
tensors must give the same packets, equal integer counters,
``detected_offset_hz`` within 0.05 Hz and ``carrier_snr_db`` within
0.01 dB.  The soft hunt and drain decode every hypothesis through the
plain decoders here, the kernels on the card.
"""

import pytest
import torch

from torch_runtime_common import (assert_same, chunks_of, make_pcm, ok_count,
                                  run_both)

torch.set_num_threads(2)


@pytest.mark.parametrize("fec", ["conv", "ldpc"])
def test_fec_low_snr_matches_jax(fec):
    """Coded QPSK at 6 dB in awkward chunks: the soft hunt (8 probe
    packets) and the soft drain give the same packets in both packages."""
    payload, pcm = make_pcm({}, 24, seed=3, snr=6.0, fec=fec)
    jd, jp, td, tp = run_both({}, dict(payload_bytes=30, fec=fec), pcm,
                              chunks_of(pcm.size, 4, 400, 5000))
    assert_same(jd, jp, td, tp)
    assert td.counters.synced and ok_count(tp) >= 8
    wanted = {p.tobytes() for p in payload}
    assert all(p.payload.tobytes() in wanted for p in tp if p.crc_ok)


def test_8psk_soft_fec_matches_jax():
    """Coded 8PSK: the LLR rows are per-rotation relabellings of the score
    matrix; soft Viterbi at 17 dB."""
    fields = dict(modulation="8psk")
    payload, pcm = make_pcm(fields, 16, seed=3, snr=17.0, offset=30.0, fec="conv")
    jd, jp, td, tp = run_both(fields, dict(payload_bytes=30, fec="conv"), pcm)
    assert_same(jd, jp, td, tp)
    assert ok_count(tp) >= 6


def test_dqpsk_conv_hard_input_matches_jax():
    """DQPSK + ``fec="conv"`` at 8 dB: both receivers decode hard input
    (DQPSK's bits have no per-bit LLRs, ``runtime.py``'s ``_use_soft``),
    the port's keeps no LLR buffer, and the two give the same packets."""
    fields, pf = {"differential": True}, {"payload_bytes": 30, "fec": "conv"}
    _, pcm = make_pcm(fields, 14, seed=8, snr=8.0, fec="conv")
    jd, jp, td, tp = run_both(fields, pf, pcm)
    assert not jd._use_soft and not td._use_soft
    assert td._llr_buf.shape[1] == 0
    assert_same(jd, jp, td, tp)
    assert ok_count(tp) >= 0.8 * len(tp) > 0
