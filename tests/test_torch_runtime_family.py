"""The port's streaming runtime against the JAX package's over the
generic modulation family (``tests/test_modfam_stream.py``: BPSK and 8PSK
in odd chunks, 8PSK resync after a gap) and the acquisition fallbacks
(``tests/test_round4_fixes.py``: the 8PSK M-power spur at +250 Hz, which
only the candidate rotation recovers; ``tests/test_round5_fixes.py``: the
sweep grid when both candidates are spurs, the acquisition stubbed in both
packages): the same numpy-seeded PCM in the same chunk sizes through both
receivers on CPU tensors must give the same packets, equal integer
counters and acquisition epoch, ``detected_offset_hz`` within 0.05 Hz and
``carrier_snr_db`` within 0.01 dB.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg
from qpsk_tpu.packet import PacketConfig as JPcfg
from qpsk_tpu.runtime import StreamDemodulator as JDemod
from qpsk_tpu.runtime import StreamModulator as JMod
from qpsk_tpu_torch import ModemConfig, StreamDemodulator
from qpsk_tpu_torch.packet import PacketConfig
from torch_runtime_common import (assert_same, chunks_of, make_pcm, ok_count,
                                  run_both)

torch.set_num_threads(2)


@pytest.mark.parametrize("name,snr", [("bpsk", None), ("8psk", 20.0)])
def test_family_odd_chunks_match_jax(name, snr):
    fields = dict(modulation=name)
    payload, pcm = make_pcm(fields, 40, seed=0, snr=snr, offset=30.0)
    jd, jp, td, tp = run_both(fields, dict(payload_bytes=30), pcm,
                              chunks_of(pcm.size, 1, 100, 3000))
    assert_same(jd, jp, td, tp)
    assert td.counters.synced and ok_count(tp) >= 28
    wanted = {p.tobytes() for p in payload}
    assert all(p.payload.tobytes() in wanted for p in tp if p.crc_ok)


def test_8psk_resync_after_gap_matches_jax():
    fields = dict(modulation="8psk")
    _, pcm1 = make_pcm(fields, 32, seed=4, snr=22.0, offset=30.0)
    _, pcm2 = make_pcm(fields, 32, seed=5, snr=22.0, offset=30.0)
    stream = np.concatenate([pcm1, np.zeros(4096, np.int16), pcm2])
    jd, jp, td, tp = run_both(fields, dict(payload_bytes=30), stream,
                              resync_after=4)
    assert_same(jd, jp, td, tp)
    assert td.counters.resyncs >= 1


def test_8psk_spur_rotates_candidates_like_jax():
    """8PSK at +250 Hz, seed 0 (``tests/test_round4_fixes.py``'s
    ``_tx_8psk_offset`` stimulus): the first candidate is the spur 300 Hz
    off; two dead hunt windows rotate to the next candidate, which locks.
    Both packages rotate alike and emit the same packets."""
    fields = dict(modulation="8psk")
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 2, (100, 240), dtype=np.int32)
    mod = JMod(JCfg(**fields), JPcfg(payload_bytes=30), tx_offset_hz=250.0)
    pcm = np.concatenate([mod.push(payload), mod.flush()])
    x = pcm.astype(np.float64)
    pcm = np.clip(np.round(x + rng.normal(size=x.shape)
                           * np.sqrt((x ** 2).mean() / 100.0)),
                  -32768, 32767).astype(np.int16)
    jd, jp, td, tp = run_both(fields, dict(payload_bytes=30), pcm,
                              [(i, min(i + 20480, pcm.size))
                               for i in range(0, pcm.size, 20480)])
    assert_same(jd, jp, td, tp)
    assert td._acq_idx == jd._acq_idx and td._acq_idx >= 1
    assert td.counters.synced and ok_count(tp) >= 20


def test_sweep_fallback_matches_jax():
    """Both candidates forced onto spurs 420 Hz out (the acquisition
    stubbed in both packages): the rotation walks into the sweep grid and
    both lock on the same seed and emit the same packets."""
    fields = dict(modulation="8psk")
    payload, pcm = make_pcm(fields, 120, seed=3, snr=20.0, offset=150.0)
    jd = JDemod(JCfg(**fields), JPcfg(payload_bytes=30))
    td = StreamDemodulator(ModemConfig(**fields), PacketConfig(payload_bytes=30),
                           device="cpu")
    jd._acquire_jit = lambda chunk: jnp.asarray([420.0, -420.0])
    td._acquire = lambda chunk: torch.tensor([420.0, -420.0])
    step = td.bucket_frames * td.cfg.frame_size
    jp, tp = [], []
    for i in range(0, pcm.size, step):
        jp += jd.push(pcm[i:i + step])
        tp += td.push(pcm[i:i + step])
    jp += jd.flush()
    tp += td.flush()
    assert_same(jd, jp, td, tp)
    assert td._acq_idx == jd._acq_idx and td._acq_idx >= 2
    assert ok_count(tp) >= 20
