"""Helpers of the runtime tests (``tests/test_torch_runtime*.py``): the
same numpy-seeded PCM in the same chunks through the JAX package's
``StreamDemodulator`` and the port's on CPU tensors, and the comparison
they are held to."""

import numpy as np

from qpsk_tpu import ModemConfig as JCfg
from qpsk_tpu.packet import PacketConfig as JPcfg
from qpsk_tpu.runtime import StreamDemodulator as JDemod
from qpsk_tpu.runtime import StreamModulator as JMod
from qpsk_tpu_torch import ModemConfig, StreamDemodulator
from qpsk_tpu_torch.packet import PacketConfig

_INT_COUNTERS = ("frames", "packets", "crc_failures", "resyncs", "synced",
                 "carrier_detect")


def make_pcm(fields, npkts, seed, snr=None, offset=50.0, payload_bytes=30,
             fec=False):
    """(payload, PCM) of ``npkts`` random packets from the JAX
    ``StreamModulator`` at ``offset`` Hz, AWGN at ``snr`` dB from numpy."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (npkts, 8 * payload_bytes), dtype=np.int32)
    mod = JMod(JCfg(**fields), JPcfg(payload_bytes=payload_bytes, fec=fec),
               tx_offset_hz=offset)
    pcm = np.concatenate([mod.push(payload), mod.flush()])
    if snr is not None:
        x = pcm.astype(np.float64)
        sigma = np.sqrt((x ** 2).mean() / 10.0 ** (snr / 10.0))
        pcm = np.clip(np.round(x + rng.normal(size=x.shape) * sigma),
                      -32768, 32767).astype(np.int16)
    return payload, pcm


def chunks_of(n, seed, lo, hi):
    """Seeded chunk boundaries covering ``n`` samples."""
    rng = np.random.default_rng(seed)
    out, pos = [], 0
    while pos < n:
        step = int(rng.integers(lo, hi))
        out.append((pos, min(n, pos + step)))
        pos += step
    return out


def run_both(fields, pcfg_fields, pcm, chunks=None, **knobs):
    """Push the same PCM chunks through both packages' receivers, then
    flush; returns (JAX receiver, its packets, port receiver, its
    packets)."""
    jd = JDemod(JCfg(**fields), JPcfg(**pcfg_fields), **knobs)
    td = StreamDemodulator(ModemConfig(**fields), PacketConfig(**pcfg_fields),
                           device="cpu", **knobs)
    jp, tp = [], []
    for a, b in chunks or [(0, pcm.size)]:
        jp += jd.push(pcm[a:b])
        tp += td.push(pcm[a:b])
    return jd, jp + jd.flush(), td, tp + td.flush()


def assert_same(jd, jp, td, tp):
    """Equal packets and integer counters, the float counters close."""
    assert len(jp) == len(tp), (len(jp), len(tp))
    for a, b in zip(jp, tp):
        assert (bool(a.crc_ok), int(a.stream_index)) == (b.crc_ok,
                                                         b.stream_index)
        np.testing.assert_array_equal(np.asarray(a.payload), b.payload)
    for name in _INT_COUNTERS:
        assert getattr(jd.counters, name) == getattr(td.counters, name), name
    assert abs(jd.counters.detected_offset_hz
               - td.counters.detected_offset_hz) <= 0.05
    js, ts = jd.counters.carrier_snr_db, td.counters.carrier_snr_db
    assert (np.isnan(js) and np.isnan(ts)) or abs(js - ts) <= 0.01, (js, ts)


def ok_count(pkts):
    return sum(bool(p.crc_ok) for p in pkts)
