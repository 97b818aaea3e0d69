"""The port's PER sweep (``qpsk_tpu_torch.eval.per_vs_snr``) against the JAX
package's (``qpsk_tpu.eval.per_vs_snr``) on CPU tensors.  Both draw the
same payload from the seed; the noise differs (a ``torch.Generator``
against a JAX key), so the two are held to the same decisions at SNRs
where the noise decides nothing (every packet, sync score and bit equal,
the estimates close), uncoded, coded (the soft path) and for 8PSK (the
acquisition path); and the port's curve alone is held to be monotone."""

import numpy as np
import pytest
import torch

from qpsk_tpu import ModemConfig as JCfg
from qpsk_tpu.eval import per_vs_snr as j_per_vs_snr
from qpsk_tpu.packet import PacketConfig as JPcfg
from qpsk_tpu_torch import ModemConfig
from qpsk_tpu_torch.eval import per_vs_snr
from qpsk_tpu_torch.packet import PacketConfig

torch.set_num_threads(2)

KEYS = {"snr_db", "per", "ber", "evm_rms", "detected_hz", "packets",
        "sync_score"}


@pytest.mark.parametrize("fields,pfields,offset", [
    ({}, dict(payload_bytes=30), 50.0),
    ({}, dict(payload_bytes=13, fec="conv"), 50.0),
    (dict(modulation="8psk"), dict(payload_bytes=30), 30.0),
], ids=["qpsk", "qpsk_conv", "8psk"])
def test_noiseless_level_decisions_match_jax(fields, pfields, offset):
    snrs = [40.0, 50.0]
    kw = dict(nframes=24, offset_hz=offset, seed=3)
    j = j_per_vs_snr(JCfg(**fields), JPcfg(**pfields), snrs, **kw)
    t = per_vs_snr(ModemConfig(**fields), PacketConfig(**pfields), snrs,
                   device="cpu", **kw)
    assert len(t) == len(j) == 2
    for a, b in zip(j, t):
        assert set(b) == KEYS
        for key in ("snr_db", "per", "ber", "packets", "sync_score"):
            assert b[key] == a[key], (key, a, b)
        assert b["per"] == 0.0 and b["packets"] >= 10
        assert abs(b["detected_hz"] - a["detected_hz"]) <= 0.1
        assert abs(b["evm_rms"] - a["evm_rms"]) <= 2e-3


def test_curve_is_monotone():
    """0, 6 and 12 dB in one receive pass: the EVM falls with SNR, the
    PER does not rise, and 12 dB decodes clean (the JAX suite's test)."""
    res = per_vs_snr(ModemConfig(), PacketConfig(payload_bytes=30),
                     [0.0, 6.0, 12.0], nframes=60, seed=0, device="cpu")
    assert [r["snr_db"] for r in res] == [0.0, 6.0, 12.0]
    evms = [r["evm_rms"] for r in res]
    assert evms[0] > evms[1] > evms[2]
    pers = [r["per"] for r in res]
    assert pers[0] >= pers[1] >= pers[2] == 0.0
    assert res[2]["sync_score"] == 4 and res[2]["ber"] == 0.0
    assert all(np.isfinite(r["detected_hz"]) for r in res)


def test_entry_point_needs_a_card_or_cpu():
    """The default device is the card: without one the call raises before
    any work, never running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises((RuntimeError, AssertionError)):
        per_vs_snr(ModemConfig(), PacketConfig(payload_bytes=30), [10.0],
                   nframes=16)
