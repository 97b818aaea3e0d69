"""The port's H100 roofline (``qpsk_tpu_torch.utils.roofline``).

(a) The bounds ``chip_smoke.py`` prints for each kernel at its rate
    point, pinned to the values PERF.md's kernel table records, to 4
    decimals: the front-end (time-major, with the power output,
    channel-major at 8 samples per symbol), Costas (QPSK, gear, gains,
    the dd modes), TX at 4 and 8 samples per symbol, the decoders at
    4096 packets.
(b) The JAX module's records on these prices: the kernel route's
    traffic under a fifth of the staged chain's (as
    ``tests/test_benchmarks.py`` holds the TPU kernel), each record's
    bound named by bytes or operations, the Costas step in cycles at
    the card's top clock.
"""

import pytest

from qpsk_tpu_torch import ModemConfig
from qpsk_tpu_torch.packet import LdpcCode
from qpsk_tpu_torch.utils import roofline as R

C, NF, NSYM = 8192, 8, 128
T = NF * NSYM


@pytest.mark.parametrize("work, want", [
    (lambda: R.frontend_work(C, NF, 4, True, False), 0.0550),
    (lambda: R.frontend_work(C, NF, 4, True, True), 0.0553),
    (lambda: R.frontend_work(C, NF, 4, False, False), 0.0550),
    (lambda: R.frontend_work(C, NF, 8, False, False), 0.0546),
    (lambda: R.costas_work(C, T, NSYM), 0.0602),
    (lambda: R.costas_work(C, T, NSYM, gear=True), 0.0603),
    (lambda: R.costas_work(C, T, NSYM, gains=True), 0.0603),
    (lambda: R.costas_work(C, T, NSYM, dd="bpsk"), 0.0502),
    (lambda: R.costas_work(C, T, NSYM, dd="8psk"), 0.0702),
    (lambda: R.costas_work(C, T, NSYM, gains=True, dd="16qam"), 0.0803),
    (lambda: R.tx_work(C, T, 4), 0.0432),
    (lambda: R.tx_work(C, NF * 64, 8), 0.0328),
    (lambda: R.fec_work("viterbi", 4096), 0.0042),
    (lambda: R.fec_work("ldpc", 4096), 0.0156),
])
def test_kernel_bounds_pinned(work, want):
    got = work()
    assert round(got[0], 4) == want, got
    assert got[1] in ("bytes", "operations")


def test_general_instance_bounds_pinned():
    """PERF.md's general-instance rows: the front-end at 4096-sample
    frames, its power output at 384 symbols a frame, channel-major at 3
    samples per symbol (256 x 8); TX at 16 samples per symbol."""
    for fields, kind, want in (
            (dict(frame_size=4096), "tm", 0.0135),
            (dict(frame_size=1536, agc=True), "tm_power", 0.0051),
            (dict(rs=3200.0, frame_size=384), "cm", 0.0013)):
        got = R.general_work(kind, ModemConfig(**fields), 256, 8)
        assert round(got[0], 4) == want, (kind, got)
    got = R.general_work("tx", ModemConfig(rs=600.0, frame_size=2048), 256,
                         s=4096)
    assert round(got[0], 4) == 0.0126
    got = R.general_work("ldpc", code=LdpcCode(256, dv=5), b=4096)
    assert round(got[0], 4) == 0.0219


def test_frontend_cost_kernel_route_below_staged():
    cfg = ModemConfig()
    kern = R.frontend_cost(cfg, 128, 16, "pallas")
    staged = R.frontend_cost(cfg, 128, 16, "xla")
    assert kern.bytes < 0.2 * staged.bytes
    assert kern.bound in ("bytes", "operations")
    assert staged.ideal_s > 0 and kern.ideal_s > 0
    # the kernel's cost at the rate point is frontend_work's
    assert R.frontend_cost(cfg, C, NF).ideal_s * 1e3 == pytest.approx(
        R.frontend_work(C, NF, 4, False, False)[0])
    # and at a geometry of the general instance, general_work's
    gen = ModemConfig(rs=3200.0, frame_size=384)
    assert R.frontend_cost(gen, 256, 8).ideal_s * 1e3 == pytest.approx(
        R.general_work("cm", gen, 256, 8)[0])
    with pytest.raises(ValueError):
        R.frontend_cost(cfg, 8, 2, "mosaic")


def test_reports():
    cfg = ModemConfig()
    for impl in ("pallas", "xla"):
        rec = R.frontend_report(cfg, C, NF, 5e-3, impl)
        assert rec["impl"] == impl and rec["bound"] in ("bytes", "operations")
        assert rec["ideal_s"] > 0 and rec["measured_s"] == 5e-3
        assert 0 < rec["roofline_fraction"] < 1
    rec = R.composed_rx_report(cfg, C, NF, measured_s=6e-4)
    assert rec["bound"] in ("bytes", "operations")
    assert rec["fe_bytes"] > 0 and rec["costas_bytes"] > 0
    assert 0 < rec["hbm_roofline_fraction"] < 1
    rec = R.costas_report(2048, 1024, measured_pass_s=1.6e-4,
                          step_ns_by_channels={1024: 150.0, 2048: 156.0})
    assert rec["serial_steps_per_pass"] == 1024
    assert rec["cycles_per_step"] == round(1.6e-4 / 1024 * 1.98e9, 0)
    assert rec["bound"] == "serial-step-issue"
    assert 0.9 < rec["step_time_flatness"] <= 1.0
    rec = R.ldpc_report(LdpcCode(k=256), 4096, measured_s=1.3e-4)
    assert rec["bound"] == "operations" and rec["dmax"] > 0
    rec = R.viterbi_report(262, 64, 4096, measured_s=7e-5)
    assert rec["trellis_steps"] == 262 and rec["states"] == 64
    assert rec["bound"] == "operations"
    assert rec["hbm_bytes_per_decode"] == (524 + 256) * 4
