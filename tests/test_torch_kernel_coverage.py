"""Each CUDA wrapper's ``coverage`` against the JAX package's Pallas gates,
over enumerated grids, and the lowering switches.

For every configuration the TPU kernel's gate admits, the port's kernel
must cover it (``coverage`` returns None): the front-end
(``frontend_supported``, ``frontend_tm_supported``) at 2..16 samples per
symbol dividing frames of 128..8192 samples and 3..129 taps; TX
(``tx_supported``) up to its 128-symbol halo; Viterbi (``viterbi_decode``'s
gate, ``qpsk_tpu/packet/fec.py``) at K 5..15 and rates 1/1, 1/2, 1/4, 1/8
with random generators; LDPC (``ldpc_decode``'s 6 MiB gate) at dv 2..8 and
k 64..512.  Past the coverage a wrapper names the field.  The JAX gates
are imported here only.

The switches: ``costas_impl="scan"`` and ``frontend_impl`` / ``tx_impl``
``"xla"`` equal ``"auto"`` on CPU tensors bit for bit, ``"pallas"`` raises
on a CPU tensor, an unknown value raises as the JAX config does; the
decoders' ``impl`` likewise.
"""

import ctypes
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qpsk_tpu.ops.pallas.frontend_kernel import (frontend_supported,
                                                 frontend_tm_supported)
from qpsk_tpu.ops.pallas.tx_kernel import tx_supported
from qpsk_tpu.packet import ldpc as jldpc
from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream, tx_init, tx_stream
from qpsk_tpu_torch.ops.costas import costas_init, costas_params, gear_for
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.cuda import (costas_kernel, frontend_kernel,
                                     ldpc_kernel, tx_kernel, viterbi_kernel)
from qpsk_tpu_torch.packet import ConvCode, LdpcCode, conv_encode
from qpsk_tpu_torch.packet.fec import viterbi_decode
from qpsk_tpu_torch.packet.ldpc import ldpc_decode, ldpc_encode
from torch_kernel_recorder import routed

torch.set_num_threads(2)


def _geom(cycles, fsz, ntaps):
    """The fields both packages' gates read, without a config's checks."""
    return SimpleNamespace(cycles=cycles, frame_size=fsz, ntaps=ntaps,
                           symbols_per_frame=fsz // cycles,
                           timing_mode="power", fir_precision="fast")


@pytest.mark.parametrize("cycles", range(2, 17))
def test_frontend_covers_the_tpu_gate(cycles):
    admitted = 0
    for fsz in range(128, 8193, 128):
        if fsz % cycles:
            continue
        for ntaps in range(3, 132, 2):
            g = _geom(cycles, fsz, ntaps)
            for c in (8, 128):
                if frontend_supported(g, (c,), fsz):
                    admitted += 1
                    assert frontend_kernel.coverage(g) is None, vars(g)
                if frontend_tm_supported(g, (c,), fsz):
                    assert frontend_kernel.coverage(g) is None
            if ntaps > 129:
                assert frontend_kernel.coverage(g)[0] == "ntaps"
    assert admitted > 0


@pytest.mark.parametrize("cycles", range(2, 17))
def test_tx_covers_the_tpu_gate(cycles):
    admitted = 0
    for ntaps in range(3, 130 * cycles, 2):
        g = _geom(cycles, 512 * cycles, ntaps)
        if tx_supported(g, (8,), 1024):
            admitted += 1
            assert tx_kernel.coverage(g) is None, (cycles, ntaps)
        else:
            assert tx_kernel.coverage(g)[0] == "ntaps", (cycles, ntaps)
    assert admitted > 0


@pytest.mark.parametrize("cycles", range(2, 17))
def test_frontend_geometries_off_fast_route_to_the_general_instance(
        monkeypatch, cycles):
    """Every (samples per symbol, frame) of the coverage grid above that no
    fast instance takes launches ``qpsk_frontend_gen``, counted once under
    that entry, in all three launches (time-major, with the power output,
    channel-major) with the config's geometry and ``tm`` flag, and a
    scratch row for the power tree when the power output is asked for; the
    rest launch ``qpsk_frontend_pipe``."""
    routed_gen = 0
    for fsz in range(128, 8193, 128):
        if fsz % cycles:
            continue
        for ntaps in ((3, 127, 129) if fsz in (128, 2048) else (127,)):
            for base in ("tm", "tm_power", "cm"):
                cfg = ModemConfig(fs=1200.0 * cycles, rs=1200.0,
                                  frame_size=fsz, ntaps=ntaps,
                                  agc=base == "tm_power")
                nsym = fsz // cycles
                st = rx_init(cfg, (1,), device="cpu")
                pcm = torch.zeros((1, 1, fsz), dtype=torch.int16)
                delay = None if base == "cm" else st.decim_delay
                name, args, moved = routed(
                    monkeypatch, lambda: frontend_kernel._launch(
                        cfg, pcm, st.nco_phase, st.fir_tail, delay))
                fast = (cycles in (2, 4, 8) and fsz <= 512
                        and not (base == "tm_power" and nsym & (nsym - 1)))
                assert frontend_kernel._fast(cfg, base == "tm_power") == fast
                assert moved == {name: 1}
                if fast:
                    assert name == "qpsk_frontend_pipe", (cfg, name)
                    continue
                routed_gen += 1
                assert name == "qpsk_frontend_gen", (cycles, fsz, base, name)
                assert (args["cycles"], args["fsz"], args["ntaps"]) == (
                    cycles, fsz, ntaps)
                assert args["tm"] == (0 if base == "cm" else 1)
                assert (args["power"] is not None) == (base == "tm_power")
                assert (args["scratch"] is not None) == (base == "tm_power")
    assert routed_gen > 0 or cycles in (2, 4, 8)


@pytest.mark.parametrize("cycles", range(2, 17))
def test_tx_geometries_off_fast_route_to_the_general_instance(monkeypatch,
                                                              cycles):
    """Every tap count of the TX coverage grid above that ``tx_kernel<CYC>``
    does not take (past 8 samples per symbol or 129 taps) launches
    ``qpsk_tx_gen``, the rest ``qpsk_tx``: counted once under that entry,
    with the config's samples per symbol and taps."""
    for ntaps in range(3, 130 * cycles, 2):
        if tx_kernel.coverage(_geom(cycles, 512 * cycles, ntaps)) is not None:
            continue
        cfg = ModemConfig(fs=1200.0 * cycles, rs=1200.0,
                          frame_size=128 * cycles, ntaps=ntaps)
        st = tx_init(cfg, (1,), device="cpu")
        sym = CF32(torch.zeros((1, 5)), torch.zeros((1, 5)))
        name, args, moved = routed(monkeypatch, lambda: tx_kernel._launch(
            cfg, sym, st.nco_phase, st.fir_tail, 0.0))
        fast = cycles <= 8 and ntaps <= 129
        assert tx_kernel._fast(cfg) == fast
        assert name == ("qpsk_tx" if fast else "qpsk_tx_gen")
        assert moved == {name: 1}
        assert (args["cycles"], args["ntaps"], args["S"]) == (cycles, ntaps, 5)


# (gear, gains, dd modulation or None, detector code of csrc/costas.cu's
# enum Detector, bits a symbol) of each mode of the Costas wrapper
_COSTAS_MODES = {"qpsk": (False, False, None, 0, 2),
                 "gear": (True, False, None, 0, 2),
                 "gains": (False, True, None, 0, 2),
                 "gear_gains": (True, True, None, 0, 2),
                 "dd_bpsk": (False, False, "bpsk", 1, 1),
                 "dd_8psk": (False, False, "8psk", 2, 3),
                 "dd_16qam": (False, True, "16qam", 3, 4)}


@pytest.mark.parametrize("mode", list(_COSTAS_MODES))
def test_costas_modes_pass_their_pointers_and_detector(monkeypatch, mode):
    """Each mode of the Costas wrapper launches ``qpsk_costas_tm`` once,
    counted under that entry, with the lock detector's state in and out
    only with the gear, the gains plane (and its symbols a frame) only with
    gains, the detector code of its modulation (QPSK's 0 otherwise), the
    gear's five constants or zeros and the dd mode's constants or zeros,
    and the outputs it returns, the bits (C, bps * T)."""
    gear, gains, kind, det, bps = _COSTAS_MODES[mode]
    t, c, nf = 64, 3, 4
    st = costas_init((c,), gear=gear, device="cpu")
    z = torch.linspace(-1.0, 1.0, t * c).reshape(t, c)
    g = torch.ones((nf, c)) if gains else None
    dd = None if kind is None else (kind, 1.0)
    out = []
    name, args, moved = routed(monkeypatch, lambda: out.append(
        costas_kernel._launch(st, z, -z, costas_params(0.06), 16,
                              gear_for(0.01) if gear else None, g, dd)))
    (new_state, derot, trace, bits), = out
    assert name == "qpsk_costas_tm" and moved == {name: 1}
    assert (args["zr"], args["zi"]) != (None, None) and args["det"] == det
    assert (args["T"], args["C"], args["trace_every"]) == (t, c, 16)
    for key in ("lev0", "locked0", "lev_out", "locked_out"):
        assert (args[key] is not None) == gear, key
    if gear:
        assert (args["lev0"], args["locked0"]) == (st.lev.data_ptr(),
                                                   st.locked.data_ptr())
        assert args["lev_out"] == new_state.lev.data_ptr()
    assert args["gains"] == (g.data_ptr() if gains else None)
    assert args["nsf"] == (t // nf if gains else 0)
    assert (args["outr"], args["outi"], args["bits"]) == (
        derot.re.data_ptr(), derot.im.data_ptr(), bits.data_ptr())
    assert tuple(bits.shape) == (c, bps * t) and bits.dtype == torch.int32
    assert tuple(trace.shape) == (c, t // 16)
    params = np.ctypeslib.as_array((ctypes.c_float * 9).from_address(
        args["params"]))
    consts = np.ctypeslib.as_array((ctypes.c_float * 49).from_address(
        args["dd"]))
    assert params[:2].all() and params[4:].any() == gear
    assert consts.any() == (kind is not None)


def _jax_viterbi_gate(code) -> bool:
    """``qpsk_tpu/packet/fec.py``'s dispatch to the Pallas kernel."""
    return 8 % code.rate_den == 0 and code.nstates % 16 == 0


@pytest.mark.parametrize("k", range(5, 16))
def test_viterbi_covers_the_tpu_gate(k):
    rng = np.random.default_rng(k)
    for rd in (1, 2, 4, 8):
        for _ in range(4):
            polys = tuple(int(g) | 1 | (1 << (k - 1))
                          for g in rng.integers(0, 1 << k, rd))
            code = ConvCode(constraint=k, polys=polys)
            assert _jax_viterbi_gate(code)
            assert viterbi_kernel.coverage(code) is None, code
    code = ConvCode(constraint=16, polys=(0o100003, 0o170001))
    assert viterbi_kernel.coverage(code)[0] == "constraint"


# the largest even k <= 512 the TPU gate admits at each variable degree
# (none past 256 at dv 7 and 8)
_GATE_EDGE_K = {2: 442, 3: 396, 4: 362, 5: 334, 6: 312}


@pytest.mark.parametrize("dv", range(2, 9))
def test_ldpc_covers_the_tpu_gate(dv):
    """Every code of the grid the gate admits, the gate's largest code at
    this degree, and past the general instance's 512 checks the field."""
    admitted = 0
    for k in list(range(64, 513, 64)) + [_GATE_EDGE_K.get(dv, 64)]:
        _, _, dmax = jldpc._edges(k, dv, 1)
        if dmax * k * 2 * k * 4 <= 6 * 1024 * 1024:
            admitted += 1
            assert ldpc_kernel.coverage(LdpcCode(k, dv=dv)) is None, (k, dv)
    assert admitted > 0
    if dv != 3:
        assert ldpc_kernel.coverage(LdpcCode(576, dv=dv))[0] == "m"


def _cpu_pcm(cfg, c=2, nframes=3, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(0, 6000, (c, nframes, cfg.frame_size))
                            .astype(np.int16))


@pytest.mark.parametrize("fields", [{}, {"agc": True}, {"rs": 1200.0},
                                    {"modulation": "8psk"}])
def test_plain_switches_equal_auto_on_cpu(fields):
    """``costas_impl="scan"``, ``frontend_impl="xla"`` and ``tx_impl="xla"``
    run the plain versions, which CPU tensors run under "auto" too: equal
    outputs and state, bit for bit."""
    auto = ModemConfig(**fields)
    plain = dataclasses.replace(auto, costas_impl="scan", frontend_impl="xla",
                                tx_impl="xla")
    pcm = _cpu_pcm(auto)
    outs = [rx_stream(cfg, rx_init(cfg, (2,), device="cpu"), pcm)
            for cfg in (auto, plain)]
    for a, b in zip(outs[0][1], outs[1][1]):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    bits = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, (2, 3, auto.bits_per_frame), dtype=np.int32))
    tx = [tx_stream(cfg, tx_init(cfg, (2,), device="cpu"), bits, 50.0)[1]
          for cfg in (auto, plain)]
    assert torch.equal(tx[0], tx[1])


@pytest.mark.parametrize("field", ["costas_impl", "frontend_impl", "tx_impl"])
def test_pallas_switch_raises_on_cpu(field):
    """"pallas" asks for the kernel, which runs only on the card."""
    cfg = dataclasses.replace(ModemConfig(), **{field: "pallas"})
    with pytest.raises(RuntimeError, match=field):
        if field == "tx_impl":
            tx_stream(cfg, tx_init(cfg, (1,), device="cpu"),
                      torch.zeros((1, 1, 256), dtype=torch.int32))
        else:
            rx_stream(cfg, rx_init(cfg, (1,), device="cpu"),
                      torch.zeros((1, 1, 512), dtype=torch.int16))


def test_costas_pallas_raises_on_cpu_directly():
    z = torch.zeros((16, 1))
    with pytest.raises(RuntimeError, match="costas_impl"):
        costas_kernel.costas_run_tm(costas_init((1,), device="cpu"), z, z,
                                    costas_params(0.06), 16, impl="pallas")


@pytest.mark.parametrize("field,value", [("costas_impl", "xla"),
                                         ("frontend_impl", "scan"),
                                         ("tx_impl", "mosaic")])
def test_unknown_switch_value_raises(field, value):
    """As ``qpsk_tpu/config.py`` does: each field takes its own names."""
    with pytest.raises(ValueError, match=field):
        ModemConfig(**{field: value})


def test_decoder_impl_switches():
    """``viterbi_decode(impl="scan")`` and ``ldpc_decode(impl="xla")`` equal
    "auto" on CPU tensors; an unknown impl raises."""
    rng = np.random.default_rng(4)
    conv = ConvCode()
    u = torch.from_numpy(rng.integers(0, 2, (3, 32), dtype=np.int32))
    llrs = (1.0 - 2.0 * conv_encode(conv, u)) + torch.from_numpy(
        rng.normal(0, 0.8, (3, 2 * 38)).astype(np.float32))
    assert torch.equal(viterbi_decode(conv, llrs, 32, impl="scan"),
                       viterbi_decode(conv, llrs, 32))
    code = LdpcCode(64)
    c = ldpc_encode(code, torch.from_numpy(rng.integers(0, 2, (3, 64),
                                                        dtype=np.int32)))
    ll = (1.0 - 2.0 * c) + torch.from_numpy(
        rng.normal(0, 0.7, (3, 128)).astype(np.float32))
    assert torch.equal(ldpc_decode(code, ll, impl="xla"), ldpc_decode(code, ll))
    with pytest.raises(ValueError):
        viterbi_decode(conv, llrs, 32, impl="pallas2")
    with pytest.raises(ValueError):
        ldpc_decode(code, ll, impl="scan")
