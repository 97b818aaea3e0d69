"""The port's scale-out receive (``qpsk_tpu_torch.parallel.channels`` and
``.stream``) in four gloo ranks against the JAX package's
(``qpsk_tpu.parallel``) on a four-device CPU mesh, on the same PCM.

One module-scoped fixture makes the inputs (numpy seeds, the port's TX),
starts four worker processes that import only the port, joined on a
``FileStore`` under ``tmp_path`` (no ports; ``torch_dist_common.
spawn_ranks``), each case run once, and saves
what rank 0 gathered (``dist.all_gather_into_tensor``).  The tests then
hold those results against JAX, each case naming its JAX counterpart:

* the time-sharded front-end, fast and ``fir_precision="exact"``, within
  2e-4 of JAX ``rx_frontend_timeparallel`` and of the port's serial mix
  and FIR (``tests/test_parallel.py:59``); on a one-rank sub-mesh equal
  to the serial one within 2e-4;
* the channel-sharded receive (8 channels x 3 frames) against the port's
  unsharded ``rx_stream`` (bits equal, symbols within 1e-6) and JAX's
  (bits equal, symbols within 1e-4), QPSK and 8PSK (``:70``, ``:125``),
  and its soft LLRs within 1e-5 of the unsharded ones (``:147``);
* ``rx_stream_timeparallel`` at 16 frames over 4 ranks against JAX's:
  bits equal, symbols within 1e-4, each rank's loop frequency within 1e-4
  rad/symbol of JAX's and 10 Hz of +50 (``:88``), also in gear
  (``loop_bw_track > 0``); fractional timing within 15 Hz
  (``tests/test_review_regressions.py:115``);
* the burst decode at 32 frames: every CRC-passing packet of each block
  bit-exact, at least one a block (``tests/test_parallel.py:88-122``);
* the halo exchange itself, and the ``ValueError``s.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from qpsk_tpu import ModemConfig as JCfg
from qpsk_tpu import rx_init as j_rx_init
from qpsk_tpu.modem import rx_stream as j_rx_stream
from qpsk_tpu.parallel.stream import (
    rx_frontend_timeparallel as j_frontend_tp,
    rx_stream_timeparallel as j_stream_tp)
from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream, tx_init, tx_stream
from qpsk_tpu_torch.modem import _tmat
from qpsk_tpu_torch.ops import nco
from qpsk_tpu_torch.ops import rrc as rrc_ops
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.modmap import demod_soft
from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
from qpsk_tpu_torch.sync import extract_packets, find_sync
from torch_dist_common import WORLD, spawn_ranks

torch.set_num_threads(2)

SPAWN_TIMEOUT_S = 170
PCFG = PacketConfig(payload_bytes=30)
GEAR = dict(loop_bw_track=2.0 * math.pi / 200.0)
# name -> ModemConfig fields of the sp receive cases
SP_CASES = {"power": {}, "gear": GEAR,
            "fractional": dict(timing_mode="fractional")}

_WORKER = r'''
from qpsk_tpu_torch import ModemConfig
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.modmap import demod_soft
from qpsk_tpu_torch.parallel.channels import (init_channels,
                                              make_channel_demod,
                                              shard_channel_state)
from qpsk_tpu_torch.parallel.stream import (_halo_from_left,
                                            rx_frontend_timeparallel,
                                            rx_stream_timeparallel)
from qpsk_tpu_torch.state import rx_init

GEAR = dict(loop_bw_track=2.0 * np.pi / 200.0)
SP_CASES = {"power": {}, "gear": GEAR,
            "fractional": dict(timing_mode="fractional")}

inp = {k: torch.from_numpy(v) for k, v in
       np.load(os.path.join(io, "inputs.npz")).items()}
out = {}


def refused(name, fn):
    try:
        fn()
    except ValueError as e:
        out["refused_" + name] = np.asarray(str(e))


sp = multihost.global_mesh(("sp",), device="cpu")
dp = multihost.global_mesh(("dp",), device="cpu")

# the halo: rank r receives rank r-1's tail, rank 0 zeros
tail = torch.full((2, 126), float(rank + 1))
halo, reqs = _halo_from_left(tail, sp, "sp")
for req in reqs:
    req.wait()
out["halo"] = gather(halo[None])

for prec in ("fast", "exact"):
    cfg = ModemConfig(fir_precision=prec)
    y = rx_frontend_timeparallel(cfg, inp["fe16"], sp)
    out[f"fe_{prec}_re"], out[f"fe_{prec}_im"] = gather(y.re), gather(y.im)
with multihost.first_ranks_mesh(1, "sp") as one:
    if rank == 0:
        y = rx_frontend_timeparallel(ModemConfig(), inp["fe16"], one)
        out["fe_one_re"], out["fe_one_im"] = y.re.numpy(), y.im.numpy()

for mod in ("qpsk", "8psk"):
    cfg = ModemConfig(modulation=mod)
    demod = make_channel_demod(cfg, dp)
    st, o = demod(init_channels(cfg, 8, dp), inp["dp_" + mod])
    out[f"dp_{mod}_bits"] = gather(o.bits)
    out[f"dp_{mod}_re"] = gather(o.symbols.re)
    out[f"dp_{mod}_im"] = gather(o.symbols.im)
    out[f"dp_{mod}_freq"] = gather(st.costas.freq)

cfg = ModemConfig()
st = shard_channel_state(rx_init(cfg, (8,), device="cpu"), dp)
_, o = make_channel_demod(cfg, dp)(st, inp["dp_soft"])
c = o.symbols.re.shape[0]
out["dp_soft_llr"] = gather(demod_soft(CF32(o.symbols.re.reshape(c, -1),
                                            o.symbols.im.reshape(c, -1))))

for name, fields in SP_CASES.items():
    sym, bits, hz = rx_stream_timeparallel(ModemConfig(**fields),
                                           inp["sp_" + name], sp)
    out[f"sp_{name}_re"], out[f"sp_{name}_im"] = gather(sym.re), gather(sym.im)
    out[f"sp_{name}_bits"], out[f"sp_{name}_hz"] = gather(bits), gather(hz)

_, bits, hz = rx_stream_timeparallel(cfg, inp["burst"], sp)
out["burst_bits"], out["burst_hz"] = gather(bits), gather(hz)

refused("modulation", lambda: rx_stream_timeparallel(
    ModemConfig(modulation="8psk"), inp["sp_power"], sp))
refused("length", lambda: rx_stream_timeparallel(
    cfg, inp["sp_power"][:3 * cfg.frame_size], sp))
refused("frontend_length", lambda: rx_frontend_timeparallel(
    cfg, inp["sp_power"][:1001], sp))
refused("channels", lambda: init_channels(cfg, 6, dp))
refused("demod_channels", lambda: make_channel_demod(cfg, dp)(
    init_channels(cfg, 8, dp), inp["dp_qpsk"][:6]))

if rank == 0:
    np.savez(os.path.join(io, "out.npz"), **out)
'''


def _tx(nframes, seed, snr_db=None):
    """(payload (nframes, 240), int16 (nframes * 512,)): packets -> the
    port's TX at +50 Hz -> numpy AWGN at ``snr_db`` if given."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (nframes, 240), dtype=np.int32)
    cfg = ModemConfig()
    _, pcm = tx_stream(cfg, tx_init(cfg, device="cpu"),
                       assemble_packet(PCFG, torch.from_numpy(payload)),
                       tx_offset_hz=50.0)
    x = pcm.numpy().reshape(-1)
    if snr_db is not None:
        xf = x.astype(np.float64)
        sigma = np.sqrt((xf ** 2).mean() / 10.0 ** (snr_db / 10.0))
        x = np.clip(np.round(xf + rng.normal(size=x.shape) * sigma),
                    -32768, 32767).astype(np.int16)
    return payload, x


def _inputs() -> dict:
    rng = np.random.default_rng(2)
    inp = {"fe16": _tx(16, 1)[1],
           "burst_payload": _tx(32, 3)[0], "burst": _tx(32, 3)[1]}
    for k, name in enumerate(("qpsk", "8psk", "soft")):
        inp["dp_" + name] = rng.integers(-8192, 8192, (8, 3, 512),
                                         dtype=np.int16)
    for k, name in enumerate(SP_CASES):
        inp["sp_" + name] = _tx(16, 5 + k, snr_db=10.0)[1]
    return inp


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """(inputs, rank 0's gathered results) of every case."""
    d = tmp_path_factory.mktemp("torch_parallel")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    spawn_ranks(_WORKER, d, SPAWN_TIMEOUT_S)
    with np.load(d / "out.npz") as f:
        return inp, dict(f.items())


def _jmesh(axis):
    return Mesh(np.asarray(jax.devices()[:WORLD]), (axis,))


def _serial_frontend(cfg, pcm):
    """The port's whole-stream mix-down + matched filter, one process."""
    x = torch.from_numpy(pcm).to(torch.float32) / float(cfg.pcm_scale)
    y, _ = nco.mix(CF32(x, torch.zeros_like(x)), nco.nco_init((), "cpu"),
                   -cfg.omega_center, "fast")
    blk = rrc_ops.pick_block(pcm.size)
    y, _ = rrc_ops.fir_block(y, rrc_ops.fir_init_tail(cfg.ntaps, (), "cpu"),
                             _tmat(cfg, blk, "cpu"), cfg.gain, blk,
                             exact=cfg.fir_precision == "exact")
    return y.re.numpy(), y.im.numpy()


def test_halo_reaches_the_right_neighbour(ran):
    _, out = ran
    halo = out["halo"]
    assert halo.shape == (WORLD, 2, 126)
    for r in range(WORLD):
        np.testing.assert_array_equal(halo[r], float(r) if r else 0.0)


@pytest.mark.parametrize("prec", ["fast", "exact"])
def test_frontend_timeparallel_matches_serial_and_jax(ran, prec):
    inp, out = ran
    re, im = out[f"fe_{prec}_re"], out[f"fe_{prec}_im"]
    sr, si = _serial_frontend(ModemConfig(fir_precision=prec), inp["fe16"])
    y = j_frontend_tp(JCfg(fir_precision=prec), jnp.asarray(inp["fe16"]),
                      _jmesh("sp"))
    assert re.shape == sr.shape == (16 * 512,)
    for got, want in ((re, sr), (im, si), (re, np.asarray(y.re)),
                      (im, np.asarray(y.im))):
        np.testing.assert_allclose(got, want, atol=2e-4)
    print(f"{prec}: largest difference from the serial front-end "
          f"{max(np.abs(re - sr).max(), np.abs(im - si).max()):.3g}, "
          f"from JAX {np.abs(re - np.asarray(y.re)).max():.3g}")


def test_frontend_on_one_rank_is_serial(ran):
    inp, out = ran
    sr, si = _serial_frontend(ModemConfig(), inp["fe16"])
    np.testing.assert_allclose(out["fe_one_re"], sr, atol=2e-4)
    np.testing.assert_allclose(out["fe_one_im"], si, atol=2e-4)


@pytest.mark.parametrize("mod", ["qpsk", "8psk"])
def test_channel_demod_matches_unsharded_and_jax(ran, mod):
    inp, out = ran
    pcm = inp["dp_" + mod]
    cfg, jcfg = ModemConfig(modulation=mod), JCfg(modulation=mod)
    st, ref = rx_stream(cfg, rx_init(cfg, (8,), device="cpu"),
                        torch.from_numpy(pcm))
    np.testing.assert_array_equal(out[f"dp_{mod}_bits"], ref.bits.numpy())
    np.testing.assert_allclose(out[f"dp_{mod}_re"], ref.symbols.re.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(out[f"dp_{mod}_im"], ref.symbols.im.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(out[f"dp_{mod}_freq"], st.costas.freq.numpy(),
                               atol=1e-6)
    _, jref = jax.jit(lambda s, x: j_rx_stream(jcfg, s, x))(
        j_rx_init(jcfg, batch_shape=(8,)), jnp.asarray(pcm))
    np.testing.assert_array_equal(out[f"dp_{mod}_bits"], np.asarray(jref.bits))
    np.testing.assert_allclose(out[f"dp_{mod}_re"],
                               np.asarray(jref.symbols.re), atol=1e-4)


def test_channel_demod_soft_llrs_match_unsharded(ran):
    inp, out = ran
    cfg = ModemConfig()
    _, ref = rx_stream(cfg, rx_init(cfg, (8,), device="cpu"),
                       torch.from_numpy(inp["dp_soft"]))
    llr = demod_soft(CF32(ref.symbols.re.reshape(8, -1),
                          ref.symbols.im.reshape(8, -1)))
    assert out["dp_soft_llr"].shape == tuple(llr.shape)
    np.testing.assert_allclose(out["dp_soft_llr"], llr.numpy(), atol=1e-5)


@pytest.mark.parametrize("case", sorted(SP_CASES))
def test_stream_timeparallel_matches_jax(ran, case):
    inp, out = ran
    fields = SP_CASES[case]
    jsym, jbits, jhz = j_stream_tp(JCfg(**fields),
                                   jnp.asarray(inp["sp_" + case]),
                                   _jmesh("sp"))
    bits, hz = out[f"sp_{case}_bits"], out[f"sp_{case}_hz"]
    assert bits.shape == (16 * 256,) and bits.dtype == np.int32
    assert hz.shape == (WORLD,)
    np.testing.assert_array_equal(bits, np.asarray(jbits))
    np.testing.assert_allclose(out[f"sp_{case}_re"], np.asarray(jsym.re),
                               atol=1e-4)
    np.testing.assert_allclose(out[f"sp_{case}_im"], np.asarray(jsym.im),
                               atol=1e-4)
    rs = ModemConfig().rs
    np.testing.assert_allclose(hz, np.asarray(jhz),
                               atol=1e-4 * rs / (2.0 * math.pi))
    np.testing.assert_allclose(hz, 50.0,
                               atol=15.0 if case == "fractional" else 10.0)


def test_stream_timeparallel_burst_packets(ran):
    """4 time blocks of 8 frames: each block re-acquires, and every
    CRC-passing packet is one its block sent, bit-exact."""
    inp, out = ran
    bits, hz = out["burst_bits"], out["burst_hz"]
    np.testing.assert_allclose(hz, 50.0, atol=10.0)
    fpb = 32 // WORLD
    blocks = bits.reshape(WORLD, fpb * 256)
    want = inp["burst_payload"].reshape(WORLD, fpb, 240)
    for b in range(WORLD):
        stream = torch.from_numpy(blocks[b])
        sync = find_sync(PCFG, stream, max_lag=512, probe_frames=2)
        assert int(sync.score) > 0, b
        navail = (stream.shape[0] - int(sync.bit_lag)) // PCFG.frame_bits
        rx = extract_packets(PCFG, stream, sync, navail)
        ok, got = rx.crc_ok.numpy(), rx.payload_bits.numpy()
        assert ok.sum() >= 1, b
        for i in np.flatnonzero(ok):
            assert any(np.array_equal(got[i], want[b, j])
                       for j in range(fpb)), (b, i)


@pytest.mark.parametrize("case, words", [
    ("modulation", "QPSK-only"), ("length", "multiple of"),
    ("frontend_length", "multiple of"), ("channels", "do not divide"),
    ("demod_channels", "do not divide")])
def test_refusals(ran, case, words):
    _, out = ran
    assert "refused_" + case in out, case
    assert words in str(out["refused_" + case])
