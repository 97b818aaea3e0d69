"""The torch port's RX front-end (``ops/cuda/frontend_kernel.py``, its plain
version on CPU) against the JAX package: the Pallas tm kernel in interpret
mode and the staged ``frontend_xla`` chain plus the host delay concat.

Timing decisions must be equal; picks agree to 3e-4 (the JAX package's own
bound for re-associated carried phasors, tests/test_pallas_tm_path.py) and
the carried phase and tail to 1e-5.  The two frameworks sum the FIR in
different orders, so the floats are held close, not equal."""

import numpy as np
import pytest
import torch

import jax
from qpsk_tpu import ModemConfig as JCfg, rx_init as j_rx_init, tx_stream as j_tx_stream
from qpsk_tpu.modem import frontend_xla as j_frontend_xla, rx_stream as j_rx_stream
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu.ops.pallas.frontend_kernel import rx_frontend_fused_tm
from qpsk_tpu_torch import ModemConfig, rx_init
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.cuda.frontend_kernel import rx_frontend_tm
from qpsk_tpu_torch.state import from_numpy
from torch_kernel_recorder import recorder, routed

torch.set_num_threads(2)

CFG, JC = ModemConfig(), JCfg()
NSYM = CFG.symbols_per_frame


def _random_pcm(c, nframes, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-12000, 12000, (c, nframes, CFG.frame_size),
                        dtype=np.int16)


def _loopback_pcm(c, nframes, seed):
    """JAX TX at +50 Hz plus numpy AWGN at 10 dB."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (c, nframes, 2 * NSYM), dtype=np.int32)
    _, pcm = j_tx_stream(JC, jax.tree.map(np.asarray, _tx_init(c)), bits,
                         tx_offset_hz=50.0)
    pcm = np.asarray(pcm).astype(np.float64)
    sigma = np.sqrt((pcm ** 2).mean() / 10.0)
    noisy = np.round(pcm + rng.normal(size=pcm.shape) * sigma)
    return np.clip(noisy, -32768, 32767).astype(np.int16)


def _tx_init(c):
    from qpsk_tpu import tx_init
    return tx_init(JC, batch_shape=(c,))


def _warm_state(pcm_head):
    """JAX and port RxState after one chained JAX call on ``pcm_head``."""
    c = pcm_head.shape[0]
    jst, _ = j_rx_stream(JC, j_rx_init(JC, batch_shape=(c,)), pcm_head)
    return jst, from_numpy(jax.tree.map(np.asarray, jst), device="cpu")


def _port(pcm, st):
    return rx_frontend_tm(CFG, torch.from_numpy(pcm), st.nco_phase,
                          st.fir_tail, st.decim_delay)


def _jax_xla_delayed(pcm, jst):
    """frontend_xla + the host delay concat, in the tm layout."""
    picks, idx, ph, tl = j_frontend_xla(JC, pcm, jst.nco_phase, jst.fir_tail)
    c = pcm.shape[0]

    def delayed(dd, p):
        z = np.concatenate([np.asarray(dd)[:, None], np.asarray(p)[:, :-1]], 1)
        return z.reshape(c, -1).T
    return (delayed(jst.decim_delay.re, picks.re),
            delayed(jst.decim_delay.im, picks.im), np.asarray(idx), ph, tl,
            JCF32(np.asarray(picks.re)[:, -1], np.asarray(picks.im)[:, -1]))


def _assert_close(port, ref):
    zr, zi, idx, ph, tl, dd, powers = port
    assert powers is None
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(zr.numpy(), np.asarray(ref[0]), atol=3e-4)
    np.testing.assert_allclose(zi.numpy(), np.asarray(ref[1]), atol=3e-4)
    np.testing.assert_allclose(dd.re.numpy(), np.asarray(ref[5].re), atol=3e-4)
    np.testing.assert_allclose(dd.im.numpy(), np.asarray(ref[5].im), atol=3e-4)
    for a, b in ((ph, ref[3]), (tl, ref[4])):
        np.testing.assert_allclose(a.re.numpy(), np.asarray(b.re), atol=1e-5)
        np.testing.assert_allclose(a.im.numpy(), np.asarray(b.im), atol=1e-5)


@pytest.mark.parametrize("stimulus", ["random", "loopback"])
def test_frontend_matches_pallas_tm_and_xla(stimulus):
    c, nframes = 128, 4
    make = _random_pcm if stimulus == "random" else _loopback_pcm
    pcm = make(c, nframes + 1, seed=1)
    jst, st = _warm_state(pcm[:, :1])
    body = np.ascontiguousarray(pcm[:, 1:])
    port = _port(body, st)
    assert port[0].shape == (nframes * NSYM, c) and port[2].dtype == torch.int32
    zr, zi, idx, ph, tl, dd, _ = rx_frontend_fused_tm(
        JC, body, jst.nco_phase, jst.fir_tail, jst.decim_delay,
        interpret=True)
    _assert_close(port, (zr, zi, idx, ph, tl, dd))
    _assert_close(port, _jax_xla_delayed(body, jst))


def test_frontend_odd_channel_count():
    """C = 3 (no multiple of anything): against the staged JAX chain."""
    pcm = _loopback_pcm(3, 4, seed=2)
    jst, st = _warm_state(pcm[:, :1])
    body = np.ascontiguousarray(pcm[:, 1:])
    _assert_close(_port(body, st), _jax_xla_delayed(body, jst))


def test_frontend_chains_across_calls():
    """Two chained calls == one call over the concatenation."""
    pcm = _random_pcm(8, 6, seed=3)
    _, st = _warm_state(pcm[:, :1])
    body = pcm[:, 1:]
    one = _port(np.ascontiguousarray(body), st)
    a = _port(np.ascontiguousarray(body[:, :2]), st)
    st2 = st._replace(nco_phase=a[3], fir_tail=a[4], decim_delay=a[5])
    b = _port(np.ascontiguousarray(body[:, 2:]), st2)
    np.testing.assert_array_equal(torch.cat([a[2], b[2]], 1).numpy(),
                                  one[2].numpy())
    for k in (0, 1):
        np.testing.assert_allclose(torch.cat([a[k], b[k]]).numpy(),
                                   one[k].numpy(), atol=3e-4)
    np.testing.assert_allclose(b[5].re.numpy(), one[5].re.numpy(), atol=3e-4)
    np.testing.assert_allclose(b[3].re.numpy(), one[3].re.numpy(), atol=1e-5)
    np.testing.assert_allclose(b[4].im.numpy(), one[4].im.numpy(), atol=1e-5)


def test_frontend_cpu_tensor_runs_plain_version():
    """A CPU tensor never reaches the kernel launch (no nvcc here)."""
    from qpsk_tpu_torch.ops.cuda import _lib
    before = dict(_lib.launches)
    pcm = _random_pcm(2, 1, seed=4)
    _, st = _warm_state(pcm)
    out = _port(pcm, st)
    assert _lib.launches == before
    assert isinstance(out[5], CF32) and out[0].shape == (NSYM, 2)


def _fast_launch(monkeypatch, cfg, c, nframes, tm=True, sms=132):
    """(C entry, its arguments by name, the launches counted) of one
    front-end launch of ``cfg`` over (c, nframes) through a recorder on a
    card of ``sms`` SMs."""
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk
    st = rx_init(cfg, (c,), device="cpu")
    pcm = torch.zeros((c, nframes, cfg.frame_size), dtype=torch.int16)
    return routed(monkeypatch, lambda: fk._launch(
        cfg, pcm, st.nco_phase, st.fir_tail, st.decim_delay if tm else None),
        sms)


def test_frontend_pipeline_takes_the_frames_its_ring_holds(monkeypatch):
    """The pipeline (``frontend_kernel_pipe``) takes frames up to 512
    samples (16 segments of 32 outputs, a FIR group's two accumulators) at
    2, 4 and 8 samples per symbol: it runs the default config (time-major,
    with the power output, channel-major at 4 and 8 samples per symbol)
    and every such geometry up to 512, launched as ``qpsk_frontend_pipe``
    with one block an SM; longer frames run the general instance
    (``qpsk_frontend_gen``).  Each launch passes the config's geometry and
    layout and is counted once under its entry."""
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk
    for cyc in (2, 4, 8):
        for fsz in range(128, 1665, 128):
            cfg = ModemConfig(rs=9600.0 / cyc, frame_size=fsz)
            assert fk._fast(cfg, False) == (fsz <= 512), (cyc, fsz)
    pipe, gen = "qpsk_frontend_pipe", "qpsk_frontend_gen"
    cases = ((ModemConfig(), True, pipe),
             (ModemConfig(agc=True), True, pipe),
             (ModemConfig(), False, pipe),
             (ModemConfig(rs=1200.0), False, pipe),
             (ModemConfig(rs=4800.0, frame_size=256), True, pipe),
             (ModemConfig(ntaps=63, frame_size=384), False, pipe),
             (ModemConfig(frame_size=640), True, gen),
             (ModemConfig(rs=4800.0, frame_size=640), True, gen),
             (ModemConfig(frame_size=1024, agc=True), True, gen),
             (ModemConfig(rs=1200.0, frame_size=1664), False, gen))
    for cfg, tm, entry in cases:
        name, args, moved = _fast_launch(monkeypatch, cfg, 200, 3, tm)
        assert name == entry and moved == {entry: 1}, (cfg, tm, name)
        assert (args["cycles"], args["ntaps"], args["fsz"], args["tm"]) == (
            cfg.cycles, cfg.ntaps, cfg.frame_size, int(tm))
        assert (args["power"] is not None) == (tm and cfg.agc)
        assert (args["dd_re"] is not None) == tm
        if entry == pipe:
            assert args["blocks"] == 75


@pytest.mark.parametrize("c", list(range(1, 41)) + [8192])
def test_frontend_pipeline_grid_walks_every_tile_once(monkeypatch, c):
    """The persistent grid is min(tiles, SMs); block b walks tiles
    [b T // B, (b + 1) T // B), frames fastest (``frontend_kernel_pipe``):
    every (channel group, frame) once, no block idle, at F = 1..9."""
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk
    groups = -(-c // 8)
    for nframes in range(1, 10):
        tiles = groups * nframes
        for sms in (132, 7, 1):
            b = fk._pipe_grid(c, nframes, sms)
            assert b == min(tiles, sms)
            seen = []
            for k in range(b):
                walk = range(tiles * k // b, tiles * (k + 1) // b)
                assert len(walk) >= 1
                seen += [(t // nframes, t % nframes) for t in walk]
            assert sorted(seen) == [(g, f) for g in range(groups)
                                    for f in range(nframes)]
    if c in (1, 7, 9, 8192):
        _, args, _ = _fast_launch(monkeypatch, ModemConfig(), c, 9)
        assert args["blocks"] == min(groups * 9, 132)


@pytest.mark.parametrize("offset", [0, 1, 8])
def test_frontend_kernel_gets_pcm_on_a_16_byte_boundary(monkeypatch, offset):
    """Every front-end instance reads the PCM in 16-byte copies, so the
    wrapper's input check (its launch plan's) hands on PCM that starts on
    a 16-byte boundary: the caller's tensor where it does, else a copy
    with the same samples (a view into a stream at ``offset`` samples)."""
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk
    recorder(monkeypatch)
    cfg = ModemConfig()
    c, nframes = 3, 2
    n = c * nframes * cfg.frame_size
    stream = torch.arange(n + offset, dtype=torch.int32).to(torch.int16)
    pcm = stream[offset:].view(c, nframes, cfg.frame_size)
    st = rx_init(cfg, (c,), device="cpu")
    plan = fk._plan(cfg, c, nframes, pcm.device, False)
    got, _ = plan.check(pcm, st.nco_phase, st.fir_tail)
    assert plan.pcm_shape == (c, nframes, cfg.frame_size)
    assert got.data_ptr() % 16 == 0
    assert (got is pcm) == (pcm.data_ptr() % 16 == 0)
    assert torch.equal(got, pcm)
