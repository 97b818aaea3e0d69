"""Numpy twin of the TX kernel's arithmetic (``csrc/tx.cu``), held on the
CPU to ``tx_modulate_plain``, the version the kernel is compared with on
the card:

(a) the symbol-major polyphase FIR as the kernel runs it on the tensor
    cores: tiles of 16 rows (row r holds the R = 8 / cycles symbols
    m0 + R*r + j), A[r, d] = sym[m0 + R*r + R-1 - d] with the history read
    from the carried tail's symbol lanes, B[d, q + cycles*j] =
    taps[ntaps-1 - cycles*(d + j - (R-1)) - q] scaled by the launch's
    power of two, both split into float16
    hi + lo (round to nearest even), three passes (lo*hi, hi*lo, hi*hi) a
    16-deep k-tile accumulated in float32; then the factored carrier
    phase0 (x) base (x) ramp, the base e^{j*omega*(cycles*m0 + 1)} of a
    tile reduced mod 2*pi in float64, the ramp of an offset designed in
    float64 and rounded; truncation and saturation to int16; and the
    carried phase and zero-stuffed tail the kernel writes.  At 2, 3, 4, 6
    and 8 samples per symbol, 63 and 127 taps, QPSK and 16QAM symbols, in
    two chained calls: PCM within 2 LSB, phase within 1e-5, tail exact.
(b) the carried phase and tail of one channel after a call of more than
    128 * 65 535 symbols, against the plain mixer's and the zero-stuff's
    formulas (the plain version cannot build that call's Toeplitz tile).
"""

import dataclasses

import numpy as np
import pytest
import torch

from qpsk_tpu_torch import ModemConfig, tx_init
from qpsk_tpu_torch.ops import frontend as fe
from qpsk_tpu_torch.ops import modfam
from qpsk_tpu_torch.ops.cplx import CF32, cnormalize
from qpsk_tpu_torch.ops.cuda import tx_kernel as tk
from qpsk_tpu_torch.ops.modmap import bits_to_symbols, upsample_zero_stuff

torch.set_num_threads(2)

F32 = np.float32
OFFSET_HZ = 50.0


def _split(x):
    """``split`` of csrc/tx.cu: float16 hi, then the float32 remainder in
    float16."""
    hi = np.asarray(x, F32).astype(np.float16)
    lo = (np.asarray(x, F32) - hi.astype(F32)).astype(np.float16)
    return hi.astype(F32), lo.astype(F32)


def _phasor(ang):
    """``phasor``: a float64 angle reduced to [0, 2 pi), float32 parts."""
    two_pi = 2.0 * np.pi
    ang = np.asarray(ang, np.float64)
    ang = ang - two_pi * np.floor(ang * (1.0 / two_pi))
    return np.cos(ang).astype(F32), np.sin(ang).astype(F32)


def _new_state(cfg, sym, tail, p0, omega):
    """``write_state``: the phase after the call and the last ntaps-1
    samples of [old tail | zero-stuffed symbols]."""
    c, s = sym[0].shape
    h, cyc, n = cfg.ntaps - 1, cfg.cycles, s * cfg.cycles
    er, ei = _phasor(np.float64(omega) * n)
    ar, ai = p0[0] * er - p0[1] * ei, p0[0] * ei + p0[1] * er
    inv = F32(1.0) / np.sqrt(ar * ar + ai * ai)
    phase = (ar * inv, ai * inv)
    new = []
    for plane, old in zip(sym, tail):
        out = np.zeros((c, h), F32)
        for k in range(h):
            if k + n < h:
                out[:, k] = old[:, k + n]
            elif (h - k) % cyc == 0:
                out[:, k] = plane[:, s - (h - k) // cyc]
        new.append(out)
    return phase, new


def _tx_twin(cfg, sym, tail, p0, omega):
    """``tx_kernel`` in numpy: (C, S) symbol planes, the carried tail
    planes and phase -> (PCM (C, S*cycles) int16, new phase, new tail)."""
    taps, gain = tk._launch_consts(cfg)
    ntaps, cyc = cfg.ntaps, cfg.cycles
    r_sym = 8 // cyc
    tile = 16 * r_sym
    hs = (ntaps - 1) // cyc
    nk = (hs + r_sym - 1) // 16 + 1
    c, s = sym[0].shape
    ntiles = -(-s // tile)

    # B (16*nk, 8): column n = q + cyc*j of a row
    d = np.arange(16 * nk)[:, None]
    n = np.arange(8)[None, :]
    k = ntaps - 1 - cyc * (d + n // cyc - (r_sym - 1)) - n % cyc
    live = (n < r_sym * cyc) & (k >= 0) & (k < ntaps)
    bmat = np.where(live, taps[np.clip(k, 0, ntaps - 1)], F32(0.0)).astype(F32)
    bh, bl = _split(bmat)

    # the symbol stream with its history: index m + off, off = 16*nk
    off = 16 * nk
    m0 = np.arange(ntiles) * tile
    first = m0[:, None] + r_sym * np.arange(16)[None, :]      # (T, 16)
    rows = first[..., None] + (r_sym - 1) - np.arange(16 * nk)  # (T, 16, 16nk)
    accs = []
    for plane, old in zip(sym, tail):
        stream = np.zeros((c, off + ntiles * tile), F32)
        stream[:, off:off + s] = plane
        for m in range(-hs, 0):
            stream[:, off + m] = old[:, ntaps - 1 + cyc * m]
        ah, al = _split(stream[:, rows + off])               # (C, T, 16, 16nk)
        acc = np.zeros((c, ntiles, 16, 8), F32)
        for kt in range(nk):
            ks = slice(16 * kt, 16 * kt + 16)
            for a, b in ((al, bh), (ah, bl), (ah, bh)):
                prod = a[..., ks].astype(np.float64) @ b[ks].astype(np.float64)
                acc = (acc + prod).astype(F32)
        accs.append(acc)

    # the carrier: phase0 (x) base (x) ramp
    br, bi = _phasor(np.float64(omega) * (cyc * m0.astype(np.float64) + 1.0))
    pbr = p0[0][:, None] * br[None] - p0[1][:, None] * bi[None]   # (C, T)
    pbi = p0[0][:, None] * bi[None] + p0[1][:, None] * br[None]
    o = cyc * r_sym * np.arange(16)[:, None] + np.arange(8)[None, :]
    rr, ri = _phasor(np.float64(omega) * o)                         # (16, 8)
    fr = pbr[..., None, None] * rr - pbi[..., None, None] * ri
    fi = pbr[..., None, None] * ri + pbi[..., None, None] * rr
    g = F32(gain)
    re = (accs[0] * g) * fr - (accs[1] * g) * fi
    v = np.clip(np.trunc(re * F32(cfg.pcm_scale)), -32768, 32767)

    # sample cyc*(m0 + R*r) + n of column n < R*cyc
    pcm = np.zeros((c, ntiles * tile * cyc), np.int16)
    samples = (cyc * first[..., None] + n[None]).reshape(-1)
    live = np.broadcast_to(n < r_sym * cyc, (ntiles, 16, 8)).reshape(-1)
    pcm[:, samples[live]] = v.reshape(c, -1)[:, live]
    phase, new_tail = _new_state(cfg, sym, tail, p0, omega)
    return pcm[:, :s * cyc], phase, new_tail


def _symbols(kind, c, s, rng):
    bits = torch.from_numpy(rng.integers(0, 2, (c, s * (2 if kind == "qpsk"
                                                       else 4)),
                                         dtype=np.int32))
    sym = (bits_to_symbols(bits) if kind == "qpsk" else
           modfam.bits_to_symbols_mod(bits, modfam.get(kind)))
    return CF32(sym.re.contiguous(), sym.im.contiguous())


_CFGS = {"cyc4": {}, "cyc2": {"rs": 4800.0}, "cyc8": {"rs": 1200.0}}


@pytest.mark.parametrize("kind", ["qpsk", "16qam"])
@pytest.mark.parametrize("ntaps", [63, 127])
@pytest.mark.parametrize("geom", list(_CFGS))
def test_tx_twin_holds_the_plain_version(geom, ntaps, kind):
    cfg = ModemConfig(ntaps=ntaps, **_CFGS[geom])
    _check_chained(cfg, kind, seed=ntaps + len(kind))


@pytest.mark.parametrize("rs,frame_size", [(3200.0, 384), (1600.0, 384)],
                         ids=["cyc3", "cyc6"])
def test_tx_twin_holds_the_plain_version_odd_rows(rs, frame_size):
    """3 and 6 samples per symbol: columns past R*cycles of a tile are
    dead (3: two symbols a row, 6: one)."""
    _check_chained(ModemConfig(rs=rs, frame_size=frame_size), "qpsk", seed=3)


def _check_chained(cfg, kind, seed):
    """Two chained calls (300 then 200 symbols, neither a whole number of
    tiles) from a random phase, the second from the plain version's
    state: PCM within 2 LSB, phase within 1e-5, tail exact."""
    rng = np.random.default_rng(seed)
    c = 3
    ang = rng.uniform(-np.pi, np.pi, c)
    st = tx_init(cfg, (c,), device="cpu")
    st = st._replace(nco_phase=CF32(torch.from_numpy(np.cos(ang).astype(F32)),
                                    torch.from_numpy(np.sin(ang).astype(F32))))
    omega = tk._omega(cfg, OFFSET_HZ)
    for s in (300, 200):
        sym = _symbols(kind, c, s, rng)
        pp, php, tlp = tk.tx_modulate_plain(cfg, sym, st.nco_phase,
                                            st.fir_tail, OFFSET_HZ)
        pcm, phase, tail = _tx_twin(
            cfg, (sym.re.numpy(), sym.im.numpy()),
            (st.fir_tail.re.numpy(), st.fir_tail.im.numpy()),
            (st.nco_phase.re.numpy(), st.nco_phase.im.numpy()), omega)
        worst = np.abs(pcm.astype(np.int32) - pp.numpy().astype(np.int32)).max()
        assert worst <= 2, worst
        np.testing.assert_allclose(phase[0], php.re.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(phase[1], php.im.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tail[0], tlp.re.numpy())
        np.testing.assert_array_equal(tail[1], tlp.im.numpy())
        st = st._replace(nco_phase=php, fir_tail=tlp)


@pytest.mark.parametrize("cycles_rs", [4800.0, 2400.0, 1200.0],
                         ids=["cyc2", "cyc4", "cyc8"])
def test_tx_twin_state_past_65535_blocks(cycles_rs):
    """One channel, S = 128 * 65 535 + 37 symbols: the kernel's carried
    phase (the call's n samples as a float64 angle reduced mod 2 pi)
    within 1e-5 of the plain mixer's (the last phasor of phase0 (x)
    e^{j*omega*t}, t = 1..n, renormalized) and of ``advance_phase``; its
    tail equal to the last ntaps-1 samples of the zero-stuffed symbols."""
    cfg = ModemConfig(rs=cycles_rs)
    s = 128 * 65535 + 37
    rng = np.random.default_rng(7)
    ang = rng.uniform(-np.pi, np.pi, 1)
    p0 = (np.cos(ang).astype(F32), np.sin(ang).astype(F32))
    omega = tk._omega(cfg, OFFSET_HZ)
    n = s * cfg.cycles
    last = _symbols("qpsk", 1, 64, rng)       # the call's last 64 symbols
    sym = tuple(np.zeros((1, s), F32) for _ in range(2))
    sym[0][:, -64:], sym[1][:, -64:] = last.re.numpy(), last.im.numpy()
    tail = tuple(np.zeros((1, cfg.ntaps - 1), F32) for _ in range(2))
    phase, new_tail = _new_state(cfg, sym, tail, p0, omega)

    # nco.mix's last phasor: the float64 ramp at step n, unreduced
    ramp = CF32(torch.tensor([np.float32(np.cos(omega * np.float64(n)))]),
                torch.tensor([np.float32(np.sin(omega * np.float64(n)))]))
    phase0 = CF32(torch.from_numpy(p0[0]), torch.from_numpy(p0[1]))
    mixed = cnormalize(CF32(phase0.re * ramp.re - phase0.im * ramp.im,
                            phase0.re * ramp.im + phase0.im * ramp.re))
    for want in (mixed, fe.advance_phase(phase0, omega, n)):
        np.testing.assert_allclose(phase[0], want.re.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(phase[1], want.im.numpy(), rtol=0,
                                   atol=1e-5)
    stuffed = upsample_zero_stuff(last, cfg.cycles)
    np.testing.assert_array_equal(new_tail[0], stuffed.re[:, -(cfg.ntaps - 1):])
    np.testing.assert_array_equal(new_tail[1], stuffed.im[:, -(cfg.ntaps - 1):])


def test_tx_coverage_names_the_field():
    """The kernels take every geometry the TPU gate takes: from 2 samples
    per symbol and a halo of at most 128 symbols (``tx_kernel<CYC>`` up to
    8 samples per symbol and 129 taps, the general instance beyond); past
    the halo the coverage names ``ntaps``, below 2 samples per symbol
    ``fs/rs``."""
    base = ModemConfig()
    for fields in ({}, {"rs": 4800.0}, {"rs": 1200.0}, {"ntaps": 63},
                   {"ntaps": 129}, {"rs": 3200.0, "frame_size": 384},
                   {"ntaps": 131}, {"rs": 600.0}, {"rs": 1200.0, "ntaps": 255}):
        assert tk.coverage(dataclasses.replace(base, **fields)) is None
    assert tk._fast(base) and not tk._fast(dataclasses.replace(base, ntaps=131))
    assert tk.coverage(dataclasses.replace(base, ntaps=1031))[0] == "ntaps"
    assert tk.coverage(ModemConfig(rs=9600.0, frame_size=512))[0] == "fs/rs"


def _tx_general_twin(cfg, sym, tail, p0, omega):
    """``tx_general_kernel`` in numpy: with the taps reversed, hr[j] =
    taps[ntaps-1 - j], the 8 samples t0..t0+7 of a lane (t0 a multiple of
    8) sum, newest symbol first, over the (ntaps + 6) // cycles + 1
    symbols m from floor((t0+7)/cycles) down, hr[t - cycles*m] * sym[m] as
    float32 multiply-adds (zero outside the taps; the history from the
    carried tail's symbol lanes); mixed by the carrier phase0 (x) base (x)
    ramp: the base e^{j*omega*(256*T + 1)} of the 256-sample step T in
    float64, the ramp e^{j*omega*o} of the offset o in it times gain *
    pcm_scale in float64, both rounded to float32; Re truncated and
    saturated; the state of ``write_state``."""
    taps = np.asarray(tk.rrc_ops.taps_for(cfg), F32)
    ntaps, cyc = cfg.ntaps, cfg.cycles
    hs = (ntaps - 1) // cyc
    nsy = (ntaps + 6) // cyc + 1
    c, s = sym[0].shape
    n = s * cyc
    hr = np.concatenate([taps[::-1], np.zeros(8 * cyc + 16, F32)])
    lanes = (ntaps - 1) + cyc * np.arange(-hs, 0)
    off = nsy + hs
    ext = [np.concatenate([np.zeros((c, nsy), F32), tl[:, lanes], x,
                           np.zeros((c, 8), F32)], axis=1)
           for x, tl in zip(sym, tail)]                 # symbol m at m + off
    t = np.arange(n)
    mh = (t - t % 8 + 7) // cyc
    yr, yi = np.zeros((c, n), F32), np.zeros((c, n), F32)
    for jj in range(nsy):
        m = mh - jj
        h = hr[t - cyc * m].astype(np.float64)      # t - cyc*m >= -7
        h[t - cyc * m < 0] = 0.0
        yr = (h * ext[0][:, m + off] + yr).astype(F32)
        yi = (h * ext[1][:, m + off] + yi).astype(F32)
    br, bi = _phasor(np.float64(omega) * (256.0 * (t // 256) + 1.0))
    pbr = (p0[0][:, None] * br - p0[1][:, None] * bi).astype(F32)
    pbi = (p0[0][:, None] * bi + p0[1][:, None] * br).astype(F32)
    ang = np.float64(omega) * (t % 256)
    gs = np.float64(F32(cfg.gain)) * np.float64(F32(cfg.pcm_scale))
    rr, ri = (np.cos(ang) * gs).astype(F32), (np.sin(ang) * gs).astype(F32)
    fr, fi = (pbr * rr - pbi * ri).astype(F32), (pbr * ri + pbi * rr).astype(F32)
    re = (yr * fr - yi * fi).astype(F32)
    pcm = np.clip(np.trunc(re), -32768, 32767)
    return (pcm.astype(np.int16),) + _new_state(cfg, sym, tail, p0, omega)


@pytest.mark.parametrize("fields", [{"rs": 600.0, "frame_size": 2048},
                                    {"rs": 1200.0, "ntaps": 255},
                                    {"ntaps": 131},
                                    {"rs": 960.0, "frame_size": 1280},
                                    {"rs": 3200.0, "ntaps": 201,
                                     "frame_size": 384}],
                         ids=["cyc16", "cyc8-ntaps255", "ntaps131",
                              "cyc10", "cyc3-ntaps201"])
def test_tx_general_twin_holds_the_plain_version(fields):
    """The general instance's arithmetic against ``tx_modulate_plain`` in
    two chained calls: PCM within 2 LSB, phase within 1e-5, tail exact."""
    cfg = ModemConfig(**fields)
    assert not tk._fast(cfg) and tk.coverage(cfg) is None
    rng = np.random.default_rng(cfg.cycles + cfg.ntaps)
    c = 2
    st = tx_init(cfg, (c,), device="cpu")
    omega = tk._omega(cfg, OFFSET_HZ)
    for s in (300, 200):
        sym = _symbols("qpsk", c, s, rng)
        pp, php, tlp = tk.tx_modulate_plain(cfg, sym, st.nco_phase,
                                            st.fir_tail, OFFSET_HZ)
        pcm, phase, tail = _tx_general_twin(
            cfg, (sym.re.numpy(), sym.im.numpy()),
            (st.fir_tail.re.numpy(), st.fir_tail.im.numpy()),
            (st.nco_phase.re.numpy(), st.nco_phase.im.numpy()), omega)
        worst = np.abs(pcm.astype(np.int32) - pp.numpy().astype(np.int32)).max()
        assert worst <= 2, worst
        np.testing.assert_allclose(phase[0], php.re.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tail[0], tlp.re.numpy())
        np.testing.assert_array_equal(tail[1], tlp.im.numpy())
        st = st._replace(nco_phase=php, fir_tail=tlp)
