"""Numpy twins of the RX front-end kernel's arithmetic (``csrc/frontend.cu``),
held on the CPU to the plain versions the kernel is compared with on the
card:

(a) the carried state the kernel computes itself, its float64 angles and
    pinned float32 products, against ``ops/frontend.py``'s ``unmix_tail``,
    ``remix_tail`` and ``advance_phase``;
(b) the FIR as the kernel runs it on the tensor cores: the taps padded at
    the front with zeros to 129 behind a 128-sample halo, a Toeplitz
    product in 16-wide k-tiles over the band, each tile x_lo*h_hi +
    x_hi*h_lo + x_hi*h_hi with the operands split into float16 hi + lo
    (round to nearest even), accumulated in float32 tile by tile; then
    power timing and the pick phasor of the plain chain.  Against
    ``frontend_xla`` on a loopback stimulus, at the default geometry, 1200
    baud, 4800 baud (2 samples per symbol), 63 taps and 256- and
    1024-sample frames: picks within 3e-4 and equal timing indices; and
    the split exact where it must be (int16 / 2^14 = hi + lo).
"""

import numpy as np
import pytest
import torch

from qpsk_tpu_torch import ModemConfig, rx_init, tx_init, tx_stream
from qpsk_tpu_torch.channel import awgn_pcm
from qpsk_tpu_torch.config import config_1200
from qpsk_tpu_torch.ops import frontend as fe
from qpsk_tpu_torch.ops import timing as timing_ops
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk

torch.set_num_threads(2)

F32 = np.float32
HALO, FSZ = 126, 512        # the default config's carried tail and frame
KT = 129                    # the kernel's tap count, a 128-sample halo


def _phasor(ang):
    """csrc/frontend.cu ``phasor``: a float64 angle reduced to [0, 2 pi),
    float32 cosine and sine."""
    two_pi = 2.0 * np.pi
    ang = ang - two_pi * np.floor(ang * (1.0 / two_pi))
    return np.cos(ang).astype(F32), np.sin(ang).astype(F32)


def _cmul(ar, ai, er, ei):
    """``cmul_pinned``: every product and sum rounded to float32."""
    return (F32(ar) * er - F32(ai) * ei).astype(F32), \
        (F32(ar) * ei + F32(ai) * er).astype(F32)


def _state(c, seed):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, c)
    p0 = (np.cos(ang).astype(F32), np.sin(ang).astype(F32))
    tail = rng.normal(size=(2, c, HALO)).astype(F32) * F32(0.3)
    return p0, tail


@pytest.mark.parametrize("nframes", [1, 8, 70000])
def test_kernel_carried_state_matches_the_plain_helpers(nframes):
    cfg = ModemConfig()
    omega = float(-cfg.omega_center)
    c = 5
    (pr0, pi0), tail = _state(c, nframes)
    n = nframes * FSZ
    phase0 = CF32(torch.from_numpy(pr0), torch.from_numpy(pi0))

    # unmix: raw[k] = tail.re * pr + tail.im * pi, offsets k - 125
    er, ei = _phasor(omega * (np.arange(HALO, dtype=np.float64) - (HALO - 1)))
    pr, pi = _cmul(pr0[:, None], pi0[:, None], er, ei)
    raw = (tail[0] * pr + tail[1] * pi).astype(F32)
    want = fe.unmix_tail(CF32(torch.from_numpy(tail[0]),
                              torch.from_numpy(tail[1])), phase0, omega)
    np.testing.assert_allclose(raw, want.numpy(), rtol=0, atol=1e-6)

    # remix: last_raw * phasor at offsets n - 126 + k + 1
    last = (np.random.default_rng(1).integers(-32768, 32768, (c, HALO))
            .astype(F32) * F32(1.0 / cfg.pcm_scale))
    er, ei = _phasor(omega * (n - HALO + np.arange(HALO, dtype=np.float64)
                              + 1.0))
    pr, pi = _cmul(pr0[:, None], pi0[:, None], er, ei)
    got = ((last * pr).astype(F32), (last * pi).astype(F32))
    want = fe.remix_tail(torch.from_numpy(last), phase0, omega, n)
    np.testing.assert_allclose(got[0], want.re.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1], want.im.numpy(), rtol=0, atol=1e-6)

    # advance: normalize(phase0 * e^{j omega n})
    er, ei = _phasor(np.float64(omega) * n)
    ar, ai = _cmul(pr0, pi0, er, ei)
    inv = (F32(1.0) / np.sqrt((ar * ar + ai * ai).astype(F32))).astype(F32)
    want = fe.advance_phase(phase0, omega, n)
    np.testing.assert_allclose((ar * inv).astype(F32), want.re.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose((ai * inv).astype(F32), want.im.numpy(),
                               rtol=0, atol=1e-6)


def _split(x):
    """``split`` of csrc/frontend.cu: float16 hi, then the float32
    remainder in float16."""
    hi = np.asarray(x, F32).astype(np.float16)
    lo = (np.asarray(x, F32) - hi.astype(F32)).astype(np.float16)
    return hi.astype(F32), lo.astype(F32)


def _tc_fir(window, h):
    """(..., 128 + fsz) float32 windows -> (..., fsz) outputs of one
    modulated-tap plane (``h``: 129 taps), as the kernel's band of m16n8k16
    tiles: output s sits at column n = s % 32 of row block s0 = s - n;
    k-tile kt covers window columns s0 + 16kt .. +15 and meets n-tile
    n // 8 when -8 <= 16kt - 8(n // 8) <= 128."""
    fsz = window.shape[-1] - (KT - 1)
    xh, xl = _split(window)
    hh, hl = _split(h)
    s = np.arange(fsz)
    n = s % 32
    acc = np.zeros(window.shape[:-1] + (fsz,), F32)
    for kt in range(10):
        d = 16 * kt - 8 * (n // 8)
        live = (d >= -8) & (d <= 128)
        j = 16 * kt + np.arange(16)[None, :]                # (1, 16)
        k = j - n[:, None]                                  # tap (fsz, 16)
        ok = (k >= 0) & (k < KT) & live[:, None]
        kk = np.clip(k, 0, KT - 1)
        col = (s - n)[:, None] + j                          # window (fsz, 16)
        for a, b in ((xl, hh), (xh, hl), (xh, hh)):
            prod = a[..., col].astype(np.float64) * np.where(ok, b[kk], 0.0)
            acc = np.where(live, (acc + prod.sum(-1)).astype(F32), acc)
    return acc


_TWIN_CFGS = {"2400": ModemConfig(), "1200": config_1200(),
              "rs=4800": ModemConfig(rs=4800.0),
              "ntaps=63": ModemConfig(ntaps=63),
              "frame_size=256": ModemConfig(frame_size=256),
              "frame_size=1024": ModemConfig(frame_size=1024)}


@pytest.mark.parametrize("cfg", list(_TWIN_CFGS.values()),
                         ids=list(_TWIN_CFGS))
def test_split_precision_fir_holds_frontend_xla(cfg):
    c, nframes = 3, 4
    gen = torch.Generator().manual_seed(5)
    bits = torch.randint(0, 2, (c, nframes + 1, cfg.bits_per_frame),
                         generator=gen, dtype=torch.int32)
    _, clean = tx_stream(cfg, tx_init(cfg, (c,), device="cpu"), bits,
                         tx_offset_hz=50.0)
    power = float(((clean.to(torch.float32) / cfg.pcm_scale) ** 2).mean())
    pcm = awgn_pcm(gen, clean, 10.0, power, cfg.pcm_scale)
    # a warm state: one plain call, then the frames under test
    st = rx_init(cfg, (c,), device="cpu")
    _, _, phase0, tail = fk.frontend_xla(cfg, pcm[:, :1].contiguous(),
                                         st.nco_phase, st.fir_tail)
    body = pcm[:, 1:].contiguous()
    want, want_index, _, _ = fk.frontend_xla(cfg, body, phase0, tail)

    omega = float(-cfg.omega_center)
    raw = fe.unmix_tail(tail, phase0, omega).numpy()
    x = body.numpy().astype(F32).reshape(c, -1) * F32(1.0 / cfg.pcm_scale)
    assert np.array_equal(sum(_split(x)), x)       # hi + lo is exact
    fsz, halo = cfg.frame_size, KT - 1
    flat = np.concatenate([np.zeros((c, halo - raw.shape[1]), F32), raw, x],
                          axis=1)
    windows = np.stack([flat[:, f * fsz:f * fsz + halo + fsz]
                        for f in range(nframes)], axis=1)   # (C, F, 128+fsz)
    hm, _, gain, _ = fk._launch_consts(cfg)       # the taps the kernel gets
    hm = np.concatenate([np.zeros((2, KT - cfg.ntaps), F32), hm], axis=1)
    y = CF32(*(torch.from_numpy(_tc_fir(windows, h) * F32(gain)) for h in hm))
    picks_u, index = timing_ops.estimate_and_decimate(y, cfg.cycles)
    got = fe.rotate_picks(picks_u, index, phase0, omega, fsz, cfg.cycles)
    np.testing.assert_array_equal(index.numpy(), want_index.numpy())
    for a, b in ((got.re, want.re), (got.im, want.im)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=3e-4)


def _general_twin(cfg, pcm, phase0, tail, delay):
    """``frontend_general_kernel<TM>`` in numpy for one call: per channel
    and frame, the window of the frame's outputs with its 128-sample halo
    (the carried tail un-mixed in frame 0, the previous frame's PCM
    after), the FIR as float32 sums over the 129 front-padded taps in
    order, the phase energies summed per chunk of cycles * (1024 //
    cycles) outputs (each phase's lane partial sums, the 32-lane xor
    tree, then the chunks in order), the first maximum, the picks rotated
    by phase0 (x) e^{j*omega*(pos+1)} (float64 angle); then the one-frame
    delay into (T, C) planes and each output frame's power by the pairing
    tree with its odd residue summed in order.  Returns (zr, zi, index,
    powers)."""
    c, nframes, fsz = pcm.shape
    cyc, nsym, h = cfg.cycles, cfg.symbols_per_frame, cfg.ntaps - 1
    hm, omega, gain, inv_scale = fk._launch_consts(cfg)
    hm = np.concatenate([np.zeros((2, KT - cfg.ntaps), F32), hm], axis=1)
    gain, inv_scale = F32(gain), F32(inv_scale)
    x = pcm.astype(F32) * inv_scale                         # (C, F, fsz)
    pr0, pi0 = phase0
    er, ei = _phasor(omega * (np.arange(h, dtype=np.float64) - (h - 1)))
    pr, pi = _cmul(pr0[:, None], pi0[:, None], er, ei)
    raw = (tail[0] * pr + tail[1] * pi).astype(F32)
    halo0 = np.concatenate([np.zeros((c, KT - 1 - h), F32), raw], axis=1)
    ch = cyc * (1024 // cyc)
    index = np.zeros((c, nframes), np.int32)
    picks = np.zeros((2, c, nframes, nsym), F32)
    for f in range(nframes):
        halo = halo0 if f == 0 else x[:, f - 1, fsz - (KT - 1):]
        win = np.concatenate([halo, x[:, f]], axis=1)       # (C, 128 + fsz)
        y = []
        for plane in hm:
            acc = np.zeros((c, fsz), F32)
            for k in range(KT):
                acc = (acc + plane[k] * win[:, k:k + fsz]).astype(F32)
            y.append((acc * gain).astype(F32))
        e = (y[0] * y[0] + y[1] * y[1]).astype(F32)
        esum = np.zeros((c, cyc), F32)
        for s0 in range(0, fsz, ch):
            chunk = e[:, s0:s0 + ch]
            for p in range(cyc):
                vals = chunk[:, p::cyc]
                lanes = np.zeros((c, 32), F32)
                for j in range(0, vals.shape[1], 32):
                    part = vals[:, j:j + 32]
                    lanes[:, :part.shape[1]] = (lanes[:, :part.shape[1]]
                                                + part).astype(F32)
                for o in (16, 8, 4, 2, 1):
                    lanes = (lanes + lanes[:, np.arange(32) ^ o]).astype(F32)
                esum[:, p] = (esum[:, p] + lanes[:, 0]).astype(F32)
        p = np.argmax(esum, axis=1)                          # first max
        index[:, f] = p
        pos = f * fsz + cyc * np.arange(nsym)[None, :] + p[:, None] + 1
        fr_, fi_ = _phasor(omega * pos.astype(np.float64))
        fr = (pr0[:, None] * fr_ - pi0[:, None] * fi_).astype(F32)
        fi = (pr0[:, None] * fi_ + pi0[:, None] * fr_).astype(F32)
        at = cyc * np.arange(nsym)[None, :] + p[:, None]
        ur = np.take_along_axis(y[0], at, 1)
        ui = np.take_along_axis(y[1], at, 1)
        picks[0, :, f] = ur * fr - ui * fi
        picks[1, :, f] = ur * fi + ui * fr
    frames = [np.concatenate([d[:, None], pk[:, :-1]], axis=1)
              for d, pk in zip(delay, picks)]                # (C, F, nsym)

    def tree(v):
        n = v.shape[-1]
        while n > 1 and n % 2 == 0:
            v = (v[..., :n // 2] + v[..., n // 2:n]).astype(F32)
            n //= 2
        s = v[..., 0]
        for i in range(1, n):
            s = (s + v[..., i]).astype(F32)
        return (s * F32(1.0 / nsym)).astype(F32)
    powers = tree((frames[0] * frames[0] + frames[1] * frames[1]).astype(F32))
    return (frames[0].reshape(c, -1).T, frames[1].reshape(c, -1).T, index,
            powers)


_GENERAL_CFGS = {"rs=3200,384": ModemConfig(rs=3200.0, frame_size=384),
                 "rs=600,2048": ModemConfig(rs=600.0, frame_size=2048),
                 "4096": ModemConfig(frame_size=4096),
                 "1536,agc": ModemConfig(frame_size=1536, agc=True)}


@pytest.mark.parametrize("cfg", list(_GENERAL_CFGS.values()),
                         ids=list(_GENERAL_CFGS))
def test_general_instance_twin_holds_the_plain_version(cfg):
    """The general instance's schedule against ``rx_frontend_tm_plain`` on a
    warm state: equal timing indices, picks within 3e-4, and its powers
    the bits of ``agc._frame_power`` of its own picks (the odd residue of
    384 symbols included) and within 1e-4 relative of the plain one's."""
    from qpsk_tpu_torch.ops import agc
    assert fk.coverage(cfg) is None
    assert not fk._fast(cfg, cfg.agc)
    c, nframes = 2, 2
    gen = torch.Generator().manual_seed(9)
    bits = torch.randint(0, 2, (c, nframes + 1, cfg.bits_per_frame),
                         generator=gen, dtype=torch.int32)
    _, clean = tx_stream(cfg, tx_init(cfg, (c,), device="cpu"), bits,
                         tx_offset_hz=50.0)
    power = float(((clean.to(torch.float32) / cfg.pcm_scale) ** 2).mean())
    pcm = awgn_pcm(gen, clean, 10.0, power, cfg.pcm_scale)
    st = rx_init(cfg, (c,), device="cpu")
    p = fk.rx_frontend_tm_plain(cfg, pcm[:, :1].contiguous(), st.nco_phase,
                                st.fir_tail, st.decim_delay)
    body = pcm[:, 1:].contiguous()
    want = fk.rx_frontend_tm_plain(cfg, body, p[3], p[4], p[5])
    zr, zi, index, powers = _general_twin(
        cfg, body.numpy(), (p[3].re.numpy(), p[3].im.numpy()),
        (p[4].re.numpy(), p[4].im.numpy()),
        (p[5].re.numpy(), p[5].im.numpy()))
    np.testing.assert_array_equal(index, want[2].numpy())
    np.testing.assert_allclose(zr, want[0].numpy(), rtol=0, atol=3e-4)
    np.testing.assert_allclose(zi, want[1].numpy(), rtol=0, atol=3e-4)
    own = agc.frame_powers_tm(torch.from_numpy(np.ascontiguousarray(zr)),
                              torch.from_numpy(np.ascontiguousarray(zi)),
                              nframes)
    np.testing.assert_array_equal(powers, own.numpy())
    if cfg.agc:
        np.testing.assert_allclose(powers, want[6].numpy(), rtol=1e-4)
