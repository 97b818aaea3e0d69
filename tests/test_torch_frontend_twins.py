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


# csrc/frontend.cu's general instance: outputs a chunk, the shared memory
# a frame's outputs may stay in, the squares of a frame kept in shared
# memory at most, symbols a round of picks (the layout's buffer)
GCH, GRES_BYTES, GSQ, GPR = 512, 227 * 1024, 512, 128


def _general_resident(fsz, cyc, power):
    """``GenLayout(fsz, cyc, nsym, true, sq_smem).bytes <= GRES_BYTES``:
    whether a frame's outputs stay in shared memory (one FIR pass)."""
    nsym = fsz // cyc
    sq = (8 * nsym * 4 + 15) // 16 * 16 if power and nsym <= GSQ else 0
    ys = fsz + 8
    return (2 * 8 * GCH * 2 + 8 * 128 * 2 + 2 * 8 * (GCH + KT + 7) * 2
            + 2 * 8 * ys * 4 + (8 * cyc * 4 + 15) // 16 * 16 + 8 * 32 * 4
            + sq + 2 * 8 * (GPR + 4) * 4 + 2 * (KT - 1) * 4
            + (2 * KT * 4 + 15) // 16 * 16 + 2 * 8 * 4) <= GRES_BYTES


def _seq_sum(v):
    """float32 sums of the last axis in order, from 0."""
    if v.shape[-1] == 0:
        return np.zeros(v.shape[:-1], F32)
    return np.cumsum(v, axis=-1, dtype=F32)[..., -1]


def _general_energies(y, cyc):
    """The phase energies of ``frontend_general_kernel``.  Below 32 samples
    per symbol, K = 32 // cyc lanes a phase: slot (p, part) sums |y|^2 in
    order over the frame at each chunk's (GCH outputs) outputs of phase p
    from the part-th on, every K-th, and a phase's K slots are added in
    order; from 32 on, each chunk's outputs of phase p are summed in order
    and the chunks' sums added in order."""
    y0, y1 = y
    c, fsz = y0.shape
    e = ((y0 * y0).astype(F32) + (y1 * y1).astype(F32)).astype(F32)
    k = 1 if cyc >= 32 else 32 // cyc
    esum = np.zeros((c, cyc), F32)
    for p in range(cyc):
        parts = [[] for _ in range(k)]
        for s_c in range(0, fsz, GCH):
            chunk = e[:, s_c:s_c + GCH]
            first = (p - s_c % cyc) % cyc
            for part in range(k):
                parts[part].append(chunk[:, first + cyc * part::cyc * k])
        if k == 1:
            for v in parts[0]:
                esum[:, p] = (esum[:, p] + _seq_sum(v)).astype(F32)
            continue
        sums = [_seq_sum(np.concatenate(v, axis=1)) for v in parts]
        tot = sums[0]
        for v in sums[1:]:
            tot = (tot + v).astype(F32)
        esum[:, p] = tot
    return esum


def _general_picks(y, p, f, fsz, cyc, p0, omega, resident):
    """The picks y[cyc*i + p] rotated as the kernel's lanes rotate them:
    per chunk (the whole frame when its outputs stay resident), lane l
    walks the symbols I0 + l + 32m, I0 = the chunk's first sample //
    cyc, the angle of its first in float64, then a float32 step of 32
    symbols, and rotates those whose sample cyc*i + p is in the chunk."""
    c = y[0].shape[0]
    nsym = fsz // cyc
    pr0, pi0 = p0
    sr, si = _phasor(np.float64(omega) * (32.0 * cyc))
    out = np.zeros((2, c, nsym), F32)
    spans = [(0, fsz)] if resident else [
        (s_c, min(GCH, fsz - s_c)) for s_c in range(0, fsz, GCH)]
    for ch in range(c):
        for s_c, n in spans:
            i0, i1 = s_c // cyc, min(nsym, (s_c + n + cyc - 1) // cyc)
            lo = (s_c - p[ch] + cyc - 1) // cyc
            hi = min(nsym, (s_c + n - p[ch] + cyc - 1) // cyc)
            for lane in range(32):
                er, ei = _phasor(omega * np.float64(
                    f * fsz + cyc * (i0 + lane) + p[ch] + 1))
                fr = F32(pr0[ch] * er - pi0[ch] * ei)
                fi = F32(pr0[ch] * ei + pi0[ch] * er)
                for i in range(i0 + lane, i1, 32):
                    if lo <= i < hi:
                        s = cyc * i + p[ch]
                        ur, ui = y[0][ch, s], y[1][ch, s]
                        out[0, ch, i] = ur * fr - ui * fi
                        out[1, ch, i] = ur * fi + ui * fr
                    fr, fi = F32(fr * sr - fi * si), F32(fr * si + fi * sr)
    return out


def _general_twin(cfg, pcm, phase0, tail, delay):
    """``frontend_general_kernel<TM>`` in numpy for one call: per channel
    and frame, the window of the frame's outputs with its 128-sample halo
    (the carried tail un-mixed in frame 0, the previous frame's PCM
    after), the three-pass float16 tensor-core FIR of the fast instances
    (``_tc_fir``, which each chunk's row blocks reproduce), the phase
    energies in the kernel's order (``_general_energies``), the first
    maximum, the picks rotated lane by lane (``_general_picks``); then the
    one-frame delay into (T, C) planes and each output frame's power by
    the pairing tree with its odd residue summed in order (a warp's tree in
    shared memory or in the scratch row, the same sums).  Returns (zr, zi,
    index, powers)."""
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
    resident = _general_resident(fsz, cyc, bool(cfg.agc))
    index = np.zeros((c, nframes), np.int32)
    picks = np.zeros((2, c, nframes, nsym), F32)
    for f in range(nframes):
        halo = halo0 if f == 0 else x[:, f - 1, fsz - (KT - 1):]
        win = np.concatenate([halo, x[:, f]], axis=1)       # (C, 128 + fsz)
        y = [(_tc_fir(win, plane) * gain).astype(F32) for plane in hm]
        p = np.argmax(_general_energies(y, cyc), axis=1)    # first max
        index[:, f] = p
        picks[:, :, f] = _general_picks(y, p, f, fsz, cyc, phase0, omega,
                                        resident)
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
                 "1536,agc": ModemConfig(frame_size=1536, agc=True),
                 "rs=1600,384": ModemConfig(rs=1600.0, frame_size=384),
                 "rs=1600,768": ModemConfig(rs=1600.0, frame_size=768),
                 "rs=4800,2048": ModemConfig(rs=4800.0, frame_size=2048),
                 "4096,agc": ModemConfig(frame_size=4096, agc=True)}


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
