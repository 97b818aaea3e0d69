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
