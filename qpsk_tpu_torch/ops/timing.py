"""Symbol timing estimation and decimation (port of ``qpsk_tpu.ops.timing``).

Estimators over ``(..., frame_size)`` matched-filter output:

* ``timing_power``: the phase with the largest mean squared envelope
  (Oerder & Meyr style), first maximum winning ties; the default.
* ``timing_histogram``: the C reference's amplitude-histogram estimator,
  quirks included (qpsk.c:131-180): leaky I/Q averages never reset within
  a frame, running maxima updated before the thresholds, 8 buckets with
  bucket 0 unused, first-wins argmax.  A loop over the symbols of a frame.
* ``timing_fractional``: the O&M fractional estimate in samples, in
  [0, cycles), decimated by Catmull-Rom interpolation
  (``decimate_fractional``).
* ``timing_track*``: a second-order frame-rate PLL on the fractional
  estimate (``(tau, dtau)`` carried), which follows a sample-clock *rate*
  offset.

``decimate_select`` takes an index in [0, 2*cycles): the histogram can
pick up to 7 at 4 samples per symbol, which reads into the next symbol
group (the last group clamps to itself, where the C code reads past the
frame).
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from qpsk_tpu_torch.ops.cplx import CF32, cabs2


def timing_power(frames: CF32, cycles: int) -> torch.Tensor:
    """argmax_p mean |x[i*cycles + p]|^2 over (..., frame_size) frames."""
    nsym = frames.shape[-1] // cycles
    energy = cabs2(frames).reshape(frames.shape[:-1] + (nsym, cycles)).mean(
        dim=-2)
    return torch.argmax(energy, dim=-1).to(torch.int32)


def timing_histogram(frames: CF32, cycles: int) -> torch.Tensor:
    """The reference's histogram timing index (int32, batch-shaped)."""
    batch = frames.shape[:-1]
    nsym = frames.shape[-1] // cycles
    sum_i = frames.re.abs().reshape(batch + (nsym, cycles)).sum(-1)
    sum_q = frames.im.abs().reshape(batch + (nsym, cycles)).sum(-1)
    dev = frames.re.device
    ks = torch.arange(1, 8, dtype=torch.float32, device=dev)   # buckets 1..7
    slots = torch.arange(8, device=dev)

    def bucket_add(hist, av, mx):
        hv = mx / 8.0
        cond = av[..., None] <= hv[..., None] * ks             # (..., 7)
        hit = cond.any(dim=-1)
        k = 1 + torch.argmax(cond.to(torch.int32), dim=-1)     # first hit
        onehot = (slots == k[..., None]).to(torch.float32)
        return hist + onehot * hit[..., None].to(torch.float32)

    zeros = torch.zeros(batch, dtype=torch.float32, device=dev)
    av_i = av_q = max_i = max_q = zeros
    hist_i = hist_q = torch.zeros(batch + (8,), dtype=torch.float32,
                                  device=dev)
    for s in range(nsym):
        av_i = (av_i + sum_i[..., s]) / cycles      # leaky average
        av_q = (av_q + sum_q[..., s]) / cycles
        max_i = torch.maximum(max_i, av_i)          # max updated first
        max_q = torch.maximum(max_q, av_q)
        hist_i = bucket_add(hist_i, av_i, max_i)
        hist_q = bucket_add(hist_q, av_q, max_q)
    hist = hist_i + hist_q
    idx = torch.argmax(hist, dim=-1)
    return torch.where(hist.amax(dim=-1) > 0, idx, 0).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _om_tables(n: int, cycles: int, device) -> tuple:
    """cos and sin of -2 pi k / cycles over a frame of n samples, float32,
    made once a device."""
    arg = -2 * np.pi * np.arange(n) / cycles
    return tuple(torch.from_numpy(f(arg).astype(np.float32)).to(device)
                 for f in (np.cos, np.sin))


def timing_fractional(frames: CF32, cycles: int) -> torch.Tensor:
    """Oerder & Meyr fractional timing estimate in samples, in
    [0, cycles)."""
    e = cabs2(frames)
    cos_t, sin_t = _om_tables(frames.shape[-1], cycles, frames.re.device)
    cr = (e * cos_t).sum(dim=-1)
    ci = (e * sin_t).sum(dim=-1)
    tau = -torch.atan2(ci, cr) / (2.0 * np.pi) * cycles
    return torch.remainder(tau, float(cycles))


def timing_track_init(batch_shape=(), device="cuda"):
    """State of the frame-rate timing PLL: (tau samples, dtau samples a
    frame), both float32."""
    shape = tuple(batch_shape)
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


def _wrap_half_cycle(x: torch.Tensor, cycles: int) -> torch.Tensor:
    """Wrap a timing error into [-cycles/2, cycles/2): tau is circular."""
    h = cycles / 2.0
    return torch.remainder(x + h, float(cycles)) - h


def timing_track_step(state, meas: torch.Tensor, cycles: int,
                      alpha: float = 0.5, beta: float = 0.08):
    """One update of the second-order timing loop on the frame's O&M
    measurement ``meas``: proportional gain ``alpha`` on the phase,
    integral gain ``beta`` on the clock rate.  Returns (tau_used (...,) in
    [0, cycles), new_state)."""
    tau, dtau = state
    e = _wrap_half_cycle(meas - tau, cycles)
    dtau = dtau + float(np.float32(beta)) * e
    tau_used = tau + float(np.float32(alpha)) * e
    tau_next = torch.remainder(tau_used + dtau, float(cycles))
    return torch.remainder(tau_used, float(cycles)), (tau_next, dtau)


def timing_track(frames: CF32, cycles: int, state, alpha: float = 0.5,
                 beta: float = 0.08):
    """The timing PLL over (..., nframes, frame_size) samples: every
    frame's measurement at once, then the scalar loop over the frames.
    Returns (tau_used (..., nframes), new_state)."""
    meas = timing_fractional(frames, cycles)            # (..., nframes)
    used = []
    for f in range(meas.shape[-1]):
        tau_used, state = timing_track_step(state, meas[..., f], cycles,
                                            alpha, beta)
        used.append(tau_used)
    return torch.stack(used, dim=-1), state


def decimate_select(frames: CF32, index: torch.Tensor, cycles: int) -> CF32:
    """Pick sample ``s*cycles + index`` of each symbol ``s``; ``index`` is
    batch-shaped over the frames and lies in [0, 2*cycles), and a pick
    past the frame end takes the last group's own sample."""
    fsz = frames.shape[-1]
    nsym = fsz // cycles
    base = torch.arange(nsym, device=frames.re.device) * cycles
    pos = base + index.long()[..., None]
    pos = torch.where(pos >= fsz, pos - cycles, pos)
    return CF32(torch.gather(frames.re, -1, pos),
                torch.gather(frames.im, -1, pos))


def decimate_fractional(frames: CF32, tau: torch.Tensor, cycles: int) -> CF32:
    """Decimation at a fractional phase ``tau`` (batch-shaped float32 in
    [0, cycles)): each symbol at ``s*cycles + tau`` by Catmull-Rom
    interpolation of the four integer phases around it."""
    i0 = torch.clamp(torch.floor(tau).to(torch.int32), 0, 2 * cycles - 2)
    mu = (tau - i0.to(torch.float32))[..., None]          # in [0, 1)
    w_m1 = 0.5 * (-mu ** 3 + 2 * mu ** 2 - mu)
    w_0 = 0.5 * (3 * mu ** 3 - 5 * mu ** 2 + 2)
    w_p1 = 0.5 * (-3 * mu ** 3 + 4 * mu ** 2 + mu)
    w_p2 = 0.5 * (mu ** 3 - mu ** 2)

    def pick(idx):
        return decimate_select(frames, torch.clamp(idx, 0, 2 * cycles - 1),
                               cycles)
    pm1, p0, pp1, pp2 = pick(i0 - 1), pick(i0), pick(i0 + 1), pick(i0 + 2)
    return CF32(w_m1 * pm1.re + w_0 * p0.re + w_p1 * pp1.re + w_p2 * pp2.re,
                w_m1 * pm1.im + w_0 * p0.im + w_p1 * pp1.im + w_p2 * pp2.im)


def decimate_delayed(frame: CF32, delay: CF32, index: torch.Tensor,
                     cycles: int):
    """One pick a symbol at phase ``index`` through the reference's
    one-frame delay line (qpsk.c:182-191).  Returns (the previous frame's
    symbols ``delay``, this frame's picks to carry)."""
    return delay, decimate_select(frame, index, cycles)


def estimate_and_decimate(frames: CF32, cycles: int, mode: str = "power"):
    """The configured estimator and its decimation over (..., nframes,
    frame_size) samples.  Returns (picks (..., nframes, nsym), index (...,
    nframes) int32).  ``"tracking"`` has no carry here: it warns and runs
    the feedforward fractional estimate, as the JAX package does; the
    stateful loop is ``timing_track``."""
    if mode in ("histogram", "power"):
        index = (timing_histogram if mode == "histogram"
                 else timing_power)(frames, cycles)
        return decimate_select(frames, index, cycles), index
    if mode not in ("fractional", "tracking"):
        raise ValueError(f"unknown timing mode {mode!r}")
    if mode == "tracking":
        warnings.warn(
            "timing_mode='tracking' has no cross-block carry on this path: "
            "degrading to the feedforward 'fractional' estimator, which "
            "does not follow sample-clock *rate* offsets",
            RuntimeWarning, stacklevel=2)
    tau = timing_fractional(frames, cycles)
    return (decimate_fractional(frames, tau, cycles),
            torch.round(tau).to(torch.int32))
