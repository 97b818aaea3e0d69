"""Blind CMA channel equalizer with frame-rate block updates (port of
``qpsk_tpu.ops.equalizer``).

A symbol-spaced constant-modulus equalizer on the decimated symbols before
the Costas loop: CMA's cost ``(|y|^2 - R)^2`` is carrier-phase invariant,
so it converges on the still-rotating symbols.  Within a frame the outputs
``y_i = sum_k w_k x_{i-k}`` and the CMA gradient are batched over the
symbols; the taps update once per frame.  The state is ``(w, hist)``: the
taps and the previous frame's last L-1 symbols.

There is no kernel here: the frame loop is a Python loop of small torch ops
over ``(C, .)`` tensors, the same on the card and on the CPU.
"""

from __future__ import annotations

import torch

from qpsk_tpu_torch.ops.cplx import CF32, czeros


def eq_init(taps: int, batch_shape=(), device="cuda") -> tuple:
    """(w, hist): center-spike taps (w[taps // 2] = 1) and zero history."""
    if taps < 1:
        raise ValueError(f"taps={taps} must be >= 1")
    batch_shape = tuple(batch_shape)
    w = czeros(batch_shape + (taps,), device)
    w.re[..., taps // 2] = 1.0
    return (w, czeros(batch_shape + (taps - 1,), device))


def _filter_frame(w: CF32, xext: CF32, nsym: int, taps: int) -> CF32:
    """y_i = sum_k w_k * x_{i-k} over one tail-extended frame
    (xext = [hist | frame]), as L shifted slice multiplies."""
    yr = torch.zeros(xext.shape[:-1] + (nsym,), dtype=torch.float32,
                     device=xext.re.device)
    yi = torch.zeros_like(yr)
    for k in range(taps):
        s = taps - 1 - k
        xr, xi = xext.re[..., s:s + nsym], xext.im[..., s:s + nsym]
        wr, wi = w.re[..., k:k + 1], w.im[..., k:k + 1]
        yr = yr + wr * xr - wi * xi
        yi = yi + wr * xi + wi * xr
    return CF32(yr, yi)


def cma_frame(state: tuple, frame: CF32, mu: float, modulus2: float):
    """Equalize one ``(..., nsym)`` frame with the incoming taps, then
    apply one normalized block-CMA update.  Returns (new_state, y)."""
    w, hist = state
    taps = w.shape[-1]
    nsym = frame.shape[-1]
    xext = CF32(torch.cat([hist.re, frame.re], dim=-1),
                torch.cat([hist.im, frame.im], dim=-1))
    y = _filter_frame(w, xext, nsym, taps)

    # e_i = y_i (|y_i|^2 - R); gradient g_k = sum_i e_i conj(x_{i-k})
    err = (y.re * y.re + y.im * y.im) - modulus2
    er, ei = y.re * err, y.im * err
    xp = torch.mean(xext.re * xext.re + xext.im * xext.im, dim=-1,
                    keepdim=True) + 1e-6
    step = torch.full_like(xp, mu) / (float(nsym) * xp * xp)
    gr, gi = [], []
    for k in range(taps):
        s = taps - 1 - k
        xr, xi = xext.re[..., s:s + nsym], xext.im[..., s:s + nsym]
        gr.append(torch.sum(er * xr + ei * xi, dim=-1, keepdim=True))
        gi.append(torch.sum(ei * xr - er * xi, dim=-1, keepdim=True))
    new_w = CF32(w.re - step * torch.cat(gr, dim=-1),
                 w.im - step * torch.cat(gi, dim=-1))
    new_hist = CF32(xext.re[..., nsym:], xext.im[..., nsym:])
    return (new_w, new_hist), y


def equalize_stream(state: tuple, frames: CF32, mu: float, modulus2: float):
    """Run the frame-rate CMA over ``(..., nframes, nsym)`` symbols.
    Returns (new_state, y (..., nframes, nsym))."""
    ys_r, ys_i = [], []
    for f in range(frames.shape[-2]):
        state, y = cma_frame(state, CF32(frames.re[..., f, :],
                                         frames.im[..., f, :]), mu, modulus2)
        ys_r.append(y.re)
        ys_i.append(y.im)
    return state, CF32(torch.stack(ys_r, dim=-2), torch.stack(ys_i, dim=-2))
