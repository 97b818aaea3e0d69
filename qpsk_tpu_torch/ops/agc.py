"""Frame-rate automatic gain control on the decimated symbols (port of
``qpsk_tpu.ops.agc``).

Each frame's mean power drives a one-pole estimate of the symbol RMS,
carried per channel across calls (0 = unset: the first frame seeds it), and
the frame is scaled by ``target / rms_est``.  The AGC normalizes links with
unknown audio levels before the amplitude-sensitive stages: the Costas
error gain and the CMA modulus.

The time-major path takes the frame powers from the front-end kernel and
hands the gains to the Costas kernel, which applies them in-register; the
composed path measures and scales the symbol planes here.  The two feed
the carrier loop the same bits only if the powers are bit-identical, so
``_frame_power`` is a fixed expression tree of elementwise ops (squares,
then a halves-pairing add tree), never ``torch.sum`` or ``mean``, whose
order is the library's; eager PyTorch launches one op per expression, so
nothing contracts ``a*a + b*b`` into an FMA.  ``csrc/frontend.cu`` computes
the same tree with round-to-nearest intrinsics.
"""

from __future__ import annotations

import numpy as np
import torch

from qpsk_tpu_torch.ops.cplx import CF32


def agc_init(batch_shape=(), device="cuda") -> torch.Tensor:
    """Carried smoothed symbol-RMS estimate; 0 = unset."""
    return torch.zeros(tuple(batch_shape), dtype=torch.float32, device=device)


def _frame_power(re: torch.Tensor, im: torch.Tensor,
                 dim: int = -1) -> torch.Tensor:
    """Mean |z|^2 over ``dim``: squares, then halves pairing
    ``p[:m/2] + p[m/2:m]`` while the count is even, then the odd residue
    (3 of a 384-symbol frame) summed in order, then ``* float32(1/n)``:
    the JAX package's tree, whose residue is a ``jnp.sum``."""
    p = re * re + im * im
    dim = dim % p.dim()
    n = p.shape[dim]
    if n < 1:
        raise ValueError("the frame power of an empty frame")
    inv = float(np.float32(1.0 / n))
    while n > 1 and n % 2 == 0:
        p = p.narrow(dim, 0, n // 2) + p.narrow(dim, n // 2, n // 2)
        n //= 2
    s = p.narrow(dim, 0, 1)
    for k in range(1, n):
        s = s + p.narrow(dim, k, 1)
    return s.squeeze(dim) * inv


def _est_update(rms_est: torch.Tensor, rms: torch.Tensor, mu: float):
    """One-pole smoothed-RMS update; a 0 estimate seeds from ``rms``."""
    d = mu * (rms - rms_est)
    return torch.where(rms_est > 0.0, rms_est + d, rms)


def _gain(est: torch.Tensor, target: float) -> torch.Tensor:
    # a true division (``scalar / tensor`` is reciprocal-then-multiply)
    return torch.full_like(est, target) / torch.clamp(est, min=1e-6)


def agc_frame(rms_est: torch.Tensor, frame: CF32, target: float, mu: float):
    """Scale one ``(..., nsym)`` frame by the estimate updated with its own
    power (the per-frame form of ``agc_stream``).  Returns (new_rms_est,
    scaled frame)."""
    rms = torch.sqrt(_frame_power(frame.re, frame.im) + 1e-12)
    est = _est_update(rms_est, rms, mu)
    gx = _gain(est, target)[..., None]
    return est, CF32(frame.re * gx, frame.im * gx)


def agc_gains(rms_est: torch.Tensor, power: torch.Tensor, target: float,
              mu: float):
    """The gain recursion over per-frame powers ``(..., nframes)``.
    Returns (new_rms_est, gains (..., nframes))."""
    gains = []
    for f in range(power.shape[-1]):
        rms = torch.sqrt(power[..., f] + 1e-12)
        rms_est = _est_update(rms_est, rms, mu)
        gains.append(_gain(rms_est, target))
    return rms_est, torch.stack(gains, dim=-1)


def agc_stream(rms_est: torch.Tensor, frames: CF32, target: float,
               mu: float):
    """Scale ``(..., nframes, nsym)`` symbols, frame by frame.  Returns
    (new_rms_est, scaled frames)."""
    rms_est, g = agc_gains(rms_est, _frame_power(frames.re, frames.im),
                           target, mu)
    gx = g[..., None]
    return rms_est, CF32(frames.re * gx, frames.im * gx)


def frame_powers_tm(zr_tm: torch.Tensor, zi_tm: torch.Tensor,
                    nframes: int) -> torch.Tensor:
    """(C, nframes) ``_frame_power`` of time-major ``(T, C)`` planes,
    reduced in that layout: the values of the channel-major reduction."""
    t, c = zr_tm.shape
    return _frame_power(zr_tm.reshape(nframes, t // nframes, c),
                        zi_tm.reshape(nframes, t // nframes, c), dim=1).T


def agc_gains_tm(rms_est: torch.Tensor, zr_tm: torch.Tensor,
                 zi_tm: torch.Tensor, nframes: int, target: float,
                 mu: float):
    """Per-frame gains from time-major ``(T, C)`` planes.  Returns
    (new_rms_est (C,), gains (nframes, C)), bit-identical to
    ``agc_stream``'s gains on the same symbols in channel-major layout."""
    rms_est, g = agc_gains(rms_est, frame_powers_tm(zr_tm, zi_tm, nframes),
                           target, mu)
    return rms_est, g.T.contiguous()
