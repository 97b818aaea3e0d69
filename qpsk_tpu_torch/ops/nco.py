"""Carrier mixers (port of ``qpsk_tpu.ops.nco``).

``mode="fast"``: the reference's sequential phasor product is a geometric
series, so the mixer is ``phase0 * exp(j * omega * (1 + arange(n)))`` with
the ramp designed in float64 on the host, and one unit phasor carried per
channel.  ``mode="exact"``: the C float32 recursion ``phase *= rect`` a
sample at a time (qpsk.c:115, 248-251), renormalized once at the end of
the block (qpsk.c:120, 253), for parity with the reference; it runs as a
Python loop over the samples, one complex product of (...,) tensors a
step.  ``mix_chirp``: a linearly chirping carrier, the quadratic-phase
closed form, for the Doppler-ramp stimulus.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qpsk_tpu_torch.ops.cplx import CF32, cmul, cnormalize


def nco_init(batch_shape=(), device=None) -> CF32:
    """phase = 1 + 0j."""
    return CF32(torch.ones(batch_shape, dtype=torch.float32, device=device),
                torch.zeros(batch_shape, dtype=torch.float32, device=device))


def _phasors(theta: np.ndarray, device) -> CF32:
    """exp(j theta) of (n,) float64 phases, rounded to float32 planes."""
    return CF32(torch.from_numpy(np.cos(theta).astype(np.float32)).to(device),
                torch.from_numpy(np.sin(theta).astype(np.float32)).to(device))


@functools.lru_cache(maxsize=64)
def _ramp(omega: float, n: int, device) -> CF32:
    """The fast mode's ramp exp(j omega (1 + arange(n))), made once a
    device: a call then copies nothing to the card."""
    return _phasors(omega * np.arange(1, n + 1, dtype=np.float64), device)


def _ramp_mix(x: CF32, phase: CF32, ramp: CF32):
    """``x * phase * ramp`` and the renormalized last phasor."""
    phasors = cmul(CF32(phase.re[..., None], phase.im[..., None]), ramp)
    y = cmul(x, phasors)
    return y, cnormalize(CF32(phasors.re[..., -1], phasors.im[..., -1]))


def mix(x: CF32, phase: CF32, omega: float, mode: str = "fast"):
    """Mix ``x`` (..., n) with the NCO at ``omega`` rad/sample, advancing
    the phasor before each sample and renormalizing the carry at block end.
    ``phase`` broadcasts over the leading axes.  Returns (y, new_phase)."""
    n = x.shape[-1]
    if mode == "fast":
        return _ramp_mix(x, phase, _ramp(float(omega), n, x.re.device))
    if mode != "exact":
        raise ValueError(f"unknown nco mode {mode!r}")
    rect = CF32(float(np.float32(np.cos(omega))),
                float(np.float32(np.sin(omega))))
    shape = torch.broadcast_shapes(x.shape[:-1], phase.re.shape) + (n,)
    pr = torch.empty(shape, dtype=torch.float32, device=x.re.device)
    pi = torch.empty_like(pr)
    ph = CF32(phase.re.expand(shape[:-1]), phase.im.expand(shape[:-1]))
    for k in range(n):
        ph = cmul(ph, rect)
        pr[..., k] = ph.re
        pi[..., k] = ph.im
    return cmul(CF32(pr, pi), x), cnormalize(ph)


def mix_chirp(x: CF32, phase: CF32, omega: float, domega: float):
    """Mix with a linearly chirping carrier, ``theta_k = omega*(k+1) +
    0.5*domega*k^2``, the same advance-before-multiply convention as
    ``mix``.  The carried phase is exact only within one call (the
    frequency at the block end is not folded back into ``omega``)."""
    k = np.arange(x.shape[-1], dtype=np.float64)
    return _ramp_mix(x, phase, _phasors(omega * (k + 1.0) + 0.5 * domega * k * k,
                                        x.re.device))
