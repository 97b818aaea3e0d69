"""Closed-form carrier mixer (port of ``qpsk_tpu.ops.nco``, "fast" mode).

The reference's sequential phasor product is a geometric series, so the
mixer is ``phase0 * exp(j * omega * (1 + arange(n)))`` with the ramp
designed in float64 on the host, and one unit phasor carried per channel.
"""

from __future__ import annotations

import numpy as np
import torch

from qpsk_tpu_torch.ops.cplx import CF32, cmul, cnormalize


def nco_init(batch_shape=(), device=None) -> CF32:
    """phase = 1 + 0j."""
    return CF32(torch.ones(batch_shape, dtype=torch.float32, device=device),
                torch.zeros(batch_shape, dtype=torch.float32, device=device))


def mix(x: CF32, phase: CF32, omega: float):
    """Mix ``x`` (..., n) with the NCO at ``omega`` rad/sample, advancing
    the phasor before each sample and renormalizing the carry at block end.
    Returns (y, new_phase)."""
    n = x.shape[-1]
    steps = np.arange(1, n + 1, dtype=np.float64)
    dev = x.re.device
    ramp = CF32(torch.from_numpy(np.cos(omega * steps).astype(np.float32)).to(dev),
                torch.from_numpy(np.sin(omega * steps).astype(np.float32)).to(dev))
    phasors = cmul(CF32(phase.re[..., None], phase.im[..., None]), ramp)
    y = cmul(x, phasors)
    return y, cnormalize(CF32(phasors.re[..., -1], phasors.im[..., -1]))
