"""Shared math for the mix-free RX front-end (port of
``qpsk_tpu.ops.frontend``).

With a constant-frequency NCO the carrier mix commutes with the matched
filter, so the filter runs on the raw real PCM with complex *modulated*
taps ``hm[k] = h[k] * e^{j*omega*(k - D)}`` and the carrier phasor
``phase0 * e^{j*omega*(pos+1)}`` is applied only at the decimated picks.
All tables are designed in float64 on the host.

The carried ``RxState.fir_tail`` stays in the *mixed* domain, as in the JAX
package; ``unmix_tail`` / ``remix_tail`` convert at the call boundary.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qpsk_tpu_torch.ops.cplx import CF32, cnormalize


@functools.lru_cache(maxsize=None)
def modulated_taps_np(taps_key: tuple, omega: float) -> np.ndarray:
    """(2, ntaps) float32 modulated taps, D = ntaps - 1."""
    taps = np.asarray(taps_key, np.float64)
    k = np.arange(taps.shape[0], dtype=np.float64) - (taps.shape[0] - 1)
    ang = omega * k
    return np.stack([taps * np.cos(ang), taps * np.sin(ang)]).astype(
        np.float32)


def _f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _tail_phasors(phase0: CF32, omega: float, offsets: np.ndarray):
    """phase0 (x) e^{j*omega*s} for a static vector of sample offsets."""
    ang = np.mod(omega * offsets, 2 * np.pi)
    tr = _f32(np.cos(ang), phase0.re.device)
    ti = _f32(np.sin(ang), phase0.re.device)
    pr = phase0.re[..., None] * tr - phase0.im[..., None] * ti
    pi = phase0.re[..., None] * ti + phase0.im[..., None] * tr
    return pr, pi


def unmix_tail(fir_tail: CF32, phase0: CF32, omega: float) -> torch.Tensor:
    """Mixed-domain carried tail -> the raw real PCM samples it came from:
    raw = Re(mixed * conj(phasor))."""
    ntaps_m1 = fir_tail.shape[-1]
    offs = np.arange(-(ntaps_m1 - 1), 1, dtype=np.float64)
    pr, pi = _tail_phasors(phase0, omega, offs)
    return fir_tail.re * pr + fir_tail.im * pi


def remix_tail(last_raw: torch.Tensor, phase0: CF32, omega: float,
               n: int) -> CF32:
    """The outgoing mixed-domain tail: ``last_raw``, the raw samples that
    end this call of ``n`` samples, re-mixed with their phasors.  (The JAX
    helper takes the whole call and slices; here the caller slices, so the
    kernel path never converts the whole call to float.)"""
    ntaps_m1 = last_raw.shape[-1]
    offs = np.arange(n - ntaps_m1, n, dtype=np.float64) + 1.0
    pr, pi = _tail_phasors(phase0, omega, offs)
    return CF32(last_raw * pr, last_raw * pi)


def advance_phase(phase0: CF32, omega: float, n: int) -> CF32:
    """normalize(phase0 * e^{j*omega*n})."""
    ang = float(np.mod(omega * n, 2.0 * np.pi))
    er, ei = float(np.float32(np.cos(ang))), float(np.float32(np.sin(ang)))
    return cnormalize(CF32(phase0.re * er - phase0.im * ei,
                           phase0.re * ei + phase0.im * er))


@functools.lru_cache(maxsize=None)
def _pick_base_np(omega: float, nframes: int, nsym: int, fsz: int,
                  cycles: int) -> np.ndarray:
    """A[f, i] = e^{j*omega*(f*fsz + i*cycles + 1)}, float64-designed."""
    pos = (np.arange(nframes, dtype=np.float64)[:, None] * fsz
           + np.arange(nsym, dtype=np.float64)[None, :] * cycles + 1.0)
    ang = np.mod(omega * pos, 2.0 * np.pi)
    return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)


def rotate_picks(picks_u: CF32, index: torch.Tensor, phase0: CF32,
                 omega: float, fsz: int, cycles: int) -> CF32:
    """Apply the carrier phasor to mix-free picks (..., nframes, nsym):
    pick (f, i) sits at sample ``f*fsz + i*cycles + index[f]``, so
    y = phase0 (x) e^{j*omega*index} (x) A[f, i] (x) u."""
    nframes, nsym = picks_u.shape[-2:]
    dev = picks_u.re.device
    a = _pick_base_np(omega, nframes, nsym, fsz, cycles)
    ar, ai = _f32(a[0], dev), _f32(a[1], dev)
    pang = np.mod(omega * np.arange(cycles, dtype=np.float64), 2 * np.pi)
    rr = _f32(np.cos(pang), dev)[index.long()]          # (..., nframes)
    ri = _f32(np.sin(pang), dev)[index.long()]
    cr = phase0.re[..., None] * rr - phase0.im[..., None] * ri
    ci = phase0.re[..., None] * ri + phase0.im[..., None] * rr
    fr = cr[..., None] * ar - ci[..., None] * ai
    fi = cr[..., None] * ai + ci[..., None] * ar
    return CF32(picks_u.re * fr - picks_u.im * fi,
                picks_u.re * fi + picks_u.im * fr)
