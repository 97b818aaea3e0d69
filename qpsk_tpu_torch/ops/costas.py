"""Costas-loop carrier recovery (port of ``qpsk_tpu.ops.costas``: the QPSK
loop, its gear-shift extension and the swappable phase detector).

Semantics of the reference's GNU Radio loop (costas_loop.c):

* derotate with the phase *before* the update: ``out = z * e^{-j phase}``;
* QPSK sign detector ``err = sign+(Re)*Im - sign+(Im)*Re``, or the
  generic family's decision-directed error (``modfam.dd_detector``);
* ``freq += beta*err; phase = (phase + freq) + alpha*err``, each op rounded
  to float32 in this order;
* wrap the phase to +-TAU by two conditional subtractions each way;
* clamp ``freq`` to [min_freq, max_freq].

The gear shift (``CostasGear``) runs the loop at the acquisition gains until
a lock detector, a leaky average ``lev`` of the normalized error
``|err| / ((|Re| + |Im|) + 1e-9)``, falls below ``enter``, then at the
tracking gains until ``lev`` rises past ``exit``.

The loop gains are float32 values computed on the host exactly as the JAX
package computes them, so the CUDA kernel (``ops/cuda/costas_kernel.py``)
reads the same constants as this plain version.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from qpsk_tpu_torch.ops.cplx import CF32, cexp_conj, cmul

TAU = 2.0 * math.pi
TAU32 = float(np.float32(TAU))


class CostasParams(NamedTuple):
    """Loop gains and clamp bounds, each a float32-representable float."""
    alpha: float
    beta: float
    max_freq: float
    min_freq: float


class CostasGear(NamedTuple):
    """Tracking gains and lock-detector constants of the gear shift, each a
    float32-representable float."""
    alpha_trk: float
    beta_trk: float
    gamma: float      # lock-level smoothing, a power of two (exact product)
    enter: float      # shift to the tracking gains when lev < enter
    exit: float       # shift back when lev > exit


class CostasState(NamedTuple):
    """Per-channel loop state, rad/symbol; ``lev`` / ``locked`` carry the
    gear-shift lock detector (None for the single-bandwidth loop)."""
    phase: torch.Tensor
    freq: torch.Tensor
    lev: Optional[torch.Tensor] = None
    locked: Optional[torch.Tensor] = None


def _f32(v) -> float:
    return float(np.float32(v))


def costas_params(loop_bw: float, damping: float = math.sqrt(2.0) / 2.0,
                  min_freq: float = -1.0, max_freq: float = 1.0) -> CostasParams:
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    alpha = 4.0 * damping * loop_bw / denom
    beta = 4.0 * loop_bw * loop_bw / denom
    return CostasParams(alpha=_f32(alpha), beta=_f32(beta),
                        max_freq=_f32(max_freq), min_freq=_f32(min_freq))


def costas_gear(loop_bw_trk: float, damping: float = math.sqrt(2.0) / 2.0,
                gamma: float = 1.0 / 64.0, enter: float = 0.32,
                exit: float = 0.40) -> CostasGear:
    """Tracking gains (the schedule of ``costas_params``) and the lock
    detector's constants.  ``gamma`` stays a power of two, so
    ``gamma * (errn - lev)`` is exact and the kernel and plain loops round
    the lock level alike."""
    denom = 1.0 + 2.0 * damping * loop_bw_trk + loop_bw_trk * loop_bw_trk
    return CostasGear(alpha_trk=_f32(4.0 * damping * loop_bw_trk / denom),
                      beta_trk=_f32(4.0 * loop_bw_trk * loop_bw_trk / denom),
                      gamma=_f32(gamma), enter=_f32(enter), exit=_f32(exit))


def gear_for(loop_bw_track: float, damping: float = math.sqrt(2.0) / 2.0):
    """The ``CostasGear`` of a config's (loop_bw_track, damping), or None
    when the gear shift is off."""
    if loop_bw_track <= 0:
        return None
    return costas_gear(loop_bw_track, damping)


def costas_init(batch_shape=(), phase=0.0, freq=0.0, gear: bool = False,
                device="cuda") -> CostasState:
    """Cold start (phase 0, freq 0), or a warm start at ``freq`` (a float,
    or a tensor that broadcasts to ``batch_shape``, such as one
    acquisition estimate per channel); with ``gear`` the lock detector
    starts unlocked (lev 1, locked 0)."""
    def full(v):
        if torch.is_tensor(v):
            return v.to(device=device, dtype=torch.float32).expand(
                tuple(batch_shape)).contiguous()
        return torch.full(tuple(batch_shape), float(v), dtype=torch.float32,
                          device=device)
    return CostasState(phase=full(phase), freq=full(freq),
                       lev=full(1.0) if gear else None,
                       locked=full(0.0) if gear else None)


def phase_detector(z: CF32) -> torch.Tensor:
    """QPSK decision-directed error (costas_loop.c:44-47)."""
    sr = torch.where(z.re > 0.0, 1.0, -1.0)
    si = torch.where(z.im > 0.0, 1.0, -1.0)
    return sr * z.im - si * z.re


def _wrap_phase(phase: torch.Tensor) -> torch.Tensor:
    for _ in range(2):
        phase = torch.where(phase > TAU32, phase - TAU32, phase)
    for _ in range(2):
        phase = torch.where(phase < -TAU32, phase + TAU32, phase)
    return phase


def costas_step(state: CostasState, z: CF32, params: CostasParams,
                detector=phase_detector):
    """One symbol tick: derotate, detect (``detector``, the QPSK sign
    detector by default), advance."""
    out = cmul(z, cexp_conj(state.phase))
    err = detector(out)
    freq = state.freq + params.beta * err
    phase = (state.phase + freq) + params.alpha * err
    phase = _wrap_phase(phase)
    freq = torch.clamp(freq, params.min_freq, params.max_freq)
    return CostasState(phase=phase, freq=freq), out


def costas_step_gear(state: CostasState, z: CF32, params: CostasParams,
                     gear: CostasGear):
    """One symbol tick of the gear-shift loop: the lock level and gear are
    updated from this symbol's normalized error before the loop advance,
    which then uses the selected gains."""
    out = cmul(z, cexp_conj(state.phase))
    err = phase_detector(out)
    errn = torch.abs(err) / ((torch.abs(out.re) + torch.abs(out.im)) + 1e-9)
    lev = state.lev + gear.gamma * (errn - state.lev)
    locked = torch.where(lev < gear.enter, 1.0,
                         torch.where(lev > gear.exit, 0.0, state.locked))
    trk = locked > 0.5
    alpha = torch.where(trk, gear.alpha_trk, params.alpha)
    beta = torch.where(trk, gear.beta_trk, params.beta)
    freq = state.freq + beta * err
    phase = (state.phase + freq) + alpha * err
    phase = _wrap_phase(phase)
    freq = torch.clamp(freq, params.min_freq, params.max_freq)
    return CostasState(phase=phase, freq=freq, lev=lev, locked=locked), out


def costas_run_traced(state: CostasState, symbols: CF32,
                      params: CostasParams, detector=phase_detector):
    """Track ``(..., T)`` symbols with ``detector``.  Returns (new_state,
    derotated ``(..., T)``, post-update frequency trace ``(..., T)``)."""
    return _run(lambda st, z: costas_step(st, z, params, detector), state,
                symbols)


def costas_run_gear_traced(state: CostasState, symbols: CF32,
                           params: CostasParams, gear: CostasGear):
    """Gear-shift twin of ``costas_run_traced``; ``state`` carries
    ``lev`` and ``locked`` (``costas_init(..., gear=True)``)."""
    return _run(lambda st, z: costas_step_gear(st, z, params, gear), state,
                symbols)


def _run(step, state: CostasState, symbols: CF32):
    outs_r, outs_i, freqs = [], [], []
    for t in range(symbols.shape[-1]):
        state, out = step(state, CF32(symbols.re[..., t], symbols.im[..., t]))
        outs_r.append(out.re)
        outs_i.append(out.im)
        freqs.append(state.freq)
    return (state, CF32(torch.stack(outs_r, -1), torch.stack(outs_i, -1)),
            torch.stack(freqs, -1))


def freq_to_hz(freq_rad_per_symbol: torch.Tensor, rs: float) -> torch.Tensor:
    """Detected offset in Hz at the symbol rate."""
    return freq_rad_per_symbol * float(np.float32(rs / TAU))
