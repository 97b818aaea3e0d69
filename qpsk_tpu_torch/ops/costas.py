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

``CostasLoop`` is the reference's object-style API over one loop.  The
gear shift (``CostasGear``) runs the loop at the acquisition gains until
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


def costas_init_from_freq(freq0: torch.Tensor, gear: bool) -> CostasState:
    """A warm-started state at per-channel ``freq0`` with zero phase, every
    plane derived from ``freq0``; with ``gear`` the lock detector starts
    unlocked (lev 1, locked 0)."""
    return CostasState(phase=freq0 * 0.0, freq=freq0,
                       lev=freq0 * 0.0 + 1.0 if gear else None,
                       locked=freq0 * 0.0 if gear else None)


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


def costas_run(state: CostasState, symbols: CF32, params: CostasParams,
               detector=phase_detector):
    """Track ``(..., T)`` symbols.  Returns (new_state, derotated)."""
    new_state, derot, _ = costas_run_traced(state, symbols, params, detector)
    return new_state, derot


def costas_run_gear(state: CostasState, symbols: CF32, params: CostasParams,
                    gear: CostasGear):
    """Gear-shift twin of ``costas_run``."""
    new_state, derot, _ = costas_run_gear_traced(state, symbols, params, gear)
    return new_state, derot


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


class CostasLoop:
    """The reference's object-style control-loop API (costas_loop.h:16-43:
    eight setters and eight getters) over one (params, state) pair, for
    code ported from the C modem.  Changing the bandwidth or damping
    re-derives both gains (costas_loop.c:49-54) and drops explicit
    ``set_alpha`` / ``set_beta`` overrides."""

    def __init__(self, loop_bw: float, min_freq: float = -1.0,
                 max_freq: float = 1.0,
                 damping: float = math.sqrt(2.0) / 2.0, batch_shape=(),
                 device="cuda"):
        self._bw = float(loop_bw)
        self._damping = float(damping)
        self._min = float(min_freq)
        self._max = float(max_freq)
        self._alpha = None
        self._beta = None
        self.state = costas_init(batch_shape, device=device)

    def _params(self) -> CostasParams:
        p = costas_params(self._bw, self._damping, self._min, self._max)
        if self._alpha is not None:
            p = p._replace(alpha=_f32(self._alpha))
        if self._beta is not None:
            p = p._replace(beta=_f32(self._beta))
        return p

    def set_loop_bandwidth(self, bw: float):
        self._bw = float(bw)
        self._alpha = self._beta = None

    def set_damping_factor(self, d: float):
        self._damping = float(d)
        self._alpha = self._beta = None

    def set_alpha(self, a: float):
        self._alpha = float(a)

    def set_beta(self, b: float):
        self._beta = float(b)

    def set_frequency(self, f):
        p = self._params()
        freq = torch.full_like(self.state.freq, _f32(f))
        self.state = self.state._replace(
            freq=torch.clamp(freq, p.min_freq, p.max_freq))

    def set_phase(self, ph):
        self.state = self.state._replace(
            phase=_wrap_phase(torch.full_like(self.state.phase, _f32(ph))))

    def set_max_freq(self, f: float):
        self._max = float(f)

    def set_min_freq(self, f: float):
        self._min = float(f)

    def get_loop_bandwidth(self) -> float:
        return self._bw

    def get_damping_factor(self) -> float:
        return self._damping

    def get_alpha(self) -> float:
        return self._params().alpha

    def get_beta(self) -> float:
        return self._params().beta

    def get_frequency(self) -> torch.Tensor:
        return self.state.freq

    def get_phase(self) -> torch.Tensor:
        return self.state.phase

    def get_max_freq(self) -> float:
        return self._max

    def get_min_freq(self) -> float:
        return self._min

    def __call__(self, symbols: CF32) -> CF32:
        """Track a block of ``batch_shape + (T,)`` symbols, advancing the
        owned state: through ``costas_run_cm``, so a CUDA tensor runs the
        Costas kernel and a CPU tensor its plain version."""
        from qpsk_tpu_torch.ops.cuda.costas_kernel import costas_run_cm
        shape, t = self.state.phase.shape, symbols.re.shape[-1]
        state = CostasState(self.state.phase.reshape(-1).contiguous(),
                            self.state.freq.reshape(-1).contiguous())
        state, out, _, _ = costas_run_cm(
            state, CF32(symbols.re.reshape(-1, t), symbols.im.reshape(-1, t)),
            self._params(), t)
        self.state = CostasState(state.phase.reshape(shape),
                                 state.freq.reshape(shape))
        return CF32(out.re.reshape(symbols.re.shape),
                    out.im.reshape(symbols.im.shape))
