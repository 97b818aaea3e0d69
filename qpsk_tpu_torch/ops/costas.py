"""Costas-loop carrier recovery (port of ``qpsk_tpu.ops.costas``, the
single-bandwidth QPSK loop).

Semantics of the reference's GNU Radio loop (costas_loop.c):

* derotate with the phase *before* the update: ``out = z * e^{-j phase}``;
* QPSK sign detector ``err = sign+(Re)*Im - sign+(Im)*Re``;
* ``freq += beta*err; phase = (phase + freq) + alpha*err``, each op rounded
  to float32 in this order;
* wrap the phase to +-TAU by two conditional subtractions each way;
* clamp ``freq`` to [min_freq, max_freq].

The loop gains are float32 values computed on the host exactly as the JAX
package computes them, so the CUDA kernel (``ops/cuda/costas_kernel.py``)
reads the same constants as this plain version.
"""

from __future__ import annotations

import math
from typing import NamedTuple

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


class CostasState(NamedTuple):
    """Per-channel loop state, rad/symbol."""
    phase: torch.Tensor
    freq: torch.Tensor


def costas_params(loop_bw: float, damping: float = math.sqrt(2.0) / 2.0,
                  min_freq: float = -1.0, max_freq: float = 1.0) -> CostasParams:
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    alpha = 4.0 * damping * loop_bw / denom
    beta = 4.0 * loop_bw * loop_bw / denom

    def f32(v):
        return float(np.float32(v))
    return CostasParams(alpha=f32(alpha), beta=f32(beta),
                        max_freq=f32(max_freq), min_freq=f32(min_freq))


def costas_init(batch_shape=(), phase=0.0, freq=0.0,
                device=None) -> CostasState:
    """Cold start (phase 0, freq 0), or a warm start at ``freq``."""
    def full(v):
        return torch.full(tuple(batch_shape), float(v), dtype=torch.float32,
                          device=device)
    return CostasState(phase=full(phase), freq=full(freq))


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


def costas_step(state: CostasState, z: CF32, params: CostasParams):
    """One symbol tick: derotate, detect, advance."""
    out = cmul(z, cexp_conj(state.phase))
    err = phase_detector(out)
    freq = state.freq + params.beta * err
    phase = (state.phase + freq) + params.alpha * err
    phase = _wrap_phase(phase)
    freq = torch.clamp(freq, params.min_freq, params.max_freq)
    return CostasState(phase=phase, freq=freq), out


def costas_run_traced(state: CostasState, symbols: CF32,
                      params: CostasParams):
    """Track ``(..., T)`` symbols.  Returns (new_state, derotated
    ``(..., T)``, post-update frequency trace ``(..., T)``)."""
    outs_r, outs_i, freqs = [], [], []
    for t in range(symbols.shape[-1]):
        state, out = costas_step(
            state, CF32(symbols.re[..., t], symbols.im[..., t]), params)
        outs_r.append(out.re)
        outs_i.append(out.im)
        freqs.append(state.freq)
    return (state, CF32(torch.stack(outs_r, -1), torch.stack(outs_i, -1)),
            torch.stack(freqs, -1))


def freq_to_hz(freq_rad_per_symbol: torch.Tensor, rs: float) -> torch.Tensor:
    """Detected offset in Hz at the symbol rate."""
    return freq_rad_per_symbol * float(np.float32(rs / TAU))
