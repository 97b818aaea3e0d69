"""Costas-loop kernel wrapper (port of the time-major entry of
``qpsk_tpu/ops/pallas/costas_kernel.py``, ``costas_run_pallas_tm`` with the
QPSK detector, ``emit_bits`` and ``trace_every``).

``costas_run_tm`` consumes the (T, C) planes the front-end emits.  On a
CUDA tensor it launches ``csrc/costas.cu``, which also slices the derotated
symbols and packs 16 dibits per int32 word; on a CPU tensor it runs
``costas_run_tm_plain``: the ``costas_run_traced`` loop, ``demod_bits`` and
the frame-boundary frequency readback.
"""

from __future__ import annotations

import torch

from qpsk_tpu_torch.ops.costas import (CostasParams, CostasState,
                                       costas_run_traced)
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.cuda import _lib
from qpsk_tpu_torch.ops.modmap import demod_bits

# Kernel launches since the last reset (set to 0 to start a count).
launches = 0


def costas_run_tm(state: CostasState, zr_tm: torch.Tensor,
                  zi_tm: torch.Tensor, params: CostasParams,
                  trace_every: int):
    """Run the loop over (T, C) symbol planes.

    Returns ``(new_state, derot CF32 (T, C), freq_frames (C, T //
    trace_every), bits (C, 2T) int32)``: ``freq_frames[:, k]`` is the loop
    frequency after symbol ``(k+1)*trace_every - 1`` and ``bits`` is
    ``modmap.demod_bits`` of the derotated (C, T) symbols.
    """
    if zr_tm.is_cuda:
        return _launch(state, zr_tm, zi_tm, params, trace_every)
    return costas_run_tm_plain(state, zr_tm, zi_tm, params, trace_every)


def costas_run_tm_plain(state, zr_tm, zi_tm, params, trace_every):
    """The plain PyTorch version of ``costas_run_tm``."""
    new_state, derot, trace = costas_run_traced(
        state, CF32(zr_tm.T, zi_tm.T), params)
    return (new_state, CF32(derot.re.T.contiguous(), derot.im.T.contiguous()),
            trace[:, trace_every - 1::trace_every], demod_bits(derot))


def unpack_bits_tm(packed: torch.Tensor) -> torch.Tensor:
    """(T/16, C) int32 words -> (C, 2T) bits, the layout of
    ``modmap.demod_bits`` on the (C, T) derotated symbols: symbol ``t`` sits
    at bits ``2*(t%16)`` (b1, the low bit) and ``2*(t%16)+1`` (b0) of word
    ``t // 16``.  The shifts are arithmetic, so every shift is masked."""
    w = packed[:, None, :]                                  # (T/16, 1, C)
    j = torch.arange(16, dtype=torch.int32, device=packed.device)[None, :, None]
    bits = torch.stack([(w >> (2 * j)) & 1, (w >> (2 * j + 1)) & 1], dim=2)
    return bits.reshape(-1, packed.shape[1]).T              # (C, 2T)


def _launch(state, zr_tm, zi_tm, params, trace_every):
    global launches
    t, c = zr_tm.shape
    if t < 1 or c < 1 or t % 16 or trace_every < 1 or t % trace_every:
        raise ValueError(
            f"the Costas kernel takes T > 0 with T % 16 == 0 and T % "
            f"trace_every == 0, got T={t}, trace_every={trace_every}")
    dev = zr_tm.device
    _lib.require(zr_tm, "zr_tm", torch.float32, (t, c), dev)
    _lib.require(zi_tm, "zi_tm", torch.float32, (t, c), dev)
    _lib.require(state.phase, "state.phase", torch.float32, (c,), dev)
    _lib.require(state.freq, "state.freq", torch.float32, (c,), dev)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    outr, outi = empty((t, c)), empty((t, c))
    ftrace = empty((t // trace_every, c))
    phase, freq = empty((c,)), empty((c,))
    packed = empty((t // 16, c), torch.int32)
    rc = _lib.library().qpsk_costas_tm(
        zr_tm.data_ptr(), zi_tm.data_ptr(), state.phase.data_ptr(),
        state.freq.data_ptr(), outr.data_ptr(), outi.data_ptr(),
        ftrace.data_ptr(), phase.data_ptr(), freq.data_ptr(),
        packed.data_ptr(), t, c, trace_every, params.alpha, params.beta,
        params.min_freq, params.max_freq, _lib.stream_ptr(dev))
    _lib.check(rc, "qpsk_costas_tm")
    launches += 1
    return (CostasState(phase=phase, freq=freq), CF32(outr, outi), ftrace.T,
            unpack_bits_tm(packed))
